"""SpMV kernels. All kernels compute ``y := A*x + y`` (the reference's
contract, ellspmv.c:235 — uniformly, including paths where the reference
itself deviates: csrgemvnz zeroes y, csrspmv.c:1709, and the SVE csrgemv
assigns, csrspmv.c:1560; SURVEY §7 'faithful-but-not-buggy')."""

from ellspmv_jax.ops.dispatch import spmv

__all__ = ["spmv"]
