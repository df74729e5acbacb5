"""Kernel dispatch — the analogue of the reference's flag dispatch in main
(ellspmv.c:1834-1843, csrspmv.c:2851-2868), keyed on the matrix format.

Each format has exactly one SpMV implementation, compiled by XLA for the
backend JAX runs on. Every matrix container is a JAX pytree, so
``spmv(matrix, x, y)`` can also be traced inside an outer jit with the
matrix passed as a jit ARGUMENT (closing over a large matrix would embed
its arrays as constants in the compiled program); benchmark loops and
solvers do that.
"""

from __future__ import annotations

from ellspmv_jax.formats.csr import CsrMatrix
from ellspmv_jax.formats.dia import DiaMatrix, dia_spmv
from ellspmv_jax.formats.ell import EllMatrix
from ellspmv_jax.formats.hybrid import HybridMatrix, hybrid_spmv
from ellspmv_jax.formats.sell import SellMatrix, sell_spmv
from ellspmv_jax.ops.csr_xla import csr_spmv_xla
from ellspmv_jax.ops.ell_xla import ell_spmv_xla

_KERNELS = (
    (DiaMatrix, dia_spmv),
    (SellMatrix, sell_spmv),
    (HybridMatrix, hybrid_spmv),
    (EllMatrix, ell_spmv_xla),
    (CsrMatrix, csr_spmv_xla),
)


def spmv(matrix, x, y=None):
    """y := A*x + y."""
    for cls, kernel in _KERNELS:
        if isinstance(matrix, cls):
            return kernel(matrix, x, y)
    raise TypeError(f"unsupported matrix type {type(matrix)}")
