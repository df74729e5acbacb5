"""CSR SpMV in XLA as a segment reduction.

The reference's CSR kernels walk rowptr per row (csrgemv,
csrspmv.c:1588-1593). Here the formulation is a flat product over stored
entries followed by a fixed-shape segment-sum over the precomputed row ids
— the structure of the nonzero-balanced kernel csrgemvnz
(csrspmv.c:1681-1761), with XLA's scatter-add in place of its atomics
(SURVEY §2.4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ellspmv_jax.config import accumulation_dtype


@partial(jax.jit, static_argnames=("num_rows", "num_columns"))
def _csr_spmv(colidx, values, rowids, diag, x, y,
              num_rows: int, num_columns: int):
    acc_dt = accumulation_dtype(values.dtype)
    xv = x.astype(acc_dt)
    acc = jnp.zeros(num_rows, acc_dt) if y is None else y.astype(acc_dt)
    if values.shape[0]:
        prod = values.astype(acc_dt) * xv[colidx]
        acc = acc + jax.ops.segment_sum(prod, rowids, num_segments=num_rows)
    if diag is not None:
        k = min(num_rows, num_columns)
        acc = acc.at[:k].add(diag[:k].astype(acc_dt) * xv[:k])
    return acc.astype(values.dtype)


def csr_spmv_xla(csr, x, y=None):
    """y := A*x + y for a CsrMatrix."""
    return _csr_spmv(jnp.asarray(csr.colidx), jnp.asarray(csr.values),
                     jnp.asarray(csr.rowids),
                     None if csr.diag is None else jnp.asarray(csr.diag),
                     jnp.asarray(x), None if y is None else jnp.asarray(y),
                     csr.num_rows, csr.num_columns)
