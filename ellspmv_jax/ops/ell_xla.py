"""ELLPACK SpMV in XLA: gather + multiply + row reduction.

ellgemv/ellgemvsd/ellgemv16sd semantics (ellspmv.c:1129-1221). XLA fuses
the x gather, the products and the row sum into one kernel that reads
`colidx`/`values` once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ellspmv_jax.config import accumulation_dtype


@partial(jax.jit, static_argnames=("num_rows", "num_columns"))
def _ell_spmv(colidx, values, diag, x, y, num_rows: int, num_columns: int):
    n_pad = values.shape[0]
    acc_dt = accumulation_dtype(values.dtype)
    xv = x.astype(acc_dt)
    acc = jnp.zeros(n_pad, acc_dt) if y is None \
        else jnp.pad(y.astype(acc_dt), (0, n_pad - y.shape[0]))
    if values.shape[1]:
        acc = acc + (values.astype(acc_dt) * xv[colidx]).sum(axis=1)
    if diag is not None:
        # diag[i] is zero for i >= min(rows, cols); clamp the x index so the
        # padded tail gathers in bounds (ellgemvsd's y[i] += ad[i]*x[i],
        # ellspmv.c:1177).
        xi = jnp.minimum(jnp.arange(n_pad), max(num_columns - 1, 0))
        acc = acc + diag.astype(acc_dt) * xv[xi]
    return acc.astype(values.dtype)


def ell_spmv_xla(ell, x, y=None):
    """y := A*x + y for an EllMatrix; returns a vector of length
    `ell.num_rows` (padding rows dropped)."""
    x = jnp.asarray(x)
    out = _ell_spmv(jnp.asarray(ell.colidx), jnp.asarray(ell.values),
                    None if ell.diag is None else jnp.asarray(ell.diag),
                    x, None if y is None else jnp.asarray(y),
                    ell.num_rows, ell.num_columns)
    return out[:ell.num_rows]
