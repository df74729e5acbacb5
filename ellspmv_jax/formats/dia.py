"""DIA (diagonal) format — a format the reference doesn't have.

For stencil/banded matrices whose nonzeros lie on a handful of constant
diagonals (the Poisson benchmark config, BASELINE configs[1]), SpMV needs
no gathers at all: ``y[i] += d_k[i] * x[i + off_k]`` is a shifted
element-wise product, which XLA compiles to pure streaming loads — the
speed-of-light formulation on a bandwidth-bound machine. This replaces the
reference's reliance on hardware prefetchers for banded access patterns
(A64FX prefetch-distance MSRs, csrspmv.c:185-287) with a formulation that
has no irregular access in the first place.

``dia_from_coo`` returns None when the matrix is not diagonal-sparse
(more than `max_diags` distinct offsets), in which case callers use
ELL/CSR.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ellspmv_jax.config import accumulation_dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DiaMatrix:
    """Diagonal storage: data[k, i] multiplies x[i + offsets[k]] into y[i].

    data is (num_diags, num_rows); out-of-range positions hold 0.
    """

    data: jax.Array | np.ndarray
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_columns: int = dataclasses.field(metadata=dict(static=True))
    num_nonzeros: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_diags(self) -> int:
        return len(self.offsets)

    @property
    def diasize(self) -> int:
        """Stored values (the flop/byte unit for DIA)."""
        return self.num_diags * self.num_rows

    def device_put(self, value_dtype=None) -> "DiaMatrix":
        cast = (lambda v: jnp.asarray(v, value_dtype)) if value_dtype \
            else jnp.asarray
        return DiaMatrix(cast(self.data), self.offsets, self.num_rows,
                         self.num_columns, self.num_nonzeros)


def dia_from_coo(coo, max_diags: int = 32, value_dtype=None
                 ) -> Optional[DiaMatrix]:
    """Convert to DIA if the matrix has at most `max_diags` distinct
    diagonals; duplicates accumulate. Returns None otherwise."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    off = coo.colidx.astype(np.int64) - coo.rowidx.astype(np.int64)
    offsets = np.unique(off)
    if len(offsets) > max_diags:
        return None
    val_dt = np.dtype(value_dtype) if value_dtype else coo.values.dtype
    data = np.zeros((len(offsets), n), val_dt)
    k = np.searchsorted(offsets, off)
    np.add.at(data, (k, coo.rowidx.astype(np.int64)), coo.values)
    return DiaMatrix(data=data, offsets=tuple(int(o) for o in offsets),
                     num_rows=n, num_columns=m,
                     num_nonzeros=coo.num_nonzeros)


@partial(jax.jit, static_argnames=("offsets", "num_rows", "num_columns"))
def _dia_spmv(data, x, y, offsets, num_rows, num_columns):
    acc_dt = accumulation_dtype(data.dtype)
    acc = jnp.zeros(num_rows, acc_dt) if y is None else y.astype(acc_dt)
    xv = x.astype(acc_dt)
    for k, off in enumerate(offsets):
        # y[i] += data[k, i] * x[i + off] for i in valid range: realize as a
        # zero-padded shift of x so every step is a full-length stream
        # (elementwise, so XLA fuses all diagonals into one pass).
        if off >= 0:
            xs = xv[off:min(num_columns, num_rows + off)]
            xs = jnp.pad(xs, (0, num_rows - xs.shape[0]))
        else:
            lo = -off
            seg = xv[:max(0, min(num_columns, num_rows + off))]
            xs = jnp.pad(seg, (lo, num_rows - lo - seg.shape[0]))
        acc = acc + data[k].astype(acc_dt) * xs
    return acc.astype(data.dtype)


def dia_spmv(dia: DiaMatrix, x, y=None):
    """y := A*x + y (gather-free, streaming)."""
    return _dia_spmv(jnp.asarray(dia.data), jnp.asarray(x),
                     None if y is None else jnp.asarray(y),
                     dia.offsets, dia.num_rows, dia.num_columns)
