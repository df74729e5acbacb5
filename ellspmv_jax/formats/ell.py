"""ELLPACK format: dense (rows × max-nnz-per-row) column-index/value arrays.

Replicates ell_from_coo_size + ell_from_coo (ellspmv.c:931-958, 1081-1127)
with the *intended* semantics, not the reference's swapped-argument call-site
bug (ellspmv.c:1468-1471 passes sort_rows where separate_diagonal is
expected — SURVEY §2.1 E12):

- ``rowsize`` = max nonzeros per row (excluding the diagonal when split);
- padding slots get column ``min(i, num_columns-1)`` and value 0.0
  (ellspmv.c:1111-1117) so padded gathers stay in bounds;
- the split diagonal accumulates duplicates (ellspmv.c:1100) and has length
  min(rows, cols) (ellspmv.c:956);
- ``sort_rows`` orders each row's entries by column (rowsort,
  ellspmv.c:960-1079 — realized here as one vectorized lexsort; the
  reference's hybrid insertion/merge sort is a CPU artifact).

Divergences:

- symmetric files are expanded (the reference's ellspmv silently treats them
  as triangles; csrspmv expands — we follow csrspmv, flagged in the header);
- rows are padded to a multiple of ``row_tile`` (default 8) so kernels
  never see ragged tiles;
- the container is a JAX pytree, so it jits/shards directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import numpy as np

from ellspmv_jax.config import select_index_dtype


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllMatrix:
    """ELLPACK matrix. `colidx`/`values` are (padded_rows, rowsize); `diag`
    is (padded_rows,) when the diagonal is split, else None."""

    colidx: jax.Array | np.ndarray
    values: jax.Array | np.ndarray
    diag: Optional[jax.Array | np.ndarray]
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_columns: int = dataclasses.field(metadata=dict(static=True))
    num_nonzeros: int = dataclasses.field(metadata=dict(static=True))

    @property
    def rowsize(self) -> int:
        return int(self.values.shape[1])

    @property
    def padded_rows(self) -> int:
        return int(self.values.shape[0])

    @property
    def ellsize(self) -> int:
        """num_rows*rowsize — the reference's flop/byte accounting unit
        (ellspmv.c:955, 1857)."""
        return self.num_rows * self.rowsize

    @property
    def diagsize(self) -> int:
        """min(rows, cols), counted unconditionally in the reference's flops
        formula (ellspmv.c:956, 1857)."""
        return min(self.num_rows, self.num_columns)

    def device_put(self, value_dtype=None) -> "EllMatrix":
        import jax.numpy as jnp
        cast = (lambda v: jnp.asarray(v, value_dtype)) if value_dtype \
            else jnp.asarray
        return EllMatrix(jnp.asarray(self.colidx), cast(self.values),
                         None if self.diag is None else cast(self.diag),
                         self.num_rows, self.num_columns, self.num_nonzeros)


def ell_from_coo(coo, separate_diagonal: bool = False,
                 sort_rows: bool = False, row_tile: int = 8,
                 value_dtype=None, index_dtype=None,
                 rowsize: int | None = None) -> EllMatrix:
    """Convert a CooMatrix to ELLPACK.

    `rowsize` may be forced larger than the max row occupancy (used by the
    fixed-width kernel specializations, the gemv16 analogue ellspmv.c:1182).
    """
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros

    diag = None
    if separate_diagonal:
        coo, diag = coo.split_diagonal()

    counts = np.bincount(coo.rowidx, minlength=n) if n else np.zeros(0, int)
    natural_rowsize = int(counts.max()) if n and counts.size else 0
    if rowsize is None:
        rowsize = natural_rowsize
    elif rowsize < natural_rowsize:
        raise ValueError(f"requested rowsize {rowsize} < max row occupancy "
                         f"{natural_rowsize}")

    idx_dt = select_index_dtype(n, m, max(nnz_total, 1), index_dtype)
    val_dt = np.dtype(value_dtype) if value_dtype else coo.values.dtype

    n_pad = max(_round_up(n, row_tile), row_tile)

    def _alloc_padded():
        # Padding column = min(i, num_cols-1): in-bounds, value 0
        # (ellspmv.c:1111). Allocated lazily: when the native packer
        # takes the conversion these 1.8 GB (at the 114M-nnz reference
        # scale) of fills were thrown away (measured ~2 s of the 13.5 s
        # conversion, r5).
        pad_col = np.minimum(np.arange(n_pad, dtype=idx_dt),
                             max(m - 1, 0)).astype(idx_dt)
        ci = np.broadcast_to(pad_col[:, None], (n_pad, rowsize)).copy() \
            if rowsize else np.zeros((n_pad, 0), idx_dt)
        return ci, np.zeros((n_pad, rowsize), val_dt)

    colidx = values = None
    if coo.num_nonzeros and rowsize:
        packed = False
        if (idx_dt == np.dtype(np.int32)
                and not os.environ.get("ELLSPMV_NO_NATIVE")):
            # Native counting-sort packer (~10x the NumPy path on big
            # matrices; the reference converts in parallel C,
            # ellspmv.c:1081-1127).
            from ellspmv_jax.io import native
            if native.available():
                try:
                    pc, pv = native.ell_pack(n, m, n_pad, rowsize,
                                             coo.rowidx, coo.colidx,
                                             coo.values, sort_rows)
                    colidx = pc
                    values = pv.astype(val_dt, copy=False)
                    packed = True
                except native.NativeUnsupported:
                    pass
        if not packed:
            colidx, values = _alloc_padded()
            # Scatter pass. Order by (row [, col]) — one lexsort subsumes
            # both the reference's per-row fill cursor (ellspmv.c:1097-1107)
            # and rowsort.
            if sort_rows:
                order = np.lexsort((coo.colidx, coo.rowidx))
            else:
                order = np.argsort(coo.rowidx, kind="stable")
            r = coo.rowidx[order]
            rowptr = np.zeros(n + 1, dtype=np.int64)
            rowptr[1:] = np.cumsum(counts)
            slot = np.arange(len(r), dtype=np.int64) - rowptr[r]
            colidx[r, slot] = coo.colidx[order].astype(idx_dt)
            # Duplicate (row, col) entries occupy separate slots, as in the
            # reference (each COO triplet gets its own ELL slot).
            values[r, slot] = coo.values[order].astype(val_dt)
    if colidx is None:
        colidx, values = _alloc_padded()

    if diag is not None:
        d = np.zeros(n_pad, val_dt)
        d[:len(diag)] = diag.astype(val_dt)
        diag = d

    return EllMatrix(colidx=colidx, values=values, diag=diag,
                     num_rows=n, num_columns=m, num_nonzeros=nnz_total)
