"""CSR format: rowptr / colidx / values (+ optional split diagonal).

Replicates csr_from_coo_size + csr_from_coo (csrspmv.c:1219-1267, 1390-1475):

- symmetric matrices are expanded: every off-diagonal stored entry counts
  twice, as (i,j) and (j,i) (csrspmv.c:1240-1248);
- ``separate_diagonal`` extracts a dense diagonal of length num_rows for
  square matrices (csrspmv.c:1265), accumulating duplicates;
- ``sort_rows`` orders each row's entries by column.

The kernels read an additional precomputed ``rowids`` array (the COO-style
row index of every stored entry) because the CSR kernel is a segment
reduction over static shapes, not a per-row pointer loop
(csrspmv.c:1588-1593).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ellspmv_jax.config import select_index_dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CsrMatrix:
    rowptr: jax.Array | np.ndarray    # (num_rows+1,)
    colidx: jax.Array | np.ndarray    # (csrsize,)
    values: jax.Array | np.ndarray    # (csrsize,)
    rowids: jax.Array | np.ndarray    # (csrsize,) row index per entry
    diag: Optional[jax.Array | np.ndarray]   # (num_rows,) or None
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_columns: int = dataclasses.field(metadata=dict(static=True))
    num_nonzeros: int = dataclasses.field(metadata=dict(static=True))

    @property
    def csrsize(self) -> int:
        """Stored entries after symmetric expansion / diagonal split — the
        reference's flop unit (csrspmv.c:1264, 2882)."""
        return int(self.values.shape[0])

    @property
    def diagsize(self) -> int:
        """num_rows when the diagonal is split on a square matrix, else 0
        (csrspmv.c:1265)."""
        return 0 if self.diag is None else int(self.diag.shape[0])

    @property
    def rowsize_min(self) -> int:
        c = np.diff(np.asarray(self.rowptr))
        return int(c.min()) if c.size else 0

    @property
    def rowsize_max(self) -> int:
        c = np.diff(np.asarray(self.rowptr))
        return int(c.max()) if c.size else 0

    def device_put(self, value_dtype=None) -> "CsrMatrix":
        import jax.numpy as jnp
        cast = (lambda v: jnp.asarray(v, value_dtype)) if value_dtype \
            else jnp.asarray
        return CsrMatrix(jnp.asarray(self.rowptr), jnp.asarray(self.colidx),
                         cast(self.values), jnp.asarray(self.rowids),
                         None if self.diag is None else cast(self.diag),
                         self.num_rows, self.num_columns, self.num_nonzeros)


def csr_from_coo(coo, separate_diagonal: bool = False,
                 sort_rows: bool = False, value_dtype=None,
                 index_dtype=None) -> CsrMatrix:
    """Convert a CooMatrix to CSR (symmetric expansion included)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros

    diag = None
    if separate_diagonal and n == m:
        coo, diag = coo.split_diagonal()
        if len(diag) != n:  # square only ever hits this with n == m
            d = np.zeros(n, diag.dtype)
            d[:len(diag)] = diag
            diag = d

    idx_dt = select_index_dtype(n, m, max(nnz_total, 1), index_dtype)
    val_dt = np.dtype(value_dtype) if value_dtype else coo.values.dtype

    if sort_rows:
        order = np.lexsort((coo.colidx, coo.rowidx))
    else:
        order = np.argsort(coo.rowidx, kind="stable")
    rowids = coo.rowidx[order].astype(idx_dt)
    colidx = coo.colidx[order].astype(idx_dt)
    values = coo.values[order].astype(val_dt)

    counts = np.bincount(rowids, minlength=n)
    rowptr = np.zeros(n + 1, dtype=idx_dt)
    rowptr[1:] = np.cumsum(counts)

    if diag is not None:
        diag = diag.astype(val_dt)

    return CsrMatrix(rowptr=rowptr, colidx=colidx, values=values,
                     rowids=rowids, diag=diag, num_rows=n, num_columns=m,
                     num_nonzeros=nnz_total)
