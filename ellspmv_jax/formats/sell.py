"""Sliced-ELL + CSR-tail hybrid — for skewed (power-law) matrices.

Plain ELLPACK pads every row to the global max row length
(ellsize = num_rows * max_row_nnz, ellspmv.c:955), which explodes on
power-law matrices (BASELINE configs[3]). The sliced hybrid:

- rows are processed in slices of ``slice_rows``;
- each slice stores only its own max row length, and slices are bucketed by
  that length (rounded to the next power of two) into a handful of
  EllMatrix instances — one ELL kernel per bucket instead of one global
  padded monolith;
- entries beyond ``tail_cap`` per row (the ultra-long hub rows) split into
  a CSR tail evaluated as a segment reduction;
- y is reassembled by a slice-granular (not element-granular) gather.

This format is new relative to the reference (SURVEY §7 'ELL padding
blowup' risk); its SpMV semantics are still ``y := A*x + y``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ellspmv_jax.formats.coo import CooMatrix
from ellspmv_jax.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_jax.formats.ell import ell_from_coo


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


_STATIC = dict(static=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SellMatrix:
    buckets: list           # list[EllMatrix], one per rowsize bucket
    order: np.ndarray       # (T,) int: original tile t lives at concat pos
    slice_rows: int = dataclasses.field(metadata=_STATIC)
    tail: Optional[CsrMatrix] = None
    num_rows: int = dataclasses.field(default=0, metadata=_STATIC)
    num_columns: int = dataclasses.field(default=0, metadata=_STATIC)
    num_nonzeros: int = dataclasses.field(default=0, metadata=_STATIC)
    # SELL-sigma: rows sorted by length before slicing so each slice is
    # uniform (row_unperm maps sorted y back to natural order); None when
    # length sorting is off.
    row_unperm: Optional[np.ndarray] = None
    # Long-row splitting: rows with > split_len entries are stored as
    # multiple sub-rows (ids n.. for the extra chunks); y is re-aggregated
    # with a small segment-sum over the extras. None when nothing split.
    extra_rows: Optional[np.ndarray] = None   # (E,) original row per extra
    num_sub_rows: Optional[int] = dataclasses.field(   # n + E
        default=None, metadata=_STATIC)

    @property
    def sellsize(self) -> int:
        """Stored slots across buckets (the ELL-padding-free work size)."""
        return sum(b.ellsize for b in self.buckets)

    @property
    def trivial_reassembly(self) -> bool:
        """True when y needs no reassembly at all: one bucket (whose tiles
        are then in natural order), no tail/length-sort/row-splitting —
        sell_spmv then skips the gather and concat passes entirely."""
        return (len(self.buckets) == 1 and self.tail is None
                and self.row_unperm is None and self.extra_rows is None)

    @property
    def tailsize(self) -> int:
        return 0 if self.tail is None else self.tail.csrsize

    @property
    def values(self):
        # dtype carrier for the bench harness
        return self.buckets[0].values if self.buckets else self.tail.values

    def device_put(self, value_dtype=None) -> "SellMatrix":
        import jax.numpy as jnp
        return SellMatrix(
            [b.device_put(value_dtype) for b in self.buckets],
            jnp.asarray(np.asarray(self.order)), self.slice_rows,
            None if self.tail is None else self.tail.device_put(value_dtype),
            self.num_rows, self.num_columns, self.num_nonzeros,
            None if self.row_unperm is None
            else jnp.asarray(np.asarray(self.row_unperm)),
            None if self.extra_rows is None
            else jnp.asarray(np.asarray(self.extra_rows)),
            self.num_sub_rows)


def sell_from_coo(coo: CooMatrix, slice_rows: int = 1024,
                  tail_cap: int = 64, sort_rows: bool = True,
                  length_sort: bool = False,
                  split_rows: bool = True, split_len: int = 128,
                  split_cols: int = 8192,
                  value_dtype=None, index_dtype=None) -> SellMatrix:
    """Convert COO to the bucketed sliced-ELL + CSR-tail hybrid.

    `length_sort=True` is SELL-sigma: rows are permuted by descending
    nonzero count before slicing, so slices are length-uniform — long rows
    land together in wide buckets instead of spilling into the CSR tail,
    whose segment-sum scatter serializes on the long rows. y is
    un-permuted on output (one n-sized gather).

    `split_rows=True` splits rows longer than `split_len` into sub-rows of
    at most `split_len` entries (extra chunks get row ids n..), so no
    bucket is wider than `split_len` and there is no CSR tail. With sorted
    rows each sub-row covers a contiguous column chunk. y is re-aggregated with a segment-sum over only the extra
    sub-rows (few: one per split_len entries of a long row)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    n_out = n          # the caller-visible row count (pre group padding)
    nnz_total = coo.num_nonzeros
    R = slice_rows

    if split_rows and n:
        counts0 = np.bincount(coo.rowidx, minlength=n)
        long_row = counts0 > split_len
        if long_row.any():
            # Split long rows by column BAND first (bounded gather extent
            # per sub-row — rank chunks of different-density parents span
            # wildly different column ranges), then by rank within a band
            # (bounded entry count per sub-row).
            order0 = np.lexsort((coo.colidx, coo.rowidx))
            rows0 = coo.rowidx[order0].astype(np.int64)
            cols0 = coo.colidx[order0].astype(np.int64)
            band = np.where(long_row[rows0], cols0 // split_cols, 0)
            grp_change = np.empty(len(rows0), bool)
            grp_change[0] = True
            grp_change[1:] = (rows0[1:] != rows0[:-1]) | (band[1:]
                                                          != band[:-1])
            grp_id = np.cumsum(grp_change) - 1
            starts = np.flatnonzero(grp_change)
            rank_in_grp = np.arange(len(rows0)) - starts[grp_id]
            sub_change = grp_change | ((rank_in_grp > 0)
                                       & (rank_in_grp % split_len == 0))
            sub_seq = np.cumsum(sub_change) - 1       # row-major sub ids
            sub_first = np.flatnonzero(sub_change)
            sub_row = rows0[sub_first]                # original row per sub
            nsub = np.bincount(sub_row, minlength=n)  # 0 for empty rows
            sub_off = np.concatenate([[0], np.cumsum(nsub)])
            ordinal = np.arange(len(sub_row)) - sub_off[sub_row]
            nextra = np.maximum(nsub - 1, 0)
            extra_off = np.concatenate([[0], np.cumsum(nextra)])
            final = np.where(ordinal == 0, sub_row,
                             n + extra_off[sub_row] + ordinal - 1)
            num_sub = int(n + extra_off[-1])
            sm = sell_from_coo(
                CooMatrix(num_sub, m, final[sub_seq], coo.colidx[order0],
                          coo.values[order0]),
                slice_rows=slice_rows, tail_cap=max(tail_cap, split_len),
                sort_rows=sort_rows, length_sort=length_sort,
                split_rows=False, value_dtype=value_dtype,
                index_dtype=index_dtype)
            return dataclasses.replace(
                sm, num_rows=n, num_nonzeros=nnz_total,
                extra_rows=np.repeat(np.arange(n, dtype=np.int64), nextra),
                num_sub_rows=num_sub)

    row_unperm = None
    if length_sort and n:
        cnt0 = np.bincount(coo.rowidx, minlength=n)
        # primary key: the pow2 LENGTH BUCKET (slices are pow2-bucketed
        # downstream, so sorting by raw count buys nothing within a
        # bucket); secondary: each row's smallest column, so rows (and
        # split sub-rows, whose entries are contiguous column chunks) that
        # gather nearby x entries land in the same slice.
        first = np.full(n, m, np.int64)
        np.minimum.at(first, coo.rowidx, coo.colidx.astype(np.int64))
        lb = np.ceil(np.log2(np.maximum(cnt0, 1))).astype(np.int64)
        band = first // max(split_cols, 1)
        perm = np.lexsort((first, band, -lb))        # old row at position k
        # pad each length group to a slice multiple, so no slice mixes
        # two length groups, and within a group each column band to a
        # 128-row granularity, so row groups stay column-local.
        lb_sorted = lb[perm]
        band_sorted = band[perm]
        new_lb = np.concatenate([[True],
                                 lb_sorted[1:] != lb_sorted[:-1]])
        new_grp = new_lb | np.concatenate(
            [[True], band_sorted[1:] != band_sorted[:-1]])
        starts = np.flatnonzero(new_grp)
        sizes = np.diff(np.concatenate([starts, [n]]))
        pos_sorted = np.empty(n, np.int64)
        cum = 0
        for g in range(len(starts)):
            gran = R if new_lb[starts[g]] else 128
            cum = -(-cum // gran) * gran
            s0, sz = starts[g], sizes[g]
            pos_sorted[s0:s0 + sz] = cum + np.arange(sz)
            cum += sz
        inv = np.empty(n, np.int64)
        inv[perm] = pos_sorted
        n_eff = _round_up(cum, R)                    # includes gap rows
        coo = CooMatrix(n_eff, m, inv[coo.rowidx], coo.colidx, coo.values)
        n = n_eff
        row_unperm = inv                              # y_nat = y_sorted[inv]

    if split_rows:
        # with splitting on, nothing needs the CSR tail: rows are at most
        # split_len long (either naturally or after the split above)
        tail_cap = max(tail_cap, split_len)

    n_pad = max(_round_up(n, R), R)
    T = n_pad // R

    # rank of each entry within its row (stable by file order, or by column
    # when sorting — matching rowsort's effect, ellspmv.c:960-1079)
    if sort_rows:
        order = np.lexsort((coo.colidx, coo.rowidx))
    else:
        order = np.argsort(coo.rowidx, kind="stable")
    rows = coo.rowidx[order]
    cols = coo.colidx[order]
    vals = coo.values[order]
    counts = np.bincount(rows, minlength=n_pad)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(len(rows)) - rowptr[rows]

    in_tail = rank >= tail_cap
    tail = None
    if in_tail.any():
        tail_coo = CooMatrix(n, m, rows[in_tail], cols[in_tail],
                             vals[in_tail])
        tail = csr_from_coo(tail_coo, value_dtype=value_dtype,
                            index_dtype=index_dtype)
    keep = ~in_tail
    rows, cols, vals, rank = rows[keep], cols[keep], vals[keep], rank[keep]

    # per-slice rowsize (capped), bucketed to powers of two ≥ 4
    capped = np.minimum(counts[:n_pad], tail_cap)
    slice_s = capped.reshape(T, R).max(axis=1)
    bucket_s = np.maximum(4, 2 ** np.ceil(
        np.log2(np.maximum(slice_s, 1))).astype(np.int64))
    bucket_sizes = sorted(set(int(b) for b in bucket_s))

    buckets = []
    concat_pos = np.zeros(T, np.int64)
    pos = 0
    tile_of_row = rows // R
    for S in bucket_sizes:
        tiles = np.nonzero(bucket_s == S)[0]
        concat_pos[tiles] = pos + np.arange(len(tiles))
        pos += len(tiles)
        # select entries of these tiles; renumber rows contiguously
        tile_rank = np.full(T, -1, np.int64)
        tile_rank[tiles] = np.arange(len(tiles))
        sel = tile_rank[tile_of_row] >= 0
        sub_rows = tile_rank[tile_of_row[sel]] * R + rows[sel] % R
        sub = CooMatrix(len(tiles) * R, m, sub_rows, cols[sel], vals[sel])
        buckets.append(ell_from_coo(sub, sort_rows=sort_rows,
                                    value_dtype=value_dtype,
                                    index_dtype=index_dtype,
                                    row_tile=R, rowsize=S))
    return SellMatrix(buckets=buckets, order=concat_pos, slice_rows=R,
                      tail=tail, num_rows=n_out, num_columns=m,
                      num_nonzeros=nnz_total, row_unperm=row_unperm)


def sell_spmv(sm: SellMatrix, x, y=None):
    """y := A*x + y over the hybrid: per-bucket ELL kernels, slice-granular
    reassembly, segment-sum tail."""
    import jax.numpy as jnp

    from ellspmv_jax.ops.csr_xla import csr_spmv_xla
    from ellspmv_jax.ops.ell_xla import ell_spmv_xla

    x = jnp.asarray(x)
    if sm.trivial_reassembly:
        out = ell_spmv_xla(sm.buckets[0], x)[:sm.num_rows]
        if y is not None:
            out = out + jnp.asarray(y).astype(out.dtype)
        return out
    R = sm.slice_rows
    n_sub = sm.num_sub_rows if sm.num_sub_rows is not None else sm.num_rows
    parts = [ell_spmv_xla(b, x).reshape(-1, R) for b in sm.buckets]
    tiles = jnp.concatenate(parts, axis=0)           # (T, R) concat order
    out = tiles[jnp.asarray(sm.order)].reshape(-1)   # original tile order
    if sm.tail is not None:                          # tail ids are padded
        out = csr_spmv_xla(sm.tail, x, out[:sm.tail.num_rows])
    if sm.row_unperm is not None:
        # SELL-sigma un-permute: index the PADDED sorted vector (length-
        # group padding leaves gap rows the unperm skips)
        out = out[jnp.asarray(sm.row_unperm)]
    else:
        out = out[:n_sub]
    if sm.extra_rows is not None:                    # long-row re-aggregate
        extras = jax.ops.segment_sum(
            out[sm.num_rows:], jnp.asarray(sm.extra_rows),
            num_segments=sm.num_rows, indices_are_sorted=True)
        out = out[:sm.num_rows] + extras
    if y is not None:
        out = out + jnp.asarray(y).astype(out.dtype)
    return out
