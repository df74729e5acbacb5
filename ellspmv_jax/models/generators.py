"""Benchmark matrix generators — the framework's "model families".

The reference benchmarks whatever Matrix Market file it is given; the
driver's benchmark configs (BASELINE.json) name specific matrix classes.
These generators build them directly as COO, so benchmarks need no giant
.mtx files on disk:

- `poisson2d`: 2-D 5-point Poisson stencil (uniform 5 nnz/row — ideal ELL,
  zero padding; BASELINE configs[1]);
- `banded_random`: random banded matrix (bounded bandwidth with NO local
  smoothness — the adversarial case for windowed gather kernels);
- `fem_mesh_2d`: jittered-mesh FEM matrix in banded node order — the
  faithful cant/consph/Lynx68 stand-in (configs[2], README:130);
- `power_law`: skewed row/column degree matrix (webbase-like; the ELL
  padding blowup + hybrid-format case; configs[3]);
- `dense_rows`: pathological few-dense-rows case for the SELL/CSR-tail
  split.
"""

from __future__ import annotations

import numpy as np

from ellspmv_jax.formats.coo import CooMatrix


def poisson2d(nx: int, ny: int | None = None, value_dtype=np.float64
              ) -> CooMatrix:
    """5-point Laplacian on an nx×ny grid, natural (row-major) ordering.

    Row i=(r,c) couples to (r±1,c) and (r,c±1) with -1, diagonal 4.
    """
    if ny is None:
        ny = nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // ny, idx % ny
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for (dr, dc) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < nx) & (cc >= 0) & (cc < ny)
        rows.append(idx[ok])
        cols.append((rr * ny + cc)[ok])
        vals.append(np.full(ok.sum(), -1.0))
    rowidx = np.concatenate(rows)
    colidx = np.concatenate(cols)
    values = np.concatenate(vals).astype(value_dtype)
    idx_dt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rowidx.astype(idx_dt), colidx.astype(idx_dt),
                     values)


def banded_random(n: int, nnz_per_row: int, bandwidth: int,
                  seed: int = 0, value_dtype=np.float64) -> CooMatrix:
    """Random matrix with `nnz_per_row` entries per row, columns uniform in
    a ±bandwidth window around the diagonal (FEM-like locality)."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    off = rng.randint(-bandwidth, bandwidth + 1, size=n * nnz_per_row)
    cols = np.clip(rows + off, 0, n - 1)
    # dedupe (row, col) pairs to keep exact nnz counting simple
    keys = rows * n + cols
    _, keep = np.unique(keys, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows)).astype(value_dtype)
    idx_dt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)


def fem_mesh_2d(nx: int, ny: int | None = None, extras: int = 4,
                seed: int = 0, value_dtype=np.float64) -> CooMatrix:
    """Unstructured-FEM-like mesh matrix in banded (RCM-like) node order —
    the faithful stand-in for the reference's published benchmark matrix
    Lynx68_reordered.mtx (README:130: 6.8M rows, ~17 nnz/row, RCM-reordered
    FEM mesh; BASELINE configs[2] "SuiteSparse FEM matrix").

    Nodes sit on an nx×ny grid in row-major order (= the band-limited
    ordering RCM would produce). Each node couples to itself and its
    8-neighborhood (smooth local structure, like a mesh's P1 stencil) plus
    `extras` random distinct distance-2-ring neighbors (the unstructured
    jitter: variable row lengths, rank/diagonal slips — what distinguishes
    a real mesh from a clean stencil). Symmetrized, so row lengths vary
    further (~13-21 nnz/row for extras=4). Values are random; the diagonal
    is boosted to keep the matrix SPD-usable for CG demos."""
    if ny is None:
        ny = nx
    rng = np.random.RandomState(seed)
    n = nx * ny
    ii, jj = np.divmod(np.arange(n, dtype=np.int64), ny)

    rows_l, cols_l = [], []
    # self + 8-neighborhood
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ok = ((ii + di >= 0) & (ii + di < nx)
                  & (jj + dj >= 0) & (jj + dj < ny))
            rows_l.append(np.flatnonzero(ok).astype(np.int64))
            cols_l.append(rows_l[-1] + di * ny + dj)
    # random distance-2-ring extras (upper triangle only; symmetrized below)
    ring = np.array([(di, dj) for di in (-2, -1, 0, 1, 2)
                     for dj in (-2, -1, 0, 1, 2)
                     if max(abs(di), abs(dj)) == 2 and (di, dj) > (0, 0)],
                    dtype=np.int64)
    for _ in range(extras):
        pick = ring[rng.randint(0, len(ring), size=n)]
        di, dj = pick[:, 0], pick[:, 1]
        ok = ((ii + di >= 0) & (ii + di < nx)
              & (jj + dj >= 0) & (jj + dj < ny))
        r = np.flatnonzero(ok).astype(np.int64)
        c = r + di[ok] * ny + dj[ok]
        rows_l.append(np.concatenate([r, c]))   # symmetrize
        cols_l.append(np.concatenate([c, r]))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keys = rows * n + cols
    _, keep = np.unique(keys, return_index=True)
    rows, cols = rows[keep], cols[keep]
    # one value per unordered pair so the matrix is numerically symmetric
    # (CG on it is then mathematically valid), with a boosted diagonal for
    # strict diagonal dominance => SPD
    pair = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    uniq, inv = np.unique(pair, return_inverse=True)
    pair_vals = rng.randn(len(uniq))
    vals = pair_vals[inv].astype(value_dtype)
    diag = rows == cols
    vals[diag] = 24.0 + rng.rand(diag.sum())
    idx_dt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)


def power_law(n: int, avg_nnz_per_row: int, alpha: float = 1.8,
              seed: int = 0, value_dtype=np.float64) -> CooMatrix:
    """Skewed matrix: row lengths ~ Zipf(alpha) capped at n, columns chosen
    by preferential attachment (hub columns) — a webbase-like structure."""
    rng = np.random.RandomState(seed)
    raw = rng.zipf(alpha, size=n).astype(np.int64)
    counts = np.minimum(raw, n)
    scale = counts.sum() / (avg_nnz_per_row * n)
    counts = np.maximum(1, (counts / max(scale, 1e-9)).astype(np.int64))
    counts = np.minimum(counts, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    # column popularity ~ power law too
    popularity = 1.0 / np.arange(1, n + 1) ** 0.8
    popularity /= popularity.sum()
    cols = rng.choice(n, size=len(rows), p=popularity)
    keys = rows * n + cols
    _, keep = np.unique(keys, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows)).astype(value_dtype)
    idx_dt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)


def dense_rows(n: int, base_nnz: int, num_dense: int, dense_nnz: int,
               bandwidth: int | None = None, seed: int = 0,
               value_dtype=np.float64) -> CooMatrix:
    """Mostly-local matrix with a few very long random rows — constraint
    rows (Lagrange multipliers, normalization/boundary conditions) on top
    of a banded FEM-like bulk. The worst case for plain ELL (rowsize =
    dense_nnz for EVERY row, ellspmv.c:955) and the class where the SELL
    length-sort + long-row split wins: the local bulk keeps narrow windowed
    plans while the few dense rows split into bounded sub-rows.

    `bandwidth` bounds the bulk rows' column offsets (default
    32*base_nnz); the `num_dense` long rows draw columns uniformly."""
    rng = np.random.RandomState(seed)
    if bandwidth is None:
        bandwidth = 32 * base_nnz
    rows = np.repeat(np.arange(n, dtype=np.int64), base_nnz)
    off = rng.randint(-bandwidth, bandwidth + 1, size=len(rows))
    cols = np.clip(rows + off, 0, n - 1)
    drows = rng.choice(n, num_dense, replace=False)
    rows = np.concatenate([rows, np.repeat(drows, dense_nnz)])
    cols = np.concatenate([cols,
                           rng.randint(0, n, num_dense * dense_nnz)])
    keys = rows * n + cols
    _, keep = np.unique(keys, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows)).astype(value_dtype)
    idx_dt = np.int32 if n < 2**31 else np.int64
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)
