"""Row-sharded multi-device SpMV: A row-sharded, x allgathered, y sharded.

This realizes the reference's three thread-partition strategies across
devices (SURVEY §2.4):

- ``partition='rows'``   → equal row blocks per device (the default enclosing
  `omp parallel` + orphaned `omp for`, csrspmv.c:2834-2837);
- ``partition='nonzeros'`` → device row-block boundaries chosen so each
  device owns ~equal nonzeros (csrgemvnz's intent, csrspmv.c:1681-1761,
  without its atomics: blocks stay row-aligned, so no write conflicts);
- ``rows_per_device=[N, ...]`` → explicit row counts (csrgemvrp /
  ``--rows-per-thread``, csrspmv.c:2022-2053).

Because SPMD blocks must be equal-shaped, uneven partitions are realized by
padding every device's block to the largest block (padding rows multiply
zeros against in-bounds columns). The physical y layout is
``(n_dev * block,)`` with device d's rows at ``[d*block, d*block+rows_d)``;
the precomputed `unpermute` gather restores the logical vector.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ellspmv_jax.config import accumulation_dtype
from ellspmv_jax.formats.csr import CsrMatrix
from ellspmv_jax.formats.ell import EllMatrix
from ellspmv_jax.parallel.mesh import make_mesh


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _partition_boundaries(mat, n_dev: int, partition: str,
                          rows_per_device) -> np.ndarray:
    """Row-block boundaries (n_dev+1,) over the logical rows."""
    n = mat.num_rows
    if rows_per_device is not None:
        if len(rows_per_device) != n_dev:
            raise ValueError(f"rows-per-device list has "
                             f"{len(rows_per_device)} entries for {n_dev} "
                             "devices")
        if sum(rows_per_device) != n:
            # same check as csrspmv.c:2041-2053
            raise ValueError(f"rows-per-device sums to "
                             f"{sum(rows_per_device)}, expected {n}")
        return np.concatenate([[0], np.cumsum(rows_per_device)])
    if partition == "nonzeros":
        # Balanced-nnz boundaries via the row-count prefix sum — the
        # precomputed variant of csrgemvnz's startrow scan
        # (csrspmv.c:2054-2071).
        if isinstance(mat, CsrMatrix):
            rowptr = np.asarray(mat.rowptr, dtype=np.int64)
        else:
            counts = (np.asarray(mat.values)[:mat.num_rows] != 0).sum(axis=1)
            rowptr = np.concatenate([[0], np.cumsum(counts)])
        total = rowptr[-1]
        targets = (np.arange(1, n_dev) * total) // n_dev
        inner = np.searchsorted(rowptr, targets, side="left")
        return np.concatenate([[0], inner, [n]])
    # equal rows
    b = -(-n // n_dev)
    return np.minimum(np.arange(n_dev + 1) * b, n)


@dataclasses.dataclass
class ShardedMatrix:
    """A row-sharded EllMatrix or CsrMatrix in physical (padded-block)
    layout, plus the mesh and logical<->physical row maps."""

    base: EllMatrix | CsrMatrix      # physical layout, arrays sharded
    mesh: Mesh
    boundaries: np.ndarray           # (n_dev+1,) logical row boundaries
    block: int                       # physical rows per device
    logical_rows: int
    logical_cols: int
    x_block: int                     # physical x entries per device
    unpermute: jax.Array             # (logical_rows,) physical y -> logical

    # --- delegation so the bench harness can treat this like a matrix ---
    @property
    def num_rows(self):
        return self.logical_rows

    @property
    def num_columns(self):
        return self.logical_cols

    @property
    def num_nonzeros(self):
        return self.base.num_nonzeros

    @property
    def values(self):
        return self.base.values

    def workload_report(self) -> list[str]:
        """Per-device rows/nonzeros table — the `-vv` workload report
        (csrspmv.c:2289-2338)."""
        lines = ["device  rows       nonzeros"]
        if isinstance(self.base, CsrMatrix):
            nnz_per = np.diff(self._entries_per_device)
        else:
            counts = (np.asarray(self.base.values) != 0).reshape(
                self.mesh.devices.size, self.block, -1)
            nnz_per = counts.sum(axis=(1, 2)).astype(np.int64)
        rows_per = np.diff(self.boundaries)
        for d in range(self.mesh.devices.size):
            lines.append(f"{d:<7d} {rows_per[d]:<10d} {int(nnz_per[d])}")
        return lines

    _entries_per_device: np.ndarray | None = None


def shard_matrix(mat, n_devices: int | None = None, partition: str = "rows",
                 rows_per_device=None, mesh: Mesh | None = None
                 ) -> ShardedMatrix:
    """Cut an EllMatrix or CsrMatrix into equal-shaped per-device row
    blocks (padded to the largest block) and place them on the mesh."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    bounds = _partition_boundaries(mat, n_dev, partition, rows_per_device)
    rows_per = np.diff(bounds)
    if isinstance(mat, EllMatrix):
        tile = 128
        block = max(_round_up(int(rows_per.max()), tile), tile)
        r = mat.rowsize
        idx_dt = np.asarray(mat.colidx).dtype
        val_dt = np.asarray(mat.values).dtype
        m = mat.num_columns
        pad_col = np.minimum(np.arange(block * n_dev, dtype=idx_dt),
                             max(m - 1, 0))
        colidx = np.broadcast_to(pad_col[:, None],
                                 (block * n_dev, r)).copy()
        values = np.zeros((block * n_dev, r), val_dt)
        diag = np.zeros(block * n_dev, val_dt) if mat.diag is not None \
            else None
        src_col = np.asarray(mat.colidx)
        src_val = np.asarray(mat.values)
        src_diag = None if mat.diag is None else np.asarray(mat.diag)
        unperm = np.zeros(mat.num_rows, np.int64)
        for d in range(n_dev):
            lo, hi = bounds[d], bounds[d + 1]
            cnt = hi - lo
            colidx[d * block:d * block + cnt] = src_col[lo:hi]
            values[d * block:d * block + cnt] = src_val[lo:hi]
            if diag is not None:
                diag[d * block:d * block + cnt] = src_diag[lo:hi]
            unperm[lo:hi] = np.arange(d * block, d * block + cnt)
        shard = NamedSharding(mesh, P(axis, None))
        shard1 = NamedSharding(mesh, P(axis))
        base = EllMatrix(
            colidx=jax.device_put(colidx, shard),
            values=jax.device_put(values, shard),
            diag=None if diag is None else jax.device_put(diag, shard1),
            num_rows=mat.num_rows, num_columns=m,
            num_nonzeros=mat.num_nonzeros)
        return ShardedMatrix(base=base, mesh=mesh, boundaries=bounds,
                             block=block, logical_rows=mat.num_rows,
                             logical_cols=m,
                             x_block=_round_up(max(m, 1), n_dev) // n_dev,
                             unpermute=jnp.asarray(unperm))
    if isinstance(mat, CsrMatrix):
        rowptr = np.asarray(mat.rowptr, dtype=np.int64)
        entries_bounds = rowptr[bounds]
        per_dev = np.diff(entries_bounds)
        eblock = max(int(per_dev.max()), 1)
        idx_dt = np.asarray(mat.colidx).dtype
        val_dt = np.asarray(mat.values).dtype
        m = mat.num_columns
        colidx = np.zeros(eblock * n_dev, idx_dt)
        values = np.zeros(eblock * n_dev, val_dt)
        # local row ids within the device block (padding entries -> row 0 of
        # the block with value 0: harmless)
        rowids = np.zeros(eblock * n_dev, idx_dt)
        diag = None
        block = max(_round_up(int(rows_per.max()), 8), 8)
        if mat.diag is not None:
            diag = np.zeros(block * n_dev, val_dt)
        src_col = np.asarray(mat.colidx)
        src_val = np.asarray(mat.values)
        src_row = np.asarray(mat.rowids)
        src_diag = None if mat.diag is None else np.asarray(mat.diag)
        unperm = np.zeros(mat.num_rows, np.int64)
        for d in range(n_dev):
            lo, hi = entries_bounds[d], entries_bounds[d + 1]
            cnt = hi - lo
            colidx[d * eblock:d * eblock + cnt] = src_col[lo:hi]
            values[d * eblock:d * eblock + cnt] = src_val[lo:hi]
            rowids[d * eblock:d * eblock + cnt] = src_row[lo:hi] - bounds[d]
            rlo, rhi = bounds[d], bounds[d + 1]
            if diag is not None:
                diag[d * block:d * block + (rhi - rlo)] = src_diag[rlo:rhi]
            unperm[rlo:rhi] = np.arange(d * block, d * block + (rhi - rlo))
        shard1 = NamedSharding(mesh, P(axis))
        base = CsrMatrix(
            rowptr=jnp.asarray(rowptr),   # kept whole (host metadata)
            colidx=jax.device_put(colidx, shard1),
            values=jax.device_put(values, shard1),
            rowids=jax.device_put(rowids, shard1),
            diag=None if diag is None else jax.device_put(diag, shard1),
            num_rows=mat.num_rows, num_columns=m,
            num_nonzeros=mat.num_nonzeros)
        sm = ShardedMatrix(base=base, mesh=mesh, boundaries=bounds,
                           block=block, logical_rows=mat.num_rows,
                           logical_cols=m,
                           x_block=_round_up(max(m, 1), n_dev) // n_dev,
                           unpermute=jnp.asarray(unperm))
        sm._entries_per_device = entries_bounds
        return sm
    raise TypeError(f"unsupported matrix type {type(mat)}")


def sharded_spmv_fn(sm: ShardedMatrix):
    """Build `fn(sm, x_logical, y_logical|None) -> y_logical` running the
    local kernel per device under shard_map with an allgather of x."""
    shard_map = jax.shard_map

    mesh, axis = sm.mesh, sm.mesh.axis_names[0]
    n_dev = mesh.devices.size
    m = sm.base.num_columns
    base = sm.base
    is_ell = isinstance(base, EllMatrix)
    val_dt = np.asarray(base.values).dtype
    acc_dt = accumulation_dtype(val_dt)

    # Per-device logical row start: physical row p on device d is logical
    # row row_start[d] + (p - d*block), which is also the x index the split
    # diagonal multiplies against (ellgemvsd's y[i] += ad[i]*x[i],
    # ellspmv.c:1177).
    row_start = jnp.asarray(sm.boundaries[:-1], jnp.int32)

    if is_ell:
        in_specs = (P(axis, None), P(axis, None), P(axis),
                    *(() if base.diag is None else (P(axis),)),
                    P(axis), P(axis))
        def local(colidx, values, start, *rest):
            *maybe_diag, x_blk, y_blk = rest
            x_full = jax.lax.all_gather(x_blk, axis, tiled=True)[:m]
            x_full = x_full.astype(acc_dt)
            acc = y_blk.astype(acc_dt)
            if values.shape[1]:
                acc = acc + (values.astype(acc_dt) * x_full[colidx]).sum(
                    axis=1)
            if maybe_diag:
                gi = start[0] + jnp.arange(sm.block, dtype=jnp.int32)
                xi = jnp.minimum(gi, max(m - 1, 0))
                acc = acc + maybe_diag[0].astype(acc_dt) * x_full[xi]
            return acc.astype(val_dt)
        args = (base.colidx, base.values, row_start) + \
            (() if base.diag is None else (base.diag,))
    else:
        in_specs = (P(axis), P(axis), P(axis), P(axis),
                    *(() if base.diag is None else (P(axis),)),
                    P(axis), P(axis))
        def local(colidx, values, rowids, start, *rest):
            *maybe_diag, x_blk, y_blk = rest
            x_full = jax.lax.all_gather(x_blk, axis, tiled=True)[:m]
            x_full = x_full.astype(acc_dt)
            prod = values.astype(acc_dt) * x_full[colidx]
            acc = y_blk.astype(acc_dt) + jax.ops.segment_sum(
                prod, rowids, num_segments=sm.block)
            if maybe_diag:
                gi = start[0] + jnp.arange(sm.block, dtype=jnp.int32)
                xi = jnp.minimum(gi, max(m - 1, 0))
                acc = acc + maybe_diag[0].astype(acc_dt) * x_full[xi]
            return acc.astype(val_dt)
        args = (base.colidx, base.values, base.rowids, row_start) + \
            (() if base.diag is None else (base.diag,))

    mapped = shard_map(local, mesh=mesh,
                       in_specs=in_specs, out_specs=P(axis),
                       check_vma=False)

    # Matrix arrays travel as jit ARGUMENTS, not compiled-in constants, and
    # the logical<->physical layout transforms trace with them (sharding
    # via `with_sharding_constraint`). `.traceable = (operand, fn)` is the
    # form the bench harness's chained protocol and CG jit, so
    # ``ellspmv --devices=N --protocol=chained`` works under every
    # partition flag, as the reference's timed loop does
    # (ellspmv.c:1821-1876).
    x_shard = NamedSharding(mesh, P(axis))
    m_pad = sm.x_block * n_dev
    phys_rows = sm.block * n_dev

    def traceable_fn(op, x, y=None):
        unperm, *rest = op
        x = jnp.asarray(x, val_dt)
        x_phys = jax.lax.with_sharding_constraint(
            jnp.pad(x, (0, m_pad - x.shape[0])), x_shard)
        y_phys = jnp.zeros(phys_rows, val_dt)
        if y is not None:
            y_phys = y_phys.at[unperm].set(jnp.asarray(y, val_dt))
        return mapped(*rest, x_phys, y_phys)[unperm]

    operand = (sm.unpermute,) + tuple(args)
    jitted = jax.jit(traceable_fn)

    def fn(_sm, x, y=None):
        return jitted(operand, x, y)

    fn.traceable = (operand, traceable_fn)
    return fn
