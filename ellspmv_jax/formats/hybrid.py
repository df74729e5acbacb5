"""Hub-column hybrid — power-law matrices (BASELINE configs[3]).

Power-law (webbase-like) matrices have no column locality, but their
*column degrees* are power-law too — a few thousand hub columns carry most
of the nonzeros. The split:

- the top-H columns by degree become a compact hub id space [0, H); hub
  entries form a sliced-ELL matrix over x_hub = x[hub_cols] (one small
  gather per SpMV), whose gathers stay within a small, cache-resident x;
- the remaining low-degree entries stay in a sliced-ELL/CSR-tail rest
  matrix.

Semantics stay ``y := A*x + y``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ellspmv_jax.formats.coo import CooMatrix
from ellspmv_jax.formats.sell import SellMatrix, sell_from_coo, sell_spmv


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HybridMatrix:
    hub: Optional[SellMatrix]      # over the compact hub id space
    hub_cols: Optional[np.ndarray]  # (H,) original column ids, degree-desc
    rest: SellMatrix
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_columns: int = dataclasses.field(metadata=dict(static=True))
    num_nonzeros: int = dataclasses.field(metadata=dict(static=True))

    @property
    def hub_nnz_fraction(self) -> float:
        if self.hub is None:
            return 0.0
        hub_work = self.hub.sellsize + self.hub.tailsize
        rest_work = self.rest.sellsize + self.rest.tailsize
        return hub_work / max(hub_work + rest_work, 1)

    @property
    def values(self):
        return self.rest.values

    def device_put(self, value_dtype=None) -> "HybridMatrix":
        import jax.numpy as jnp
        return HybridMatrix(
            None if self.hub is None else self.hub.device_put(value_dtype),
            None if self.hub_cols is None else jnp.asarray(self.hub_cols),
            self.rest.device_put(value_dtype),
            self.num_rows, self.num_columns, self.num_nonzeros)


def hybrid_from_coo(coo: CooMatrix, hub_width: int | None = None,
                    min_hub_fraction: float = 0.15,
                    slice_rows: int = 1024, tail_cap: int = 2048,
                    length_sort: bool = True,
                    sort_rows: bool = True, value_dtype=None,
                    index_dtype=None) -> HybridMatrix:
    """Split off the top-`hub_width` columns by degree (auto-sized by
    default); hub disabled when it would carry < `min_hub_fraction` of the
    nonzeros."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz = coo.num_nonzeros
    sell_kw = dict(slice_rows=slice_rows, tail_cap=tail_cap,
                   length_sort=length_sort,
                   sort_rows=sort_rows, value_dtype=value_dtype,
                   index_dtype=index_dtype)

    deg = np.bincount(coo.colidx, minlength=m)
    if hub_width is None:
        hub_width = int(min(65536, _round_up(max(m // 16, 128), 128)))
    H = min(hub_width, _round_up(m, 128))
    order = np.argsort(deg)[::-1][:H]
    hub_mass = int(deg[order].sum())
    if nnz == 0 or hub_mass < min_hub_fraction * nnz or H >= m:
        rest = sell_from_coo(coo, **sell_kw)
        return HybridMatrix(None, None, rest, n, m, nnz)

    local = np.full(m, -1, np.int64)
    local[order] = np.arange(H)
    loc = local[coo.colidx]
    in_hub = loc >= 0
    hub_coo = CooMatrix(n, H, coo.rowidx[in_hub],
                        loc[in_hub].astype(coo.colidx.dtype),
                        coo.values[in_hub])
    rest_coo = CooMatrix(n, m, coo.rowidx[~in_hub], coo.colidx[~in_hub],
                         coo.values[~in_hub])
    return HybridMatrix(
        hub=sell_from_coo(hub_coo, **sell_kw),
        hub_cols=order.astype(np.int32),
        rest=sell_from_coo(rest_coo, **sell_kw),
        num_rows=n, num_columns=m, num_nonzeros=nnz)


def hybrid_spmv(hm: HybridMatrix, x, y=None):
    import jax.numpy as jnp

    x = jnp.asarray(x)
    out = None
    if hm.hub is not None:
        x_hub = jnp.take(x, jnp.asarray(hm.hub_cols), axis=0)
        out = sell_spmv(hm.hub, x_hub, None)
    out = sell_spmv(hm.rest, x, out)
    if y is not None:
        out = out + jnp.asarray(y).astype(out.dtype)
    return out
