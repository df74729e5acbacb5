"""Bandwidth-reducing row/column reordering (reverse Cuthill–McKee).

The reference gets its headline numbers on an already-reordered matrix
(Lynx68_reordered, README:130) and relies on hardware prefetchers plus the
A64FX sector cache for locality. RCM manufactures that locality for general
FEM/graph matrices: a narrow band keeps each row's x gathers close
together, so they hit in cache.

Pure NumPy BFS implementation (host-side preprocessing, like the format
conversions).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ellspmv_jax.formats.coo import CooMatrix


def rcm_permutation(coo: CooMatrix) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the symmetrized pattern.

    Returns perm with new_index = perm_inv[old]; i.e. `perm[k]` is the old
    index placed at position k.
    """
    n = coo.num_rows
    if coo.num_rows != coo.num_columns:
        raise ValueError("RCM needs a square matrix")
    # symmetrized adjacency in CSR form
    r = np.concatenate([coo.rowidx, coo.colidx]).astype(np.int64)
    c = np.concatenate([coo.colidx, coo.rowidx]).astype(np.int64)
    off = r != c
    r, c = r[off], c[off]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    deg = np.bincount(r, minlength=n)
    ptr = np.concatenate([[0], np.cumsum(deg)])

    visited = np.zeros(n, bool)
    result = np.empty(n, np.int64)
    pos = 0
    for start_candidate in np.argsort(deg, kind="stable"):
        if visited[start_candidate]:
            continue
        # BFS from the minimum-degree unvisited vertex, neighbors sorted by
        # degree (classic CM), whole ordering reversed at the end.
        queue = [int(start_candidate)]
        visited[start_candidate] = True
        while queue:
            v = queue.pop(0)
            result[pos] = v
            pos += 1
            nbrs = c[ptr[v]:ptr[v + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                queue.extend(int(u) for u in nbrs)
    return result[::-1].copy()


@dataclasses.dataclass
class ReorderedMatrix:
    """A permuted matrix plus the maps to translate x and y.

    SpMV in the reordered space: yp = Ap xp with xp = x[perm],
    y = yp[inv] — both translations are static gathers applied once per
    solve, not per iteration (in CG the whole Krylov loop runs reordered).
    """
    coo: CooMatrix
    perm: np.ndarray       # old index placed at position k
    inv: np.ndarray        # position of old index i

    def permute_x(self, x):
        return np.asarray(x)[self.perm]

    def unpermute_y(self, yp):
        return np.asarray(yp)[self.inv]


def reorder_rcm(coo: CooMatrix) -> ReorderedMatrix:
    coo = coo.expand_symmetry()
    perm = rcm_permutation(coo)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    new = CooMatrix(coo.num_rows, coo.num_columns,
                    inv[coo.rowidx].astype(coo.rowidx.dtype),
                    inv[coo.colidx].astype(coo.colidx.dtype),
                    coo.values.copy(), "general", coo.field)
    return ReorderedMatrix(coo=new, perm=perm, inv=inv)


def bandwidth(coo: CooMatrix) -> int:
    """Matrix bandwidth max|i-j| (the quantity RCM minimizes)."""
    if coo.num_nonzeros == 0:
        return 0
    return int(np.max(np.abs(coo.rowidx.astype(np.int64)
                             - coo.colidx.astype(np.int64))))
