"""RCM reordering tests: permutation validity, bandwidth reduction, SpMV
equivalence through the reordered space."""

import numpy as np

from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.models.reorder import bandwidth, reorder_rcm
from ellspmv_jax.ops.reference import coo_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo


def shuffled_banded(rng, n, nnz_per_row, bw):
    """A banded matrix hidden behind a random permutation — the structure
    RCM should recover."""
    from ellspmv_jax.models.generators import banded_random
    coo = banded_random(n, nnz_per_row, bw, seed=7)
    p = rng.permutation(n).astype(coo.rowidx.dtype)
    import dataclasses
    return dataclasses.replace(coo, rowidx=p[coo.rowidx],
                               colidx=p[coo.colidx])


def test_rcm_reduces_bandwidth(rng):
    coo = shuffled_banded(rng, 2000, 5, 20)
    assert bandwidth(coo) > 1000          # destroyed by the shuffle
    rm = reorder_rcm(coo)
    assert bandwidth(rm.coo) < 200        # recovered


def test_rcm_permutation_valid(rng):
    coo = random_coo(rng, 300, 300, 1200)
    rm = reorder_rcm(coo)
    assert sorted(rm.perm) == list(range(300))
    np.testing.assert_array_equal(rm.perm[rm.inv], np.arange(300))


def test_spmv_through_reordering(rng):
    coo = shuffled_banded(rng, 500, 6, 15)
    rm = reorder_rcm(coo)
    x = rng.randn(500)
    want = coo_spmv_numpy(coo, x)
    ell = ell_from_coo(rm.coo, sort_rows=True)
    from ellspmv_jax.ops.ell_xla import ell_spmv_xla
    yp = np.asarray(ell_spmv_xla(ell, rm.permute_x(x)))
    assert_fp64_close(rm.unpermute_y(yp), want)


def test_disconnected_components(rng):
    # two independent blocks — BFS must restart
    from ellspmv_jax.formats.coo import CooMatrix
    rows = np.array([0, 1, 2, 3], np.int32)
    cols = np.array([1, 0, 3, 2], np.int32)
    coo = CooMatrix(4, 4, rows, cols, np.ones(4))
    rm = reorder_rcm(coo)
    assert sorted(rm.perm) == [0, 1, 2, 3]
