"""Conversion unit tests: COO→ELL/CSR vs the dense oracle, symmetric
expansion, diagonal split, row sorting, index dtype selection."""

import numpy as np
import pytest

from ellspmv_jax.config import select_index_dtype
from ellspmv_jax.formats.csr import csr_from_coo
from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.ops.reference import (coo_spmv_numpy, csr_spmv_numpy,
                                       ell_spmv_numpy)
from tests.conftest import random_coo


def dense_spmv(coo, x, y=None):
    out = np.zeros(coo.num_rows) if y is None else np.asarray(y, float).copy()
    return out + coo.to_dense() @ x


@pytest.mark.parametrize("sep_diag", [False, True])
@pytest.mark.parametrize("sort_rows", [False, True])
def test_ell_roundtrip_small(small_coo, sep_diag, sort_rows):
    ell = ell_from_coo(small_coo, separate_diagonal=sep_diag,
                       sort_rows=sort_rows)
    x = np.ones(5)
    y = ell_spmv_numpy(ell, x)
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=1e-15)
    # accumulate semantics: y := A*x + y
    y2 = ell_spmv_numpy(ell, x, y=np.full(4, 10.0))
    np.testing.assert_allclose(y2, [13, 11, 13, 16], rtol=1e-15)


@pytest.mark.parametrize("sep_diag", [False, True])
@pytest.mark.parametrize("sort_rows", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (60, 100), (100, 60), (1, 1)])
def test_ell_csr_vs_dense(rng, sep_diag, sort_rows, symmetric, shape):
    n, m = shape
    if symmetric and n != m:
        pytest.skip("symmetric implies square")
    coo = random_coo(rng, n, m, min(n * m // 2, 400), symmetric=symmetric)
    x = rng.randn(m)
    y0 = rng.randn(n)
    want = dense_spmv(coo, x, y0)

    ell = ell_from_coo(coo, separate_diagonal=sep_diag, sort_rows=sort_rows)
    np.testing.assert_allclose(ell_spmv_numpy(ell, x, y0), want, rtol=1e-12)

    csr = csr_from_coo(coo, separate_diagonal=sep_diag, sort_rows=sort_rows)
    np.testing.assert_allclose(csr_spmv_numpy(csr, x, y0), want, rtol=1e-12)

    np.testing.assert_allclose(coo_spmv_numpy(coo, x, y0), want, rtol=1e-12)


def test_ell_padding_in_bounds(rng):
    coo = random_coo(rng, 30, 7, 60, with_dups=True)
    ell = ell_from_coo(coo, row_tile=8)
    assert ell.padded_rows == 32
    c = np.asarray(ell.colidx)
    assert c.min() >= 0 and c.max() < 7
    # padding slots carry value 0 → padded rows contribute nothing
    assert np.asarray(ell.values)[30:].sum() == 0


def test_ell_rowsize_and_sizes(small_coo):
    ell = ell_from_coo(small_coo)
    assert ell.rowsize == 5          # longest row has 5 entries
    assert ell.ellsize == 4 * 5
    assert ell.diagsize == 4         # min(4,5), unconditional (ellspmv.c:956)
    ell_sd = ell_from_coo(small_coo, separate_diagonal=True)
    assert ell_sd.rowsize == 4       # row 3 loses its diagonal entry
    assert ell_sd.diag is not None


def test_forced_rowsize_gemv16_analogue(small_coo):
    ell = ell_from_coo(small_coo, rowsize=16)
    assert ell.rowsize == 16
    np.testing.assert_allclose(ell_spmv_numpy(ell, np.ones(5)), [3, 1, 3, 6])
    with pytest.raises(ValueError):
        ell_from_coo(small_coo, rowsize=2)


def test_duplicate_entries_accumulate(rng):
    coo = random_coo(rng, 16, 16, 100, with_dups=True)
    x = rng.randn(16)
    want = dense_spmv(coo, x)
    ell = ell_from_coo(coo, separate_diagonal=True)
    np.testing.assert_allclose(ell_spmv_numpy(ell, x), want, rtol=1e-12)
    csr = csr_from_coo(coo, separate_diagonal=True)
    np.testing.assert_allclose(csr_spmv_numpy(csr, x), want, rtol=1e-12)


def test_sort_rows_orders_columns(rng):
    coo = random_coo(rng, 32, 48, 200)
    ell = ell_from_coo(coo, sort_rows=True)
    counts = coo.row_counts()
    c = np.asarray(ell.colidx)
    for i in range(coo.num_rows):
        k = counts[i]
        row = c[i, :k]
        assert (np.diff(row) >= 0).all()
    csr = csr_from_coo(coo, sort_rows=True)
    rp = np.asarray(csr.rowptr)
    cc = np.asarray(csr.colidx)
    for i in range(coo.num_rows):
        assert (np.diff(cc[rp[i]:rp[i + 1]]) >= 0).all()


def test_symmetric_expansion_counts(rng):
    coo = random_coo(rng, 40, 40, 120, symmetric=True)
    off_diag = int((coo.rowidx != coo.colidx).sum())
    on_diag = coo.num_nonzeros - off_diag
    csr = csr_from_coo(coo)
    # csr_from_coo_size symmetric accounting (csrspmv.c:1240-1248)
    assert csr.csrsize == 2 * off_diag + on_diag


def test_csr_diagsize_square_only(rng):
    coo = random_coo(rng, 20, 30, 50)
    csr = csr_from_coo(coo, separate_diagonal=True)
    assert csr.diag is None and csr.diagsize == 0   # csrspmv.c:1265
    coo2 = random_coo(rng, 20, 20, 50)
    csr2 = csr_from_coo(coo2, separate_diagonal=True)
    assert csr2.diagsize == 20


def test_index_dtype_selection():
    assert select_index_dtype(10, 10, 10) == np.int32
    assert select_index_dtype(2**31, 10, 10) == np.int64
    assert select_index_dtype(10, 10, 2**33) == np.int64
    assert select_index_dtype(10, 10, 10, "int64") == np.int64
    with pytest.raises(OverflowError):
        select_index_dtype(2**31, 10, 10, "int32")
    with pytest.raises(ValueError):
        select_index_dtype(10, 10, 10, "float32")


def test_empty_matrix():
    from ellspmv_jax.formats.coo import CooMatrix
    coo = CooMatrix(4, 4, np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0))
    ell = ell_from_coo(coo)
    assert ell.rowsize == 0
    np.testing.assert_array_equal(ell_spmv_numpy(ell, np.ones(4)),
                                  np.zeros(4))
    csr = csr_from_coo(coo)
    np.testing.assert_array_equal(csr_spmv_numpy(csr, np.ones(4)),
                                  np.zeros(4))


def test_fem_mesh_2d_is_spd_usable():
    """fem_mesh_2d must be numerically symmetric (one value per unordered
    pair) with a dominant diagonal, so CG demos on it are mathematically
    valid."""
    from ellspmv_jax.models.generators import fem_mesh_2d
    coo = fem_mesh_2d(12, 12, extras=3, seed=4)
    a = np.zeros((coo.num_rows, coo.num_columns))
    a[coo.rowidx, coo.colidx] = coo.values
    np.testing.assert_array_equal(a, a.T)
    # strict diagonal dominance => SPD
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    assert (np.diag(a) > off).all()
