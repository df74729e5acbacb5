"""XLA kernel tests: ELL gather path and CSR segment-sum path vs the NumPy
oracles, in exact fp64 on the CPU backend (1e-14 north-star tolerance)."""

import numpy as np
import pytest

from ellspmv_jax.formats.csr import csr_from_coo
from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.ops import spmv
from ellspmv_jax.ops.csr_xla import csr_spmv_xla
from ellspmv_jax.ops.ell_xla import ell_spmv_xla
from ellspmv_jax.ops.reference import coo_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo


@pytest.mark.parametrize("sep_diag", [False, True])
@pytest.mark.parametrize("shape,nnz", [((64, 64), 400), ((130, 70), 600),
                                       ((70, 130), 600), ((8, 8), 8)])
def test_ell_xla_vs_oracle(rng, sep_diag, shape, nnz):
    n, m = shape
    coo = random_coo(rng, n, m, nnz, with_dups=True)
    x = rng.randn(m)
    y0 = rng.randn(n)
    want = coo_spmv_numpy(coo, x, y0)
    ell = ell_from_coo(coo, separate_diagonal=sep_diag)
    got = np.asarray(ell_spmv_xla(ell, x, y0))
    assert got.shape == (n,)
    assert_fp64_close(got, want)


@pytest.mark.parametrize("sep_diag", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_csr_xla_vs_oracle(rng, sep_diag, symmetric):
    n = 96
    coo = random_coo(rng, n, n, 500, symmetric=symmetric, with_dups=True)
    x = rng.randn(n)
    y0 = rng.randn(n)
    want = coo_spmv_numpy(coo, x, y0)
    csr = csr_from_coo(coo, separate_diagonal=sep_diag)
    got = np.asarray(csr_spmv_xla(csr, x, y0))
    assert_fp64_close(got, want)


def test_ell_equals_csr(rng):
    """The reference's de facto integration test: both programs must print
    identical y for the same matrix (SURVEY §4)."""
    coo = random_coo(rng, 200, 200, 1500, with_dups=True)
    x = rng.randn(200)
    ye = np.asarray(ell_spmv_xla(ell_from_coo(coo), x))
    yc = np.asarray(csr_spmv_xla(csr_from_coo(coo), x))
    assert_fp64_close(ye, yc)


def test_dispatch(rng, small_coo):
    x = np.ones(5)
    y_ell = np.asarray(spmv(ell_from_coo(small_coo), x))
    y_csr = np.asarray(spmv(csr_from_coo(small_coo), x))
    np.testing.assert_allclose(y_ell, [3, 1, 3, 6], rtol=1e-15)
    np.testing.assert_allclose(y_csr, [3, 1, 3, 6], rtol=1e-15)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_value_dtypes(rng, dtype):
    coo = random_coo(rng, 64, 64, 300)
    x = rng.randn(64).astype(dtype)
    ell = ell_from_coo(coo, value_dtype=dtype)
    got = np.asarray(ell_spmv_xla(ell, x))
    want = coo_spmv_numpy(coo, np.asarray(x, np.float64))
    if dtype == "float64":
        assert_fp64_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int64_indices(rng):
    coo = random_coo(rng, 64, 64, 300)
    ell = ell_from_coo(coo, index_dtype="int64")
    assert np.asarray(ell.colidx).dtype == np.int64
    x = rng.randn(64)
    assert_fp64_close(np.asarray(ell_spmv_xla(ell, x)), coo_spmv_numpy(coo, x))
