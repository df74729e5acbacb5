"""DIA format tests: conversion, shifted-stream SpMV vs oracle, fallback."""

import numpy as np

from ellspmv_jax.formats.dia import dia_from_coo, dia_spmv
from ellspmv_jax.models.generators import poisson2d
from ellspmv_jax.ops.reference import coo_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo


def test_poisson_dia():
    coo = poisson2d(16)
    dia = dia_from_coo(coo)
    assert dia is not None
    assert dia.num_diags == 5
    assert dia.offsets == (-16, -1, 0, 1, 16)
    x = np.random.RandomState(0).randn(coo.num_rows)
    assert_fp64_close(np.asarray(dia_spmv(dia, x)), coo_spmv_numpy(coo, x))


def test_dia_accumulate_and_rect():
    rng = np.random.RandomState(3)
    coo = random_coo(rng, 40, 50, 120)
    dia = dia_from_coo(coo, max_diags=200)
    assert dia is not None
    x = rng.randn(50)
    y0 = rng.randn(40)
    assert_fp64_close(np.asarray(dia_spmv(dia, x, y0)),
                      coo_spmv_numpy(coo, x, y0))
    coo2 = random_coo(rng, 50, 40, 120)
    dia2 = dia_from_coo(coo2, max_diags=200)
    x2 = rng.randn(40)
    assert_fp64_close(np.asarray(dia_spmv(dia2, x2)),
                      coo_spmv_numpy(coo2, x2))


def test_dia_rejects_wide():
    rng = np.random.RandomState(0)
    coo = random_coo(rng, 200, 200, 2000)
    assert dia_from_coo(coo, max_diags=16) is None


def test_dia_symmetric_and_dups():
    rng = np.random.RandomState(1)
    coo = random_coo(rng, 30, 30, 80, symmetric=True, with_dups=True)
    dia = dia_from_coo(coo, max_diags=100)
    x = rng.randn(30)
    assert_fp64_close(np.asarray(dia_spmv(dia, x)), coo_spmv_numpy(coo, x))
