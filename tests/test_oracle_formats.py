"""Every SpMV format against the exact fp64 host oracle, over every matrix
family and storage precision, with y accumulation (y := A*x + y).

Each format has one XLA implementation, so this grid is the whole
correctness surface of the single-device kernels. Inputs are rounded to
the storage dtype first and the oracle runs on the rounded values in
fp64, so the tolerance measures the kernel's accumulation and output
rounding only: per row, against the row's sum of |a_ij x_j| + |y_i|
(ops/reference.py spmv_error).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ellspmv_jax.formats.auto import auto_from_coo
from ellspmv_jax.formats.csr import csr_from_coo
from ellspmv_jax.formats.dia import dia_from_coo
from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.formats.hybrid import hybrid_from_coo
from ellspmv_jax.formats.sell import sell_from_coo
from ellspmv_jax.models import generators as gen
from ellspmv_jax.ops import spmv
from ellspmv_jax.ops.reference import spmv_error
from tests.conftest import random_coo

# storage dtype -> per-row tolerance (fp64: ~100 ulp of a reordered sum;
# float32: f32 accumulation; bfloat16: f32 accumulation, bf16 output)
PRECISIONS = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-2}


def _family(name):
    if name == "poisson2d":
        return gen.poisson2d(13)
    if name == "fem_mesh_2d":
        return gen.fem_mesh_2d(12, seed=3)
    if name == "banded_random":
        return gen.banded_random(180, 5, 6, seed=2)       # 13 diagonals
    if name == "power_law":
        return gen.power_law(300, 5, seed=1)
    if name == "dense_rows":
        return gen.dense_rows(256, 4, num_dense=2, dense_nnz=150, seed=4)
    if name == "rectangular":
        return random_coo(np.random.RandomState(5), 70, 110, 500,
                          with_dups=True)
    raise ValueError(name)


FAMILIES = ["poisson2d", "fem_mesh_2d", "banded_random", "power_law",
            "dense_rows", "rectangular"]
# DIA stores at most 32 diagonals: only the stencil/banded families fit
DIA_FAMILIES = {"poisson2d", "fem_mesh_2d", "banded_random"}

CONVERTERS = {
    "ell": lambda c, dt: ell_from_coo(c, value_dtype=dt),
    "ell_separate_diagonal": lambda c, dt: ell_from_coo(
        c, separate_diagonal=True, sort_rows=True, value_dtype=dt),
    "csr": lambda c, dt: csr_from_coo(c, value_dtype=dt),
    "csr_separate_diagonal": lambda c, dt: csr_from_coo(
        c, separate_diagonal=True, value_dtype=dt),
    "sell": lambda c, dt: sell_from_coo(c, slice_rows=64, length_sort=True,
                                        value_dtype=dt),
    "hybrid": lambda c, dt: hybrid_from_coo(c, hub_width=128,
                                            slice_rows=64, value_dtype=dt),
    "dia": lambda c, dt: dia_from_coo(c, value_dtype=dt),
    "auto": lambda c, dt: auto_from_coo(c, value_dtype=dt),
}

CASES = [(fmt, fam, prec)
         for fmt in CONVERTERS for fam in FAMILIES for prec in PRECISIONS
         if fmt != "dia" or fam in DIA_FAMILIES]


def _rounded(a, dtype):
    """`a` stored in `dtype`, read back as fp64 (what the kernel sees)."""
    return np.asarray(np.asarray(a).astype(dtype), np.float64)


@pytest.mark.parametrize("fmt,family,precision", CASES)
def test_format_matches_oracle(fmt, family, precision):
    dtype = jnp.dtype(precision)
    coo = _family(family)
    rng = np.random.RandomState(7)
    coo = dataclasses.replace(coo, values=_rounded(coo.values, dtype))
    x = _rounded(rng.randn(coo.num_columns), dtype)
    y0 = _rounded(rng.randn(coo.num_rows), dtype)

    mat = CONVERTERS[fmt](coo, dtype)
    assert mat is not None
    got = spmv(mat.device_put(), jnp.asarray(x, dtype),
               jnp.asarray(y0, dtype))
    assert got.shape == (coo.num_rows,)
    assert got.dtype == dtype
    assert spmv_error(coo, x, got, y=y0) <= PRECISIONS[precision]


def test_grid_covers_every_format_and_family():
    """The grid is built from valid combinations only (a skip would count
    no pass): every format appears, and DIA only where it fits."""
    assert {c[0] for c in CASES} == set(CONVERTERS)
    for fam in FAMILIES:
        fits = dia_from_coo(_family(fam)) is not None
        assert fits == (fam in DIA_FAMILIES)
