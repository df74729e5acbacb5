"""Tests that need an NVIDIA GPU. They skip elsewhere (the `gpu` fixture
decides at run time); on the card run ``python -m pytest tests -m gpu``."""

import numpy as np
import pytest

from ellspmv_jax.models import generators as gen
from ellspmv_jax.ops import spmv
from ellspmv_jax.ops.reference import spmv_error

pytestmark = pytest.mark.gpu


def test_device_kind_has_a_published_peak(gpu):
    from ellspmv_jax.config import hbm_peak_bytes_per_s
    assert hbm_peak_bytes_per_s(gpu) > 1e12


def test_copy_bandwidth_is_plausible(gpu):
    from ellspmv_jax.bench.stream import measure_copy_bandwidth
    from ellspmv_jax.config import hbm_peak_bytes_per_s
    bw = measure_copy_bandwidth(size_mb=256, iters=16)
    assert 0.3 * hbm_peak_bytes_per_s(gpu) < bw


@pytest.mark.parametrize("fmt", ["ell", "csr", "dia", "sell", "hybrid",
                                 "auto"])
def test_formats_match_oracle_on_card(gpu, fmt):
    """fp64 on the card: sums run in another order than on the CPU (and
    scatter-adds in a varying one), so the check is per row against the
    row's sum of |a_ij x_j|, 1e-12."""
    from tests.test_oracle_formats import CONVERTERS
    coo = gen.fem_mesh_2d(64)
    x = np.random.RandomState(0).rand(coo.num_columns)
    y0 = np.random.RandomState(1).rand(coo.num_rows)
    mat = CONVERTERS[fmt](coo, np.float64).device_put()
    assert spmv_error(coo, x, spmv(mat, x, y0), y=y0) <= 1e-12
