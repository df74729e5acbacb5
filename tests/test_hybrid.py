"""Hub-column hybrid tests (power-law matrices, configs[3])."""

import numpy as np

from ellspmv_jax.formats.hybrid import hybrid_from_coo, hybrid_spmv
from ellspmv_jax.models.generators import power_law
from ellspmv_jax.ops.reference import coo_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo


def test_hub_split_correct(rng):
    coo = power_law(4000, 8, seed=1)
    hm = hybrid_from_coo(coo, hub_width=512, slice_rows=256, tail_cap=16)
    assert hm.hub is not None
    assert 0.2 < hm.hub_nnz_fraction < 0.95
    x = rng.randn(4000)
    y0 = rng.randn(4000)
    got = np.asarray(hybrid_spmv(hm, x, y0))
    assert_fp64_close(got, coo_spmv_numpy(coo, x, y0))


def test_hub_disabled_when_uniform(rng):
    coo = random_coo(rng, 2000, 2000, 8000)
    hm = hybrid_from_coo(coo, hub_width=128)
    assert hm.hub is None          # uniform degrees: hub not profitable
    x = rng.randn(2000)
    assert_fp64_close(np.asarray(hybrid_spmv(hm, x)),
                      coo_spmv_numpy(coo, x))


def test_traceable_hybrid(rng):
    """The hybrid is a pytree: spmv traces inside an outer jit with the
    matrix data passed as jit arguments, in exact fp64."""
    import jax
    from ellspmv_jax.ops import spmv
    coo = power_law(1200, 4, seed=3)
    hm = hybrid_from_coo(coo, hub_width=256, slice_rows=128, tail_cap=8,
                         value_dtype=np.float64).device_put()
    x = rng.randn(1200)
    got = np.asarray(jax.jit(spmv)(hm, np.asarray(x)))
    assert_fp64_close(got, coo_spmv_numpy(coo, x))


def test_metrics(rng):
    from ellspmv_jax.bench.harness import SpmvMetrics
    coo = power_law(2000, 6, seed=4)
    hm = hybrid_from_coo(coo, hub_width=256, slice_rows=256)
    m = SpmvMetrics.for_matrix(hm)
    assert m.num_flops > 0 and m.min_bytes < m.max_bytes
