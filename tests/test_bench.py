"""Bench harness tests: metric formula parity with the reference, timing
protocols, roofline accounting."""

import numpy as np
import pytest

from ellspmv_jax.bench.harness import BenchResult, SpmvMetrics, benchmark_spmv
from ellspmv_jax.formats.csr import csr_from_coo
from ellspmv_jax.formats.dia import dia_from_coo
from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.formats.sell import sell_from_coo
from ellspmv_jax.models.generators import poisson2d
from ellspmv_jax.ops import spmv
from tests.conftest import assert_fp64_close, random_coo


def test_ell_metric_formulas(small_coo):
    """Exact reproduction of ellspmv.c:1857-1862 for the bundled matrix:
    4x5, 9 nnz, rowsize 5, fp64 + int32."""
    ell = ell_from_coo(small_coo)
    m = SpmvMetrics.for_matrix(ell)
    ellsize, diagsize = 4 * 5, 4
    assert m.num_nonzeros == 9
    assert m.num_flops == 2 * (ellsize + diagsize)
    assert m.min_bytes == 4 * 8 + 5 * 8 + ellsize * 4 + ellsize * 8 \
        + diagsize * 8
    assert m.max_bytes == 4 * 8 + ellsize * 8 + ellsize * 4 + ellsize * 8 \
        + diagsize * 8 + diagsize * 8


def test_csr_metric_formulas(small_coo):
    """csrspmv.c:2882-2887: rowptr bytes counted, diagsize=0 for
    non-square without split."""
    csr = csr_from_coo(small_coo)
    m = SpmvMetrics.for_matrix(csr)
    csrsize = 9
    assert m.num_flops == 2 * csrsize
    assert m.min_bytes == 4 * 8 + 5 * 8 + (4 + 1) * 4 + csrsize * 4 \
        + csrsize * 8
    assert m.max_bytes == 4 * 8 + csrsize * 8 + 4 * 4 + csrsize * 4 \
        + csrsize * 8


def test_metrics_cover_all_formats(rng):
    coo = random_coo(rng, 64, 64, 256)
    for mat in [ell_from_coo(coo), csr_from_coo(coo),
                sell_from_coo(coo, slice_rows=128),
                dia_from_coo(coo, max_diags=1000)]:
        m = SpmvMetrics.for_matrix(mat)
        assert m.num_flops > 0 and m.min_bytes <= m.max_bytes


def test_per_iter_protocol(rng):
    coo = random_coo(rng, 64, 64, 256)
    ell = ell_from_coo(coo)
    x = rng.randn(64)
    res = benchmark_spmv(lambda m, xv, yv: spmv(m, xv, yv), ell, x,
                         repeat=3, warmup=2)
    assert len(res.times) == 3
    # y accumulated over warmup + timed iterations
    from ellspmv_jax.ops.reference import coo_spmv_numpy
    assert_fp64_close(np.asarray(res.y), 5 * coo_spmv_numpy(coo, x))
    lines = res.iteration_lines()
    assert len(lines) == 3 and "Gnz/s" in lines[0]


def test_per_iter_first_iteration_excludes_compile(rng):
    """Iter 1 must report kernel time, not jit compile (VERDICT r3 item 6):
    the harness compiles via untimed dispatches before the timed loop even
    with warmup=0, matching the reference's protocol where warmup is about
    caches, not codegen (ellspmv.c:30-37, 1745-1801). Without the fix,
    iter 1 carried the full compile (~observed 0.996 s vs 0.049 s)."""
    coo = poisson2d(64)
    ell = ell_from_coo(coo, value_dtype=np.float64)
    x = rng.randn(coo.num_columns)
    res = benchmark_spmv(lambda m, xv, yv: spmv(m, xv, yv), ell, x,
                         repeat=3, warmup=0)
    # compile-vs-kernel on CPU is >100x; iter-to-iter noise is far below 50x
    assert res.times[0] < 50 * min(res.times[1:])
    # y semantics unchanged: exactly `repeat` accumulations (the precompile
    # dispatches are discarded)
    from ellspmv_jax.ops.reference import coo_spmv_numpy
    assert_fp64_close(np.asarray(res.y), 3 * coo_spmv_numpy(coo, x))


def test_chained_protocol(rng):
    coo = poisson2d(16)
    ell = ell_from_coo(coo)
    x = np.ones(256)
    res = benchmark_spmv(lambda m, xv, yv: spmv(m, xv, yv), ell, x,
                         repeat=4, warmup=2, protocol="chained")
    assert res.best > 0
    assert res.roofline_fraction() >= 0


def test_chained_requires_square(rng):
    coo = random_coo(rng, 30, 40, 100)
    ell = ell_from_coo(coo)
    with pytest.raises(ValueError):
        benchmark_spmv(lambda m, xv, yv: spmv(m, xv, yv), ell,
                       np.ones(40), protocol="chained")


def test_roofline_fraction_math(monkeypatch):
    from ellspmv_jax import config
    monkeypatch.setitem(config.HBM_PEAK_BYTES_PER_S, "test device", 1e9)
    m = SpmvMetrics(num_nonzeros=10, num_flops=20, min_bytes=1000,
                    max_bytes=2000)
    dev = type("Dev", (), {"device_kind": "test device"})()
    r = BenchResult(times=[1e-6], metrics=m, y=None, protocol="per_iter",
                    device=dev)
    assert r.min_gb_per_s() == pytest.approx(1.0)
    assert r.roofline_fraction() == pytest.approx(1.0)


def test_chained_passes_matrix_as_argument(rng):
    """Chained protocol with spmv_fn=None jits the library dispatch with
    the matrix as a jit ARGUMENT (every format is a pytree), so the loop
    result matches the per-iteration oracle."""
    coo = poisson2d(16)
    ell = ell_from_coo(coo, sort_rows=True, value_dtype=np.float64)
    res = benchmark_spmv(None, ell, np.ones(256), repeat=3, warmup=1,
                         protocol="chained")
    assert res.best > 0 and res.span_iters >= 8
    y = np.asarray(res.y)
    assert y.dtype == np.float64 and np.isfinite(y).all()


def test_actual_traffic_accounting():
    """Stored-bytes accounting: format arrays + x once + y read/write.
    DIA stores no indices, so it moves fewer bytes than ELL on a stencil."""
    from ellspmv_jax.bench.traffic import estimate_actual_bytes

    coo = poisson2d(32)
    n = coo.num_rows
    ell = ell_from_coo(coo, value_dtype=np.float64)
    want = ell.colidx.nbytes + ell.values.nbytes + 3 * n * 8
    assert estimate_actual_bytes(ell) == want
    dia = dia_from_coo(coo, value_dtype=np.float64)
    assert estimate_actual_bytes(dia) == dia.data.nbytes + 3 * n * 8
    assert estimate_actual_bytes(dia) < estimate_actual_bytes(ell)
    res = benchmark_spmv(None, ell, np.ones(n), repeat=2, warmup=1,
                         protocol="chained")
    assert res.actual_bytes == want and res.actual_gb_per_s() > 0


def test_copy_bandwidth_refuses_cpu():
    """The copy measurement needs a GPU: on the CPU it raises instead of
    reporting a host number (or a nominal peak) as a device rate."""
    from ellspmv_jax.bench.stream import measure_copy_bandwidth
    with pytest.raises(RuntimeError, match="needs a GPU"):
        measure_copy_bandwidth(size_mb=1, iters=2)


@pytest.mark.parametrize("fmt", ["csr", "sell", "hybrid"])
def test_actual_traffic_other_formats(fmt):
    """Every format has a stored-bytes count at least as large as its
    values array plus x and y."""
    from ellspmv_jax.bench.traffic import estimate_actual_bytes
    from ellspmv_jax.formats.hybrid import hybrid_from_coo
    from ellspmv_jax.models.generators import power_law

    coo = power_law(2000, 5, seed=4)
    conv = {"csr": csr_from_coo,
            "sell": lambda c: sell_from_coo(c, slice_rows=128),
            "hybrid": lambda c: hybrid_from_coo(c, slice_rows=128)}[fmt]
    mat = conv(coo)
    assert estimate_actual_bytes(mat) >= \
        coo.num_nonzeros * 8 + 3 * coo.num_rows * 8
