"""One backend for every format: the structural auto choice, the chained
(jit-argument) form agreeing with the per-iteration one, float32
accumulation of bfloat16 storage, the device table, the compile-cache
placement, and the CLI's refusal of removed options."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ellspmv_jax import config
from ellspmv_jax.bench.harness import benchmark_spmv
from ellspmv_jax.formats.auto import auto_from_coo
from ellspmv_jax.formats.coo import CooMatrix
from ellspmv_jax.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_jax.formats.dia import DiaMatrix, dia_from_coo
from ellspmv_jax.formats.ell import EllMatrix, ell_from_coo
from ellspmv_jax.formats.hybrid import hybrid_from_coo
from ellspmv_jax.formats.sell import sell_from_coo
from ellspmv_jax.models import generators as gen
from ellspmv_jax.ops import spmv
from ellspmv_jax.ops.reference import coo_spmv_numpy, spmv_error
from tests.conftest import random_coo

# --- structural auto choice ------------------------------------------------

AUTO_CASES = [
    ("poisson2d", lambda: gen.poisson2d(20), DiaMatrix),
    ("fem_mesh_2d", lambda: gen.fem_mesh_2d(16), DiaMatrix),
    ("banded_narrow", lambda: gen.banded_random(400, 12, 4, seed=1),
     DiaMatrix),
    ("banded_wide", lambda: gen.banded_random(400, 6, 60, seed=1),
     EllMatrix),
    ("power_law", lambda: gen.power_law(2000, 6, seed=1), CsrMatrix),
    ("dense_rows", lambda: gen.dense_rows(2000, 4, num_dense=3,
                                          dense_nnz=600, seed=1), CsrMatrix),
    ("rectangular", lambda: random_coo(np.random.RandomState(3), 60, 90,
                                       400), EllMatrix),
]


@pytest.mark.parametrize("family,make,want", AUTO_CASES,
                         ids=[c[0] for c in AUTO_CASES])
def test_auto_structural_choice(family, make, want):
    coo = make()
    mat = auto_from_coo(coo, value_dtype=np.float64)
    assert isinstance(mat, want)
    assert mat._auto_choice == {DiaMatrix: "dia", EllMatrix: "ell",
                                CsrMatrix: "csr"}[want]
    x = np.random.RandomState(0).rand(coo.num_columns)
    assert spmv_error(coo, x, spmv(mat.device_put(), x)) <= 1e-12


def test_auto_dia_needs_half_full_diagonals():
    """A few diagonals that are mostly empty are not DIA: 3 diagonals of
    a 1000-row matrix holding 100 entries each are 10% full."""
    rows = np.arange(100, dtype=np.int32) * 10
    coo = CooMatrix(1000, 1000, np.concatenate([rows, rows, rows]),
                    np.concatenate([rows, rows + 1, rows + 2]),
                    np.ones(300))
    assert dia_from_coo(coo) is not None
    assert not isinstance(auto_from_coo(coo), DiaMatrix)


def test_auto_respects_allow_dia_and_separate_diagonal():
    coo = gen.poisson2d(12)
    assert isinstance(auto_from_coo(coo, allow_dia=False), EllMatrix)
    sd = auto_from_coo(coo, separate_diagonal=True)
    assert isinstance(sd, EllMatrix) and sd.diag is not None


# --- the jit-argument (chained/CG) form vs the per-iteration form ----------

TRACE_FORMATS = {
    "ell": lambda c: ell_from_coo(c, sort_rows=True),
    "ell_separate_diagonal": lambda c: ell_from_coo(c,
                                                    separate_diagonal=True),
    "csr": lambda c: csr_from_coo(c),
    "csr_separate_diagonal": lambda c: csr_from_coo(c,
                                                    separate_diagonal=True),
    "sell": lambda c: sell_from_coo(c, slice_rows=64, length_sort=True),
    "hybrid": lambda c: hybrid_from_coo(c, hub_width=128, slice_rows=64),
    "dia": lambda c: dia_from_coo(c),
    "auto": lambda c: auto_from_coo(c),
}


@pytest.mark.parametrize("fmt", sorted(TRACE_FORMATS))
def test_chained_agrees_with_per_iteration(fmt):
    """The chained protocol jits `spmv` with the matrix as a jit ARGUMENT
    and feeds x_{k+1} = 1e-6 * y_k; its result after the timed span must
    equal the same recurrence run with the host oracle."""
    coo = gen.poisson2d(10)
    mat = TRACE_FORMATS[fmt](coo).device_put()
    x0 = np.random.RandomState(4).rand(coo.num_columns)
    res = benchmark_spmv(None, mat, x0, repeat=8, warmup=1,
                         protocol="chained")
    iters = res.span_iters + 1          # the long run is span + warmup
    xk, yk = x0, np.zeros(coo.num_rows)
    for _ in range(iters):
        yk = coo_spmv_numpy(coo, xk, yk)
        xk = yk * 1e-6
    scale = np.max(np.abs(yk))
    np.testing.assert_allclose(np.asarray(res.y), yk, rtol=1e-12,
                               atol=1e-12 * scale)
    # and one jitted application equals one eager application
    y_jit = jax.jit(spmv)(mat, x0, yk)
    np.testing.assert_allclose(np.asarray(y_jit),
                               np.asarray(spmv(mat, x0, yk)),
                               rtol=1e-14, atol=1e-14 * scale)


# --- bfloat16 storage accumulates in float32 -------------------------------

def _long_row_coo():
    """One row of 300 ones: a bfloat16 running sum stalls at 256 (its
    spacing there is 2), a float32 one reaches 300, which bfloat16 holds."""
    n = 300
    rows = np.zeros(n, np.int32)
    cols = np.arange(n, dtype=np.int32)
    return CooMatrix(n, n, rows, cols, np.ones(n))


@pytest.mark.parametrize("fmt", ["ell", "csr", "sell", "dia"])
def test_bfloat16_accumulates_in_float32(fmt):
    coo = _long_row_coo()
    conv = {"ell": ell_from_coo, "csr": csr_from_coo,
            "sell": lambda c, value_dtype: sell_from_coo(
                c, slice_rows=64, split_rows=False, tail_cap=512,
                value_dtype=value_dtype),
            "dia": lambda c, value_dtype: dia_from_coo(
                c, max_diags=512, value_dtype=value_dtype)}[fmt]
    mat = conv(coo, value_dtype=jnp.bfloat16).device_put()
    y = spmv(mat, jnp.ones(300, jnp.bfloat16))
    assert y.dtype == jnp.bfloat16
    assert float(y[0]) == 300.0


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_bfloat16_sharded_accumulates_in_float32(fmt):
    from ellspmv_jax.parallel.spmv import shard_matrix, sharded_spmv_fn
    coo = _long_row_coo()
    conv = ell_from_coo if fmt == "ell" else csr_from_coo
    sm = shard_matrix(conv(coo, value_dtype=jnp.bfloat16), 4)
    y = sharded_spmv_fn(sm)(sm, np.ones(300))
    assert y.dtype == jnp.bfloat16 and float(y[0]) == 300.0


def test_accumulation_dtype():
    assert config.accumulation_dtype(jnp.bfloat16) == np.float32
    assert config.accumulation_dtype(np.float16) == np.float32
    assert config.accumulation_dtype(np.float32) == np.float32
    assert config.accumulation_dtype(np.float64) == np.float64


# --- device table ----------------------------------------------------------

class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_h100_row_resolves():
    assert config.hbm_peak_bytes_per_s(_Dev("NVIDIA H100 80GB HBM3")) \
        == 3.35e12


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200",
                                  "nvidia h100 80gb hbm3"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        config.hbm_peak_bytes_per_s(_Dev(kind))


def test_table_has_no_cpu_row(monkeypatch):
    """Without the tests' placeholder the CPU has no peak at all."""
    monkeypatch.delitem(config.HBM_PEAK_BYTES_PER_S, "cpu")
    with pytest.raises(ValueError):
        config.hbm_peak_bytes_per_s(jax.devices()[0])


def test_no_bandwidth_override_env(monkeypatch):
    monkeypatch.setenv("HBM_PEAK_GBPS", "999")
    assert config.hbm_peak_bytes_per_s(_Dev("NVIDIA H100 80GB HBM3")) \
        == 3.35e12


# --- compile cache placement ------------------------------------------------

def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    want = os.path.join(root, ".jax_cache")
    assert config.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert config.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- removed options fail cleanly ------------------------------------------

@pytest.mark.parametrize("argv,msg", [
    (["--format=stream"], "--format must be"),
    (["--backend=pallas"], "unrecognized option"),
    (["--backend=xla"], "unrecognized option"),
])
def test_removed_cli_options_fail_cleanly(argv, msg, tmp_path, capsys):
    from ellspmv_jax.cli import ellspmv
    p = tmp_path / "m.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 2 1\n1 1 1.0\n")
    assert ellspmv.main(argv + [str(p)]) == 1
    err = capsys.readouterr().err
    assert msg in err and "Traceback" not in err


# --- sharded CG on the virtual mesh ----------------------------------------

@pytest.mark.parametrize("devices", [1, 4])
def test_cgsolve_solve_matches_dense(devices):
    from ellspmv_jax.cli.cgsolve import solve
    coo = gen.poisson2d(12)
    b = np.random.RandomState(2).rand(coo.num_rows)
    res = solve(coo, b, tol=1e-10, maxiter=500, devices=devices)
    want = np.linalg.solve(coo.to_dense(), b)
    np.testing.assert_allclose(np.asarray(res.x), want, rtol=1e-8,
                               atol=1e-8)


def test_cgsolve_sharded_matches_single_device():
    from ellspmv_jax.cli.cgsolve import solve
    coo = gen.fem_mesh_2d(14, seed=2)
    b = np.ones(coo.num_rows)
    one = solve(coo, b, tol=1e-12, maxiter=300)
    four = solve(coo, b, tol=1e-12, maxiter=300, devices=4)
    assert int(one.iterations) == int(four.iterations)
    np.testing.assert_allclose(np.asarray(four.x), np.asarray(one.x),
                               rtol=1e-10)
