"""Multi-device tests on the virtual 8-device CPU mesh: row sharding,
nonzero-balanced and explicit partitions, allgather-of-x correctness."""

import jax
import numpy as np
import pytest

from ellspmv_jax.formats.csr import csr_from_coo
from ellspmv_jax.formats.ell import ell_from_coo
from ellspmv_jax.ops.reference import coo_spmv_numpy
from ellspmv_jax.parallel.spmv import shard_matrix, sharded_spmv_fn
from tests.conftest import assert_fp64_close, random_coo

NDEV = len(jax.devices())


@pytest.fixture(autouse=True)
def need_devices():
    if NDEV < 2:
        pytest.skip("needs multiple devices")


@pytest.mark.parametrize("fmt", ["ell", "csr"])
@pytest.mark.parametrize("sep_diag", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (100, 52), (53, 101)])
def test_sharded_matches_oracle(rng, fmt, sep_diag, shape):
    n, m = shape
    coo = random_coo(rng, n, m, 4 * n, with_dups=True)
    x = rng.randn(m)
    y0 = rng.randn(n)
    want = coo_spmv_numpy(coo, x, y0)
    conv = ell_from_coo if fmt == "ell" else csr_from_coo
    mat = conv(coo, separate_diagonal=sep_diag)
    sm = shard_matrix(mat, 4)
    fn = sharded_spmv_fn(sm)
    got = np.asarray(fn(sm, x, y0))
    assert got.shape == (n,)
    assert_fp64_close(got, want)


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_partition_nonzeros(rng, fmt):
    n = 96
    # skewed: first rows dense, rest sparse
    coo = random_coo(rng, n, n, 800, with_dups=True)
    conv = ell_from_coo if fmt == "ell" else csr_from_coo
    mat = conv(coo)
    sm = shard_matrix(mat, 4, partition="nonzeros")
    assert sm.boundaries[0] == 0 and sm.boundaries[-1] == n
    assert (np.diff(sm.boundaries) >= 0).all()
    x = rng.randn(n)
    got = np.asarray(sharded_spmv_fn(sm)(sm, x))
    assert_fp64_close(got, coo_spmv_numpy(coo, x))


def test_explicit_rows_per_device(rng):
    n = 64
    coo = random_coo(rng, n, n, 300)
    mat = ell_from_coo(coo)
    sm = shard_matrix(mat, 4, rows_per_device=[10, 30, 20, 4])
    np.testing.assert_array_equal(sm.boundaries, [0, 10, 40, 60, 64])
    x = np.random.RandomState(7).randn(n)
    assert_fp64_close(np.asarray(sharded_spmv_fn(sm)(sm, x)),
                      coo_spmv_numpy(coo, x))
    with pytest.raises(ValueError):
        shard_matrix(mat, 4, rows_per_device=[10, 30, 20, 5])  # bad sum
    with pytest.raises(ValueError):
        shard_matrix(mat, 4, rows_per_device=[10, 30, 24])     # wrong len


def test_workload_report(rng):
    coo = random_coo(rng, 64, 64, 400, with_dups=True)
    sm = shard_matrix(ell_from_coo(coo), 4)
    rep = sm.workload_report()
    assert len(rep) == 5
    sm2 = shard_matrix(csr_from_coo(coo), 4, partition="nonzeros")
    rep2 = sm2.workload_report()
    nnz = [int(line.split()[2]) for line in rep2[1:]]
    # sums to the logical entry count (base.csrsize includes SPMD padding)
    assert sum(nnz) == int(np.asarray(sm2.base.rowptr)[-1])


def test_accumulate_chain(rng):
    """y := A*x + y applied twice equals dense twice (sharded)."""
    n = 48
    coo = random_coo(rng, n, n, 200)
    sm = shard_matrix(ell_from_coo(coo), 4)
    fn = sharded_spmv_fn(sm)
    x = rng.randn(n)
    y1 = fn(sm, x)
    y2 = np.asarray(fn(sm, x, y1))
    assert_fp64_close(y2, 2 * coo_spmv_numpy(coo, x))


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_sharded_chained_protocol(rng, fmt):
    """VERDICT r2 item 1: `ellspmv --devices=N --protocol=chained` crashed
    with `ShardedMatrix ... not a valid JAX type` — the harness's chained
    branch jitted the non-pytree matrix. The sharded fn exposes a
    `.traceable = (operand, fn)` form, so the chained loop passes only
    arrays through jit (the reference's timed
    loop works under every partition flag, ellspmv.c:1821-1876)."""
    from ellspmv_jax.bench.harness import benchmark_spmv
    from ellspmv_jax.formats.csr import csr_from_coo

    n = 96
    coo = random_coo(rng, n, n, 700, with_dups=True)
    conv = ell_from_coo if fmt == "ell" else csr_from_coo
    mat = conv(coo)
    sm = shard_matrix(mat, 4)
    fn = sharded_spmv_fn(sm)
    assert hasattr(fn, "traceable")
    # the traceable form itself computes the right thing under jit
    operand, tfn = fn.traceable
    import jax
    import jax.numpy as jnp
    x = rng.rand(n)
    y0 = rng.randn(n)
    got = np.asarray(jax.jit(tfn)(operand, jnp.asarray(x),
                                  jnp.asarray(y0)))
    assert_fp64_close(got, coo_spmv_numpy(coo, x, y0))
    # and the chained protocol runs without crashing, reporting one
    # labeled slope line (not `repeat` synthetic copies)
    res = benchmark_spmv(fn, sm, x, repeat=3, warmup=1,
                         protocol="chained", metrics_matrix=mat)
    assert res.best > 0 and res.span_iters >= 3
    lines = res.iteration_lines()
    assert len(lines) == 1 and "slope" in lines[0]
    assert np.isfinite(np.asarray(res.y)).all()
