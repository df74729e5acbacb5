"""CLI integration tests: the ellspmv/csrspmv programs end-to-end, including
the reference's de facto integration test (identical stdout from both
programs, SURVEY §4)."""

import io
import sys

import numpy as np
import pytest

from ellspmv_jax.cli import csrspmv, ellspmv
from ellspmv_jax.io.mtx import read_vector, write_matrix, write_vector
from tests.conftest import random_coo

MTX = """%%MatrixMarket matrix coordinate real general
4 5 9
1 1 1.5
1 4 1.5
2 2 1
3 3 3
4 1 2
4 2 1
4 3 1
4 4 1
4 5 1
"""


@pytest.fixture
def mtx_file(tmp_path):
    p = tmp_path / "test.mtx"
    p.write_text(MTX)
    return str(p)


def run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("main", [ellspmv.main, csrspmv.main])
def test_golden_output(main, mtx_file, capsys):
    rc, out, err = run_cli(main, [mtx_file], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=1e-14)


def test_ell_equals_csr_stdout(rng, tmp_path, capsys):
    coo = random_coo(rng, 40, 40, 200, with_dups=True)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    _, out_e, _ = run_cli(ellspmv.main, [p], capsys)
    _, out_c, _ = run_cli(csrspmv.main, [p], capsys)
    # Same header/shape; values agree to reduction-order ulp noise (the two
    # programs sum each row in different orders).
    assert out_e.splitlines()[:2] == out_c.splitlines()[:2]
    ye = read_vector(io.BytesIO(out_e.encode()))
    yc = read_vector(io.BytesIO(out_c.encode()))
    from tests.conftest import assert_fp64_close
    assert_fp64_close(ye, yc)


@pytest.mark.parametrize("flags", [
    [], ["--separate-diagonal"], ["--sort-rows"],
    ["--separate-diagonal", "--sort-rows"],
    ["--repeat=3", "--warmup=2"], ["--precision=float32"],
    ["--index-width=64"], ["--format=auto"],
])
def test_flag_combinations(flags, mtx_file, capsys):
    rc, out, err = run_cli(ellspmv.main, flags + [mtx_file], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    tol = 1e-5 if "--precision=float32" in flags else 1e-14
    # y accumulates across warmup AND timed iterations, as in the reference
    # (the warmup loop dispatches the same kernel on the same y,
    # ellspmv.c:1745-1801).
    iters = 1
    for f in flags:
        if f.startswith("--repeat="):
            iters = int(f.split("=")[1])
    for f in flags:
        if f.startswith("--warmup="):
            iters += int(f.split("=")[1])
    np.testing.assert_allclose(y, np.array([3, 1, 3, 6.]) * iters, rtol=tol)


def test_x_and_y_files(mtx_file, tmp_path, capsys):
    xp, yp = str(tmp_path / "x.mtx"), str(tmp_path / "y.mtx")
    write_vector(xp, np.array([1.0, 2.0, 3.0, 4.0, 5.0]))
    write_vector(yp, np.array([100.0, 100.0, 100.0, 100.0]))
    rc, out, _ = run_cli(ellspmv.main, [mtx_file, xp, yp], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    # rows: [1.5,0,0,1.5,0]x=7.5; [0,1,..]x=2; 3*3=9; [2,1,1,1,1]x=16
    np.testing.assert_allclose(y, [107.5, 102, 109, 116], rtol=1e-14)


def test_wrong_vector_length(mtx_file, tmp_path, capsys):
    xp = str(tmp_path / "x.mtx")
    write_vector(xp, np.ones(3))
    rc, _, err = run_cli(ellspmv.main, [mtx_file, xp], capsys)
    assert rc == 1 and "expected vector of length 5" in err


def test_quiet_and_verbose(mtx_file, capsys):
    rc, out, err = run_cli(ellspmv.main, ["-q", "-v", "--repeat=2",
                                          mtx_file], capsys)
    assert rc == 0 and out == ""
    assert "mtxfile_read:" in err
    assert "ell_from_coo:" in err
    assert err.count("gemv:") == 2
    assert "Gnz/s" in err and "Gflop/s" in err and "GB/s" in err


def test_verbose_kernel_names(mtx_file, capsys):
    _, _, err = run_cli(ellspmv.main,
                        ["-q", "-v", "--separate-diagonal", mtx_file], capsys)
    assert "gemvsd:" in err
    _, _, err = run_cli(csrspmv.main, ["-q", "-v", mtx_file], capsys)
    assert "csrgemv:" in err
    _, _, err = run_cli(csrspmv.main,
                        ["-q", "-v", "--partition-nonzeros", "--devices=2",
                         mtx_file], capsys)
    assert "csrgemvnz:" in err


def test_gemv16_kernel_name(tmp_path, rng, capsys):
    # 17 nnz in one row incl. diagonal -> rowsize 16 once diagonal splits
    coo = random_coo(rng, 32, 32, 0)
    rows = np.full(17, 3, np.int32)
    cols = np.arange(17).astype(np.int32)
    import dataclasses
    coo = dataclasses.replace(coo, rowidx=rows, colidx=cols,
                              values=np.ones(17))
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    _, _, err = run_cli(ellspmv.main,
                        ["-q", "-v", "--separate-diagonal", p], capsys)
    assert "gemv16:" in err


def test_sharded_cli(mtx_file, capsys):
    rc, out, err = run_cli(csrspmv.main,
                           ["--devices=4", "-v", "-v", mtx_file], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=1e-14)
    assert "device" in err   # -vv workload table


def test_papi_flags_and_roofline(mtx_file, capsys):
    rc, _, err = run_cli(ellspmv.main,
                         ["-q", "--papi-event-summary", mtx_file], capsys)
    assert rc == 0 and "HBM roofline" in err
    rc, _, err = run_cli(ellspmv.main,
                         ["-q", "--papi-event-summary",
                          "--papi-event-format=csv", mtx_file], capsys)
    assert rc == 0 and "region,repeat,time" in err


def test_gzip_flag(tmp_path, capsys):
    import gzip
    p = str(tmp_path / "m.mtx.gz")
    with gzip.open(p, "wb") as f:
        f.write(MTX.encode())
    rc, out, _ = run_cli(ellspmv.main, ["-z", p], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=1e-14)


def test_usage_without_args(capsys):
    with pytest.raises(SystemExit) as e:
        ellspmv.main([])
    assert e.value.code == 1
    assert "Usage:" in capsys.readouterr().err


def test_help_and_version(capsys):
    with pytest.raises(SystemExit) as e:
        ellspmv.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--separate-diagonal" in out and "--sort-rows" in out
    with pytest.raises(SystemExit):
        csrspmv.main(["--version"])
    assert "csrspmv" in capsys.readouterr().out


def test_bad_option(mtx_file, capsys):
    rc = ellspmv.main(["--bogus", mtx_file])
    assert rc == 1
    assert "unrecognized option" in capsys.readouterr().err


def test_chained_protocol(tmp_path, rng, capsys):
    coo = random_coo(rng, 32, 32, 128)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    rc, out, err = run_cli(ellspmv.main,
                           ["-v", "--protocol=chained", "--repeat=3", p],
                           capsys)
    assert rc == 0 and "gemv:" in err


def test_reorder_rcm_output_equivalent(tmp_path, rng, capsys):
    """--reorder=rcm must not change the printed y (permutation is
    internal: x and y are translated at the edges)."""
    coo = random_coo(rng, 60, 60, 300)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    _, out_plain, _ = run_cli(ellspmv.main, [p], capsys)
    _, out_rcm, _ = run_cli(ellspmv.main, ["--reorder=rcm", p], capsys)
    ya = read_vector(io.BytesIO(out_plain.encode()))
    yb = read_vector(io.BytesIO(out_rcm.encode()))
    from tests.conftest import assert_fp64_close
    assert_fp64_close(yb, ya)


def test_reorder_rejects_rectangular(mtx_file, capsys):
    rc = ellspmv.main(["--reorder=rcm", mtx_file])
    assert rc == 1
    assert "square" in capsys.readouterr().err


def test_per_device_metrics_rows(mtx_file, capsys):
    rc, _, err = run_cli(csrspmv.main,
                         ["-q", "--devices=4", "--papi-event-per-thread",
                          mtx_file], capsys)
    assert rc == 0
    # measured per-shard rows, labeled as such (papi_util.c:672-730
    # measures per thread; round-1 printed static nnz fractions)
    assert "Per-device workload (measured" in err
    assert "ms" in err
    rc, _, err = run_cli(csrspmv.main,
                         ["-q", "--devices=4", "--papi-event-per-thread",
                          "--papi-event-format=csv", mtx_file], capsys)
    assert rc == 0 and "device,rows,nonzeros,measured_s" in err


def test_workload_summary_at_verbose(mtx_file, capsys):
    """verbose>=1 min/max rows+nnz summary (csrspmv.c:2225-2285)."""
    rc, _, err = run_cli(csrspmv.main,
                         ["-q", "-v", "--devices=4", mtx_file], capsys)
    assert rc == 0
    assert "rows per device: min" in err
    assert "nonzeros per device: min" in err


def test_bundled_example_matrix(capsys):
    rc, out, _ = run_cli(ellspmv.main, ["examples/test.mtx"], capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=1e-14)


def test_wrong_y_length(mtx_file, tmp_path, capsys):
    yp = str(tmp_path / "y.mtx")
    write_vector(yp, np.ones(7))
    xp = str(tmp_path / "x.mtx")
    write_vector(xp, np.ones(5))
    rc, _, err = run_cli(ellspmv.main, [mtx_file, xp, yp], capsys)
    assert rc == 1 and "expected vector of length 4" in err


def test_bfloat16_precision(mtx_file, capsys):
    rc, out, _ = run_cli(ellspmv.main, ["--precision=bfloat16", mtx_file],
                         capsys)
    assert rc == 0
    y = read_vector(io.BytesIO(out.encode()))
    np.testing.assert_allclose(y, [3, 1, 3, 6], rtol=0.02)  # bf16 ~2-3 digits


@pytest.mark.parametrize("fmt", ["dia", "sell", "hybrid"])
def test_format_flag(fmt, tmp_path, rng, capsys):
    """--format selects the other formats; stdout y must match the
    default ELL path's golden result."""
    if fmt == "dia":
        # DIA needs few distinct diagonals: a tridiagonal matrix
        n = 12
        rows = np.concatenate([np.arange(n), np.arange(n - 1),
                               np.arange(1, n)]).astype(np.int32)
        cols = np.concatenate([np.arange(n), np.arange(1, n),
                               np.arange(n - 1)]).astype(np.int32)
        vals = rng.rand(len(rows)) + 0.5
        from ellspmv_jax.formats.coo import CooMatrix
        coo = CooMatrix(n, n, rows, cols, vals)
    else:
        coo = random_coo(rng, 40, 40, 220)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    _, out_ref, _ = run_cli(ellspmv.main, [p], capsys)
    rc, out_fmt, err = run_cli(ellspmv.main, [f"--format={fmt}", "-v", p],
                               capsys)
    assert rc == 0, err
    y_ref = read_vector(io.BytesIO(out_ref.encode()))
    y_fmt = read_vector(io.BytesIO(out_fmt.encode()))
    np.testing.assert_allclose(y_fmt, y_ref, rtol=1e-5, atol=1e-5)
    assert f"gemv_{fmt}" in err


def test_format_flag_rejects_unknown(mtx_file, capsys):
    rc, _, err = run_cli(ellspmv.main, ["--format=bogus", mtx_file], capsys)
    assert rc == 1
    assert "--format" in err


def test_format_auto_cli(tmp_path, rng, capsys):
    coo = random_coo(rng, 40, 40, 220)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    _, out_ref, _ = run_cli(ellspmv.main, [p], capsys)
    rc, out_auto, err = run_cli(ellspmv.main, ["--format=auto", "-v", p],
                                capsys)
    assert rc == 0, err
    y_ref = read_vector(io.BytesIO(out_ref.encode()))
    y_auto = read_vector(io.BytesIO(out_auto.encode()))
    np.testing.assert_allclose(y_auto, y_ref, rtol=1e-5, atol=1e-5)
    assert "auto_from_coo" in err


def test_format_auto_honors_sort_rows(rng):
    """--format=auto passes the user's --sort-rows state through instead
    of hardcoding sorted rows (advisor finding, round 1)."""
    from ellspmv_jax.formats.auto import auto_from_coo
    from ellspmv_jax.formats.ell import EllMatrix, ell_from_coo
    from ellspmv_jax.models.generators import banded_random

    coo = banded_random(2000, 8, 64, seed=3)
    unsorted = auto_from_coo(coo, sort_rows=False, value_dtype=np.float64,
                             allow_dia=False)
    assert isinstance(unsorted, EllMatrix)
    ref = ell_from_coo(coo, sort_rows=False, value_dtype=np.float64)
    np.testing.assert_array_equal(np.asarray(unsorted.colidx),
                                  np.asarray(ref.colidx))


def test_conversion_memory_error_clean(mtx_file, capsys, monkeypatch):
    """A padding-blowup OOM during conversion reports cleanly with a
    format hint, like the reference's malloc failure paths
    (ellspmv.c:1418-1424)."""
    from ellspmv_jax.cli import common

    def boom(*a, **k):
        raise MemoryError("Unable to allocate 373. GiB")

    monkeypatch.setattr(common, "_convert", boom)
    rc, _, err = run_cli(ellspmv.main, [mtx_file], capsys)
    assert rc == 1
    assert "conversion failed" in err and "--format=auto" in err


def test_chained_protocol_sharded(tmp_path, rng, capsys):
    """The exact command VERDICT r2 found broken: --devices=N with
    --protocol=chained must benchmark (one labeled slope line) instead of
    exiting 'benchmark failed'."""
    coo = random_coo(rng, 48, 48, 200)
    p = str(tmp_path / "m.mtx")
    write_matrix(p, coo)
    rc, out, err = run_cli(
        ellspmv.main,
        ["-v", "--devices=8", "--protocol=chained", "--repeat=3", p],
        capsys)
    assert rc == 0, err
    assert "benchmark failed" not in err
    assert "slope" in err
    rc2, _, err2 = run_cli(
        csrspmv.main,
        ["-v", "--devices=8", "--protocol=chained", "--repeat=3",
         "--partition-nonzeros", p], capsys)
    assert rc2 == 0, err2
    assert "slope" in err2


def test_per_thread_single_device_note(mtx_file, capsys):
    rc, _, err = run_cli(
        ellspmv.main, ["-q", "--papi-event-per-thread", mtx_file], capsys)
    assert rc == 0
    assert "per-device" in err or "per-thread" in err
