"""Tests for the derived-metric file machinery (papi_util analogue)."""

import io

import pytest

from ellspmv_jax.bench import metrics as M


def test_parse_formula():
    f = M.parse_formula("MemBW [GB/s] = (a + b) * 256 / time")
    assert f.name == "MemBW" and f.unit == "GB/s"
    assert f.expr.evaluate({"a": 1, "b": 3, "time": 2}) == 512.0


def test_precedence_and_unary():
    e = M._Parser(M._tokenize("1 + 2 * 3 - 4 / 2")).parse()
    assert e.evaluate({}) == 5.0
    e = M._Parser(M._tokenize("-(3) + 2 * (1 + 1)")).parse()
    assert e.evaluate({}) == 1.0


def test_case_insensitive_time():
    f = M.parse_formula("X = flops / Time")
    assert f.expr.evaluate({"flops": 10, "time": 2}) == 5.0


def test_unknown_event():
    f = M.parse_formula("X = BOGUS_COUNTER / time")
    with pytest.raises(M.MetricsError):
        f.expr.evaluate({"time": 1.0})


def test_read_metrics_file():
    txt = """# comment
nnz
flops
Formulas:
T [Gnz/s] = nnz / time / 1e9
"""
    mf = M.read_metrics_file(io.StringIO(txt))
    assert mf.events == ["nnz", "flops"]
    assert len(mf.formulas) == 1
    assert mf.formulas[0].expr.evaluate({"nnz": 2e9, "time": 1.0}) == 2.0


def test_example_file_end_to_end(tmp_path, capsys):
    from ellspmv_jax.cli import ellspmv
    mtx = tmp_path / "m.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 2\n1 1 2\n2 2 3\n")
    rc = ellspmv.main(["-q", "--papi-event-file=examples/membw.metrics",
                       str(mtx)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "Throughput" in err and "Roofline" in err
    rc = ellspmv.main(["-q", "--papi-event-file=examples/membw.metrics",
                       "--papi-event-format=csv", str(mtx)])
    assert rc == 0
    err = capsys.readouterr().err
    assert err.startswith("region,")


def test_bad_metrics_file(tmp_path, capsys):
    from ellspmv_jax.cli import ellspmv
    mtx = tmp_path / "m.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "1 1 1\n1 1 1\n")
    bad = tmp_path / "bad.metrics"
    bad.write_text("Formulas:\nX = )broken(\n")
    rc = ellspmv.main(["-q", f"--papi-event-file={bad}", str(mtx)])
    assert rc == 1
