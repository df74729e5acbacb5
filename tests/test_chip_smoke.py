"""chip_smoke.py: its refusal without a GPU, its last-line contract, and
its phases (oracle checks included) at tiny sizes on the CPU. The script
itself runs on the card: ``python chip_smoke.py`` (``--four`` on four)."""

import io
import json
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from ellspmv_jax.cli import csrspmv, ellspmv  # noqa: E402
from ellspmv_jax.models import generators as gen  # noqa: E402


@pytest.fixture
def log():
    out = io.StringIO()
    return chip_smoke.Log("cpu", "no card", stream=out)


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DATA", str(tmp_path))


def test_refuses_without_gpu(capsys):
    assert jax.devices()[0].platform != "gpu"
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


def test_bench_refuses_without_gpu(capsys):
    assert bench.main() == 1
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("four", [False, True])
def test_last_line_contract(four, monkeypatch, capsys):
    """With every phase passing, stdout ends in exactly one JSON object
    naming the device as JAX reports it; the card line comes before it."""
    ran = []
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()] * 4
                        if four else [_FakeGpu()])
    monkeypatch.setattr(chip_smoke, "card_description",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "single_card", lambda log: ran.append(1))
    monkeypatch.setattr(chip_smoke, "four_cards", lambda log: ran.append(4))
    assert chip_smoke.main(["--four"] if four else []) == 0
    assert ran == [4 if four else 1]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": 4 if four else 1}}
    assert all("700.00 W" in line for line in lines[:-1])


def test_failed_phase_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()])
    monkeypatch.setattr(chip_smoke, "card_description", lambda: "card")

    def fail(log):
        raise chip_smoke.SmokeFailure("boom")

    monkeypatch.setattr(chip_smoke, "single_card", fail)
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out and "FAILED: boom" in err


def test_check_raises_above_tolerance(log):
    chip_smoke.check("fine", 1e-13, 1e-12, log)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check("off", 2e-12, 1e-12, log)
    assert "PASS" in log.stream.getvalue()
    assert "FAIL" in log.stream.getvalue()


@pytest.mark.parametrize("family", ["fem_mesh_2d", "power_law",
                                    "dense_rows"])
def test_spmv_phase_checks_oracle(family, log):
    coo = {"fem_mesh_2d": lambda: gen.fem_mesh_2d(16),
           "power_law": lambda: gen.power_law(800, 5, seed=0),
           "dense_rows": lambda: gen.dense_rows(800, 4, num_dense=2,
                                                dense_nnz=200, seed=0)
           }[family]()
    rates = chip_smoke.spmv_phase(family, coo, log, [
        ("ellspmv --format=auto", ellspmv.main, ["--format=auto"]),
        ("csrspmv", csrspmv.main, []),
        ("ellspmv --format=sell", ellspmv.main, ["--format=sell"]),
    ], repeat=2, warmup=1)
    assert len(rates) == 3
    text = log.stream.getvalue()
    assert text.count("PASS") == 3 and "FAIL" not in text
    assert "auto chose" in text


def test_spmv_phase_catches_a_wrong_result(log, monkeypatch):
    """A kernel that returns a wrong y fails the phase."""
    from ellspmv_jax.cli import common

    real = common.execute

    def wrong(opts, coo, csr):
        rc, y = real(opts, coo, csr)
        return rc, np.asarray(y) * (1 + 1e-9)

    monkeypatch.setattr(common, "execute", wrong)
    with pytest.raises(chip_smoke.SmokeFailure, match="error"):
        chip_smoke.spmv_phase("fem", gen.fem_mesh_2d(10), log, [
            ("ellspmv", ellspmv.main, [])], repeat=1, warmup=0)


def test_dia_fusions_counts_kernels():
    assert chip_smoke.dia_fusions(gen.fem_mesh_2d(12)) >= 1


def test_cg_phase(log):
    chip_smoke.cg_phase(12, log)
    assert "PASS" in log.stream.getvalue()


def test_four_cards_on_virtual_mesh(log):
    chip_smoke.four_cards(log, nx=12)
    text = log.stream.getvalue()
    assert "FAIL" not in text
    assert text.count("PASS") == 5 + 2          # five SpMV runs, two CGs
    assert "--partition-nonzeros --devices=4" in text
    assert text.count("peak_bytes_in_use") == 4
