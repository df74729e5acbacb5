"""Smoke run of the SpMV main path on one NVIDIA GPU (or four with --four).

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded paths on four cards

One card drives every user entry point once at full size and checks each
result against the exact fp64 host oracle (`ops/reference.py`):

- copy:  the device-memory copy rate every SpMV rate is read against;
- spmv:  `fem_mesh_2d(1440)` (2.07M rows, 32.3M nnz, the bench.py headline)
         written as Matrix Market and run through `ellspmv --format=auto`,
         `ellspmv --format=ell` and `csrspmv` (`main`, in-process);
- skewed: `power_law(1M, 7)` and `dense_rows` at the suite's 1M size through
         `ellspmv --format=auto`, `csrspmv` and `ellspmv --format=sell`;
- cg:    `cgsolve` on `poisson2d(512)` in fp64 to tol 1e-8, residual
         recomputed on the host;
- bench: `bench.py`'s JSON line.

`--four` runs only the sharded paths on four cards, on the reference's own
matrix class (Lynx68: `fem_mesh_2d(2610, 2610, extras=5, seed=1)`, 6.81M
rows, ~115M nnz, built in memory): `ellspmv --devices=4`, `csrspmv
--devices=4` with `--partition-rows` and `--partition-nonzeros`, and
`cgsolve --devices=4`, each beside the same run on one card.

Tolerances: fp64 rows must agree within 1e-12 of their sum of |a_ij x_j|
(about 100 ulp for rows of <=30 terms summed in another order). Every
number printed carries the device kind and the card's name and power
limit. The last line of stdout is one JSON object; it is printed only when
every phase passed. Without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "smoke_data")
RTOL_F64 = 1e-12
CG_TOL = 1e-8


class SmokeFailure(RuntimeError):
    pass


def card_description() -> str:
    """`nvidia-smi` name and power limit of every card, read in a child
    process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


class Log:
    """Prints result lines tagged with the device and card."""

    def __init__(self, kind: str, card: str, stream=sys.stdout):
        self.tag = f"[{kind} | {card}]"
        self.stream = stream
        self.t0 = time.perf_counter()

    def __call__(self, msg: str) -> None:
        self.stream.write(f"{time.perf_counter() - self.t0:7.1f}s {msg} "
                          f"{self.tag}\n")
        self.stream.flush()


def check(name: str, err: float, tol: float, log: Log) -> None:
    ok = err <= tol
    log(f"{name}: max row error {err:.3e} (limit {tol:g}) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: error {err:.3e} above {tol:g}")


_BEST = re.compile(r"best time: ([0-9.eE+-]+) s")
_STORED = re.compile(r"stored traffic: ([0-9,]+) bytes/iter")
_CHOICE = re.compile(r"auto_from_coo \[(\w+)\]: ([0-9.]+) seconds, .*?, "
                     r"[0-9,]+ nonzeros, (.*)")


def run_cli(main, argv, label: str, out_path: str | None = None) -> str:
    """Run a CLI `main(argv)` in-process with stdout sent to `out_path`;
    return its stderr."""
    err = io.StringIO()
    out = open(out_path, "w") if out_path else io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        out.close()
    if rc != 0:
        sys.stderr.write(err.getvalue())
        raise SmokeFailure(f"{label}: exit code {rc}")
    return err.getvalue()


def report_rate(text: str, label: str, log: Log):
    """Log the best iteration time (and the stored-bytes rate, when the
    run printed --papi-event-summary) from a CLI's stderr; return
    (seconds, GB/s or None)."""
    t = float(_BEST.search(text).group(1))
    stored = _STORED.search(text)
    gbps = int(stored.group(1).replace(",", "")) / t / 1e9 if stored else None
    choice = _CHOICE.search(text)
    log(f"{label}: best {t * 1e3:.6f} ms/iter"
        + ("" if gbps is None else f", {gbps:.1f} GB/s of stored bytes")
        + (f", auto chose {choice.group(1)} ({choice.group(3)})"
           if choice else ""))
    return t, gbps


def spmv_phase(name: str, coo, log: Log, runs, repeat: int = 10,
               warmup: int = 2, seed: int = 1) -> dict:
    """Write `coo` and a random x as Matrix Market and run each
    (label, main, flags) of `runs` on them twice: per iteration, with y
    (accumulated over warmup + repeat iterations) checked against the
    oracle, then chained, for the device time. Returns {label: (seconds,
    stored-bytes GB/s)}."""
    from ellspmv_jax.io.mtx import read_vector, write_matrix, write_vector
    from ellspmv_jax.ops.reference import spmv_error

    os.makedirs(DATA, exist_ok=True)
    a_path = os.path.join(DATA, f"{name}.mtx")
    x_path = os.path.join(DATA, f"{name}_x.mtx")
    y_path = os.path.join(DATA, f"{name}_y.mtx")
    t0 = time.perf_counter()
    write_matrix(a_path, coo)
    write_vector(x_path, np.random.RandomState(seed).rand(coo.num_columns),
                 precision=17)
    x = read_vector(x_path)
    log(f"{name}: {coo.num_rows:,} rows, {coo.num_nonzeros:,} nnz written "
        f"in {time.perf_counter() - t0:.1f} s")
    rates = {}
    for label, main, flags in runs:
        # per-iteration protocol: y accumulates warmup + repeat products,
        # checked against the oracle
        argv = flags + [f"--repeat={repeat}", f"--warmup={warmup}", "-v",
                        a_path, x_path]
        text = run_cli(main, argv, f"{name} {label}", y_path)
        check(f"{name} {label}",
              spmv_error(coo, x, read_vector(y_path), times=repeat + warmup),
              RTOL_F64, log)
        # chained protocol: device time per SpMV (slope of two in-jit loop
        # lengths, no per-iteration dispatch), read against the copy
        text = run_cli(main, flags + ["--protocol=chained", "-q", "-v",
                                      "--papi-event-summary", a_path, x_path],
                       f"{name} {label} chained")
        rates[f"{name} {label}"] = report_rate(
            text, f"{name} {label} (chained)", log)
    return rates


def dia_fusions(coo) -> int:
    """Kernels XLA emits for one DIA SpMV of `coo` (one fused pass over the
    diagonals is the expectation)."""
    import jax
    import jax.numpy as jnp

    from ellspmv_jax.formats.dia import _dia_spmv, dia_from_coo

    dia = dia_from_coo(coo)
    x = jnp.zeros(dia.num_columns, dia.data.dtype)
    text = _dia_spmv.lower(jnp.asarray(dia.data), x, None, dia.offsets,
                           dia.num_rows, dia.num_columns
                           ).compile().as_text()
    entry = text[text.index("ENTRY"):]
    return entry.count(" fusion(")


def cg_phase(nx: int, log: Log) -> None:
    """`cgsolve` on poisson2d(nx): fp64, tol CG_TOL; the true residual is
    recomputed on the host."""
    from ellspmv_jax.cli import cgsolve
    from ellspmv_jax.io.mtx import read_vector, write_matrix
    from ellspmv_jax.models.generators import poisson2d
    from ellspmv_jax.ops.reference import coo_spmv_numpy

    coo = poisson2d(nx)
    os.makedirs(DATA, exist_ok=True)
    a_path = os.path.join(DATA, f"poisson{nx}.mtx")
    x_path = os.path.join(DATA, f"poisson{nx}_cg_x.mtx")
    write_matrix(a_path, coo)
    text = run_cli(cgsolve.main,
                   [f"--tol={CG_TOL}", "--maxiter=20000", "-v", a_path],
                   f"cgsolve poisson2d({nx})", x_path)
    x = read_vector(x_path)
    b = np.ones(coo.num_rows)
    rel = (np.linalg.norm(b - coo_spmv_numpy(coo, x)) / np.linalg.norm(b))
    line = text.strip().splitlines()[-1]
    # cgsolve's own acceptance: 10x the requested tolerance
    ok = rel <= 10 * CG_TOL
    log(f"cgsolve poisson2d({nx}): {line}; host residual {rel:.3e} "
        f"(limit {10 * CG_TOL:g}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"cg residual {rel:.3e}")


def bench_phase(log: Log) -> None:
    sys.path.insert(0, ROOT)
    import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main()
    if rc != 0:
        raise SmokeFailure(f"bench.py: exit code {rc}")
    log(f"bench.py: {out.getvalue().strip().splitlines()[-1]}")


def single_card(log: Log) -> None:
    """Every phase of the one-card run, at full size."""
    from ellspmv_jax.bench.stream import measure_copy_bandwidth
    from ellspmv_jax.cli import csrspmv, ellspmv
    from ellspmv_jax.config import hbm_peak_bytes_per_s
    from ellspmv_jax.models.generators import (dense_rows, fem_mesh_2d,
                                               power_law)

    copy = measure_copy_bandwidth()
    log(f"copy: {copy / 1e9:.1f} GB/s measured, "
        f"{hbm_peak_bytes_per_s() / 1e9:.0f} GB/s published")

    fem = fem_mesh_2d(1440)
    log(f"fem_mesh_2d(1440) DIA SpMV compiles to {dia_fusions(fem)} "
        "fusion kernel(s)")
    rates = spmv_phase("fem1440", fem, log, [
        ("ellspmv --format=auto", ellspmv.main, ["--format=auto"]),
        ("ellspmv --format=ell", ellspmv.main, ["--format=ell"]),
        ("csrspmv", csrspmv.main, []),
    ])
    del fem
    skewed = [("power_law_1M", power_law(1_000_000, 7, seed=0)),
              ("dense_rows_1M", dense_rows(1_000_000, 8, num_dense=16,
                                           dense_nnz=1_000_000 // 8,
                                           seed=0))]
    for name, coo in skewed:
        rates.update(spmv_phase(name, coo, log, [
            ("ellspmv --format=auto", ellspmv.main, ["--format=auto"]),
            ("csrspmv", csrspmv.main, []),
            ("ellspmv --format=sell", ellspmv.main, ["--format=sell"]),
        ]))
    for label, (t, gbps) in rates.items():
        if gbps is not None:
            log(f"share of copy: {label}: {100 * gbps * 1e9 / copy:.1f}%")

    cg_phase(512, log)
    bench_phase(log)


def four_cards(log: Log, nx: int = 2610) -> None:
    """The sharded SpMV and CG on four cards, each beside one card, on
    fem_mesh_2d(nx, nx, extras=5, seed=1)."""
    import jax

    from ellspmv_jax.cli import cgsolve
    from ellspmv_jax.cli.common import execute, parse_args
    from ellspmv_jax.io.mtx import write_vector
    from ellspmv_jax.models.generators import fem_mesh_2d
    from ellspmv_jax.ops.reference import coo_spmv_numpy, spmv_error

    if len(jax.devices()) < 4:
        raise SmokeFailure(f"--four needs 4 devices, have "
                           f"{len(jax.devices())}")
    t0 = time.perf_counter()
    coo = fem_mesh_2d(nx, nx, extras=5, seed=1)
    x = np.random.RandomState(1).rand(coo.num_columns)
    log(f"fem_mesh_2d({nx}, extras=5): {coo.num_rows:,} rows, "
        f"{coo.num_nonzeros:,} nnz built in {time.perf_counter() - t0:.1f} s")
    repeat, warmup = 10, 2

    os.makedirs(DATA, exist_ok=True)
    x_path = os.path.join(DATA, "lynx_x.mtx")
    write_vector(x_path, x, precision=17)

    def spmv_run(program, flags, devices):
        """Per-iteration run checked against the oracle, then a chained
        run for the device time; both through the CLI's own execute()."""
        csr = program == "csrspmv"
        label = f"{program} {' '.join(flags + [f'--devices={devices}'])}"
        texts = []
        for protocol in ("per_iter", "chained"):
            # the matrix is in memory; only x comes from a file
            argv = flags + [f"--devices={devices}", f"--repeat={repeat}",
                            f"--warmup={warmup}", f"--protocol={protocol}",
                            "-q", "-v", "--papi-event-summary", "in-memory",
                            x_path]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, y = execute(parse_args(argv, program, csr), coo, csr)
            texts.append(err.getvalue())
            if rc != 0:
                sys.stderr.write(texts[-1])
                raise SmokeFailure(f"{label}: exit code {rc}")
            if protocol == "per_iter":
                check(label, spmv_error(coo, x, y, times=repeat + warmup),
                      RTOL_F64, log)
        t, _ = report_rate(texts[1], f"{label} (chained)", log)
        log(f"{label}: {coo.num_nonzeros / t / 1e9:.2f} Gnz/s")
        for line in texts[0].splitlines():
            if line.startswith(("rows per device", "nonzeros per device")):
                log(f"{label}: {line}")

    def cg_run(devices):
        b = np.ones(coo.num_rows)
        res = cgsolve.solve(coo, b, tol=CG_TOL, maxiter=2000,
                            devices=devices)
        xs = np.asarray(res.x)
        rel = np.linalg.norm(b - coo_spmv_numpy(coo, xs)) / np.linalg.norm(b)
        ok = rel <= 10 * CG_TOL
        log(f"cgsolve --devices={devices}: {int(res.iterations)} iterations, "
            f"host residual {rel:.3e} {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"cg --devices={devices} residual {rel:.3e}")

    spmv_run("ellspmv", [], 4)
    spmv_run("csrspmv", ["--partition-rows"], 4)
    spmv_run("csrspmv", ["--partition-nonzeros"], 4)
    cg_run(4)
    for d in jax.devices()[:4]:
        st = d.memory_stats() or {}
        log(f"device {d.id}: bytes_in_use {st.get('bytes_in_use', 0):,}, "
            f"peak_bytes_in_use {st.get('peak_bytes_in_use', 0):,}")
    spmv_run("ellspmv", [], 1)
    spmv_run("csrspmv", [], 1)
    cg_run(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke.py: needs a GPU, found "
                         f"{devices[0].platform!r}\n")
        return 1
    from ellspmv_jax.config import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    card = card_description()
    print(f"card: {card}")
    log = Log(devices[0].device_kind, card)
    t0 = time.perf_counter()
    try:
        (four_cards if args.four else single_card)(log)
    except SmokeFailure as e:
        sys.stderr.write(f"chip_smoke.py: FAILED: {e}\n")
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
