"""Benchmark harness: warmup + timed repeat loop with the reference's exact
metric accounting, plus a device-memory roofline (the replacement for the
reference's PAPI hardware-counter region, SURVEY §5).

Metric formulas are byte-for-byte those of the reference:

- ELL (ellspmv.c:1857-1862):
    flops     = 2*(ellsize + diagsize)          # diagsize counted always
    min_bytes = rows*sv + cols*sv + ellsize*si + ellsize*sv + diagsize*sv
    max_bytes = rows*sv + ellsize*sv + ellsize*si + ellsize*sv
                + diagsize*sv + diagsize*sv     # x re-read per nonzero
- CSR (csrspmv.c:2882-2887): same plus rowptr bytes ((rows+1)*si min,
    rows*si max).
- Gnz/s uses the file's stored nonzero count (ellspmv.c:1871).

Two timing protocols:

- ``per_iter``: one device dispatch per iteration, synchronized — the
  reference's protocol (t0 before kernel, t1 after the barrier,
  ellspmv.c:1825-1847). Reported per-iteration times include host dispatch
  overhead.
- ``chained``: `repeat` iterations run inside one jitted `lax.fori_loop`
  with a forced serial dependency (x_{k+1} = scale*y_k), timed at two loop
  lengths; the slope isolates pure device time per iteration. This is the
  protocol `bench.py` uses for roofline numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ellspmv_jax.bench.traffic import estimate_actual_bytes
from ellspmv_jax.config import hbm_peak_bytes_per_s
from ellspmv_jax.formats.csr import CsrMatrix
from ellspmv_jax.formats.ell import EllMatrix


@dataclasses.dataclass
class SpmvMetrics:
    """Static per-iteration work accounting (reference formulas)."""
    num_nonzeros: int      # stored entries in the file (Gnz/s numerator)
    num_flops: int
    min_bytes: int
    max_bytes: int

    @staticmethod
    def for_matrix(matrix) -> "SpmvMetrics":
        if isinstance(matrix, EllMatrix):
            sv = np.dtype(matrix.values.dtype).itemsize
            si = np.dtype(matrix.colidx.dtype).itemsize
            n, m = matrix.num_rows, matrix.num_columns
            ellsize, diagsize = matrix.ellsize, matrix.diagsize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * (ellsize + diagsize),
                min_bytes=(n * sv + m * sv + ellsize * si + ellsize * sv
                           + diagsize * sv),
                max_bytes=(n * sv + ellsize * sv + ellsize * si
                           + ellsize * sv + diagsize * sv + diagsize * sv))
        if isinstance(matrix, CsrMatrix):
            sv = np.dtype(matrix.values.dtype).itemsize
            si = np.dtype(matrix.rowptr.dtype).itemsize
            n, m = matrix.num_rows, matrix.num_columns
            csrsize, diagsize = matrix.csrsize, matrix.diagsize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * (csrsize + diagsize),
                min_bytes=(n * sv + m * sv + (n + 1) * si + csrsize * si
                           + csrsize * sv + diagsize * sv),
                max_bytes=(n * sv + csrsize * sv + n * si + csrsize * si
                           + csrsize * sv + diagsize * sv + diagsize * sv))
        from ellspmv_jax.formats.hybrid import HybridMatrix
        if isinstance(matrix, HybridMatrix):
            sv = np.dtype(matrix.values.dtype).itemsize
            n, m = matrix.num_rows, matrix.num_columns
            work = (matrix.rest.sellsize + matrix.rest.tailsize
                    + (0 if matrix.hub is None
                       else matrix.hub.sellsize + matrix.hub.tailsize))
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * work,
                min_bytes=n * sv + m * sv + work * (4 + sv),
                max_bytes=n * sv + work * (4 + 2 * sv))
        from ellspmv_jax.formats.sell import SellMatrix
        if isinstance(matrix, SellMatrix):
            sv = np.dtype(matrix.values.dtype).itemsize
            n, m = matrix.num_rows, matrix.num_columns
            work = matrix.sellsize + matrix.tailsize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * work,
                min_bytes=n * sv + m * sv + work * (4 + sv),
                max_bytes=n * sv + work * (4 + 2 * sv))
        from ellspmv_jax.formats.dia import DiaMatrix
        if isinstance(matrix, DiaMatrix):
            # DIA accounting (no reference analogue): stored diagonal values
            # all participate; no column indices are read at all.
            sv = np.dtype(matrix.data.dtype).itemsize
            n, m = matrix.num_rows, matrix.num_columns
            diasize = matrix.diasize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * diasize,
                min_bytes=n * sv + m * sv + diasize * sv,
                max_bytes=n * sv + diasize * sv + diasize * sv)
        raise TypeError(f"unsupported matrix type {type(matrix)}")


@dataclasses.dataclass
class BenchResult:
    times: list[float]          # seconds per timed iteration
    metrics: SpmvMetrics
    y: jax.Array | None         # result after warmup+timed iterations
    protocol: str
    device: object              # the jax.Device the loop ran on
    span_iters: int | None = None   # chained: iterations in the timed span
    actual_bytes: int | None = None  # stored bytes moved per iteration

    @property
    def hbm_peak(self) -> float:
        """Published memory-bandwidth peak of `device` (bytes/s); raises
        for a device kind the table does not list."""
        return hbm_peak_bytes_per_s(self.device)

    @property
    def best(self) -> float:
        return min(self.times)

    def gnz_per_s(self, t=None) -> float:
        return self.metrics.num_nonzeros * 1e-9 / (t or self.best)

    def gflop_per_s(self, t=None) -> float:
        return self.metrics.num_flops * 1e-9 / (t or self.best)

    def min_gb_per_s(self, t=None) -> float:
        return self.metrics.min_bytes * 1e-9 / (t or self.best)

    def max_gb_per_s(self, t=None) -> float:
        return self.metrics.max_bytes * 1e-9 / (t or self.best)

    def roofline_fraction(self) -> float:
        """Achieved effective bandwidth (min-bytes model) / HBM peak."""
        return self.metrics.min_bytes / self.best / self.hbm_peak

    def actual_gb_per_s(self, t=None) -> float | None:
        """Rate of the bytes the format stores and moves per iteration
        (bench/traffic.py), or None when no count exists for the matrix."""
        if self.actual_bytes is None:
            return None
        return self.actual_bytes * 1e-9 / (t or self.best)

    def physical_roofline(self) -> float | None:
        """Actual traffic / memory peak — at most ~1, unlike the effective
        (min-bytes-model) roofline, which formats that move fewer bytes
        than ELLPACK's minimum legitimately exceed."""
        if self.actual_bytes is None:
            return None
        return self.actual_bytes / self.best / self.hbm_peak

    def iteration_lines(self) -> list[str]:
        """Per-iteration report in the reference's format
        (ellspmv.c:1868-1875). Under the chained protocol there are no
        individual iteration timestamps — the measurement is ONE slope over
        a long in-jit span — so print it once, labeled as a slope, instead
        of `repeat` synthetic copies."""
        if self.protocol == "chained":
            t = self.best
            span = f" over a {self.span_iters}-iteration chained span" \
                if self.span_iters else ""
            return [
                f"{t:.9f} seconds/iteration (slope{span}; "
                f"{self.gnz_per_s(t):.3f} Gnz/s, "
                f"{self.gflop_per_s(t):.3f} Gflop/s, "
                f"{self.min_gb_per_s(t):.1f} to {self.max_gb_per_s(t):.1f} "
                f"GB/s)"]
        out = []
        for t in self.times:
            out.append(
                f"{t:.6f} seconds ({self.gnz_per_s(t):.3f} Gnz/s, "
                f"{self.gflop_per_s(t):.3f} Gflop/s, "
                f"{self.min_gb_per_s(t):.1f} to {self.max_gb_per_s(t):.1f} "
                f"GB/s)")
        return out


def _timed(fn, *args):
    """Run `fn(*args)` to completion; return (seconds, result)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def benchmark_spmv(spmv_fn: Callable | None, matrix, x, y=None,
                   repeat: int = 1, warmup: int = 0,
                   protocol: str = "per_iter",
                   device=None, metrics_matrix=None,
                   metrics: SpmvMetrics | None = None) -> BenchResult:
    """Benchmark `spmv_fn(matrix, x, y) -> y_new`. `spmv_fn=None` uses the
    library dispatch (and, in the chained protocol, the traceable form that
    keeps matrix data out of the compiled program's constants).

    per_iter: mirrors the reference loop — `warmup` untimed iterations
    (ellspmv.c:1745-1801) then `repeat` timed ones, accumulating into y.
    chained: y-accumulation with a serial x-dependency inside one jit;
    returns `repeat` copies of the slope time.
    """
    if metrics is None:
        metrics = SpmvMetrics.for_matrix(
            matrix if metrics_matrix is None else metrics_matrix)
    if device is None:
        device = jax.devices()[0]
    actual_bytes = estimate_actual_bytes(
        matrix if metrics_matrix is None else metrics_matrix)
    x = jnp.asarray(x)
    if spmv_fn is None and protocol == "per_iter":
        from ellspmv_jax.ops import spmv as spmv_fn
    if protocol == "per_iter":
        yk = None if y is None else jnp.asarray(y)
        # Compile before the timed loop regardless of --warmup: the
        # reference's iter-1 line is a real kernel because C is precompiled
        # (its whole v1.10 timing fix, ellspmv.c:30-37, exists to time ONLY
        # SpMV); one discarded dispatch per trace signature (y=None and
        # y=array give different traces) plays that role here. --warmup
        # stays about caches/iteration count (ellspmv.c:1745-1801), not
        # codegen.
        d1 = spmv_fn(matrix, x, yk)
        jax.block_until_ready(spmv_fn(matrix, x, d1))
        for _ in range(warmup):
            yk = spmv_fn(matrix, x, yk)
        jax.block_until_ready(yk)
        times = []
        for _ in range(repeat):
            t, yk = _timed(spmv_fn, matrix, x, yk)
            times.append(t)
        return BenchResult(times, metrics, yk, protocol, device,
                           actual_bytes=actual_bytes)

    if protocol == "chained":
        if matrix.num_rows != matrix.num_columns:
            raise ValueError("chained protocol needs a square matrix "
                             "(x is re-derived from y each iteration)")
        values = getattr(matrix, "values", None)
        if values is None:
            values = matrix.data
        val_dtype = np.dtype(values.dtype)
        # the chained carry must be dtype-stable: iterate at the matrix's
        # value dtype (an f32 kernel returns f32 y, which becomes the next
        # x — an f64 x0 would flip the carry dtype after one iteration)
        x = x.astype(val_dtype)
        # small enough that ||A||*scale < 1 for any realistic matrix: the
        # chained y would otherwise grow by (scale*||A||)^k and overflow in
        # long adaptive runs (values don't affect the timing)
        scale = jnp.asarray(1e-6, val_dtype)

        # Pass the matrix data as jit ARGUMENTS: closing over it inside the
        # loop would embed the arrays as constants in the compiled program.
        # Every single-device matrix is a pytree; the sharded fns carry a
        # `.traceable = (operand, fn)` form.
        if spmv_fn is None:
            from ellspmv_jax.ops import spmv as fn
            operand = matrix
        else:
            operand, fn = getattr(spmv_fn, "traceable", (matrix, spmv_fn))

        def make_loop(iters: int):
            @jax.jit
            def run(x0, y0, op):
                def body(_, carry):
                    xk, yk = carry
                    yn = fn(op, xk, yk)
                    # serial dependency so XLA cannot hoist or overlap
                    return yn * scale, yn
                return jax.lax.fori_loop(0, iters, body, (x0, y0))
            return run

        y0 = jnp.zeros(matrix.num_rows, val_dtype) if y is None \
            else jnp.asarray(y)

        def measure(lo, hi):
            run_lo, run_hi = make_loop(lo), make_loop(hi + lo)
            jax.block_until_ready(run_lo(x, y0, operand))
            jax.block_until_ready(run_hi(x, y0, operand))
            per_iter, out = float("inf"), None
            for _ in range(3):   # best of 3 slope pairs (host timer jitter)
                t_lo, _ = _timed(run_lo, x, y0, operand)
                t_hi, out = _timed(run_hi, x, y0, operand)
                per_iter = min(per_iter, max((t_hi - t_lo) / hi, 1e-12))
            return per_iter, out

        lo, hi = max(1, warmup or 2), max(8, repeat)
        per_iter, out = measure(lo, hi)
        # Lengthen the span until it dwarfs host-side timer and launch
        # jitter: target ~0.3 s, rounded UP to a power of two so the
        # loop-length-dependent compile hits the persistent cache.
        if per_iter * hi < 0.25:
            hi2 = 1 << int(np.ceil(np.log2(0.3 / max(per_iter, 1e-7))))
            hi2 = min(hi2, 4096)
            if hi2 > 2 * hi:
                per_iter, out = measure(lo, hi2)
                hi = hi2
        return BenchResult([per_iter] * repeat, metrics, out[1], protocol,
                           device, span_iters=hi, actual_bytes=actual_bytes)

    raise ValueError(f"unknown protocol {protocol!r}")
