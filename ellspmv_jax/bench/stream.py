"""Measured device-memory bandwidth: a large copy timed by loop-length slope.

The reference compares SpMV bandwidth against a quoted theoretical peak
(README:144-146, 256 GB/s for 2×Xeon 6130). Here the achievable copy
bandwidth of the actual device is measured in the same process as the SpMV
runs, and SpMV rates are reported against both it and the published peak.

- 1 GiB working set (two 512 MiB buffers), twenty times the H100's 50 MB
  L2, so the loop carry cannot stay cache-resident;
- median of 5 two-point loop-length slopes;
- a reading outside 5%-120% of the published peak is an error, never
  replaced by a nominal figure.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def _run(fn, *args) -> float:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def measure_copy_bandwidth(size_mb: int = 512, iters: int = 64) -> float:
    """Achievable device-memory bandwidth in bytes/s from a chained copy
    (out = -a: one read + one write of `size_mb` MiB per iteration),
    measured as the median of 5 two-point loop-length slopes. Needs a GPU:
    a CPU reading says nothing about the device."""
    from ellspmv_jax.config import hbm_peak_bytes_per_s

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise RuntimeError(
            f"measure_copy_bandwidth needs a GPU, found {device.platform!r}")
    nominal = hbm_peak_bytes_per_s(device)
    n = size_mb * 1024 * 1024 // 4
    a = jnp.arange(n, dtype=jnp.float32)

    @jax.jit
    def copy(a, iters):
        return jax.lax.fori_loop(0, iters, lambda _, c: -c, a)

    lo, hi = max(2, iters // 16), iters
    _run(copy, a, lo), _run(copy, a, hi)
    slopes = sorted((_run(copy, a, hi) - _run(copy, a, lo)) / (hi - lo)
                    for _ in range(5))
    bw = 2 * n * 4 / max(slopes[len(slopes) // 2], 1e-12)
    if not 0.05 * nominal <= bw <= 1.2 * nominal:
        raise RuntimeError(
            f"copy bandwidth {bw / 1e9:.1f} GB/s is implausible against the "
            f"published {nominal / 1e9:.0f} GB/s of {device.device_kind}")
    return float(bw)
