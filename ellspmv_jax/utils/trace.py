"""Device-level tracing — the replacement for the reference's PAPI
hardware-counter region (papi_util.c:562-769, SURVEY §5).

PAPI counts cache refills and FLOPs on the CPU; on the accelerator the
equivalent ground truth is a profiler trace: per-kernel device time comes
from `jax.profiler`.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Wrap a region in a jax.profiler trace when `trace_dir` is set
    (CLI: --trace=DIR); no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
