"""Global configuration: dtypes, index-width selection, hardware tables.

The reference selects its index type at compile time via ``IDXTYPEWIDTH``
(ellspmv.c:112-130): 32-bit, 64-bit, or plain ``int``. Here the analogue is a
runtime dtype choice with automatic promotion — int32 by default (half the index
bytes of int64 on a bandwidth-bound kernel), int64 when the matrix dimensions or
nonzero count demand it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# Largest value an int32 index may take. Mirrors the reference's idx_t bounds
# checks (ellspmv.c:123 IDX_T_MAX).
_INT32_MAX = np.iinfo(np.int32).max


def default_index_dtype() -> np.dtype:
    """Default index dtype (the reference's default is plain ``int``,
    ellspmv.c:126-130 — 32-bit on every platform it targets)."""
    return np.dtype(np.int32)


def select_index_dtype(num_rows: int, num_columns: int, num_nonzeros: int,
                       requested: str | np.dtype | None = None) -> np.dtype:
    """Pick an index dtype, honoring an explicit request.

    Automatic promotion to int64 when any dimension or the nonzero count
    exceeds int32 range — the runtime analogue of rebuilding the reference
    with ``IDXTYPEWIDTH=64`` (README:25-30).
    """
    if requested is not None:
        dt = np.dtype(requested)
        if dt not in (np.dtype(np.int32), np.dtype(np.int64)):
            raise ValueError(f"index dtype must be int32 or int64, got {dt}")
        if dt == np.dtype(np.int32):
            if max(num_rows, num_columns, num_nonzeros) > _INT32_MAX:
                raise OverflowError(
                    "matrix too large for int32 indices; use int64 "
                    "(the reference would likewise fail unless rebuilt with "
                    "IDXTYPEWIDTH=64)")
        return dt
    if max(num_rows, num_columns, num_nonzeros) > _INT32_MAX:
        return np.dtype(np.int64)
    return default_index_dtype()


# Device-memory peak bandwidth in bytes/s, keyed by the exact
# `jax.Device.device_kind` string, used by the roofline reporting in bench/
# (replaces the reference's PAPI-derived memory bandwidth metrics,
# papi_util_a64fx_memdp.txt:14-29). Values are vendor-published peaks;
# `bench.stream.measure_copy_bandwidth()` measures the achievable one.
HBM_PEAK_BYTES_PER_S = {
    # NVIDIA H100 SXM5 data sheet: 80 GB HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_per_s(device=None) -> float:
    """Published device-memory peak of `device` (default: first device).
    A device kind missing from the table is an error, not a default."""
    import jax

    if device is None:
        device = jax.devices()[0]
    kind = device.device_kind
    try:
        return HBM_PEAK_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {kind!r}; add "
            "it to ellspmv_jax.config.HBM_PEAK_BYTES_PER_S") from None


def compile_cache_dir() -> str:
    """Persistent compilation cache directory: $JAX_COMPILATION_CACHE_DIR
    when set, else a fixed `.jax_cache` at the root of this checkout (the
    path is part of the cache key, so it must not move between runs)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.
    JAX reads $JAX_COMPILATION_CACHE_DIR itself, so only the default needs
    setting here."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass
class Config:
    """Runtime configuration shared by conversions, kernels and CLIs.

    Mirrors the reference's knob surface: `separate_diagonal` and `sort_rows`
    are the two conversion flags (ellspmv.c:219-311 help text);
    `value_dtype`/`index_dtype` replace the compile-time precision and
    IDXTYPEWIDTH choices.
    """

    value_dtype: str = "float64"
    index_dtype: str | None = None     # None = auto (int32 unless too large)
    separate_diagonal: bool = False
    sort_rows: bool = False
    # Pad row counts to a multiple of this so every kernel tile is full.
    row_tile: int = 8

    def np_value_dtype(self) -> np.dtype:
        return np.dtype(self.value_dtype)


def accumulation_dtype(value_dtype) -> np.dtype:
    """Dtype SpMV sums are carried in: float32 for narrower storage
    (bfloat16/float16 keep their accuracy only with wider partial sums),
    the storage dtype otherwise."""
    dt = np.dtype(value_dtype)
    if dt.kind == "f" and dt.itemsize < 4 or dt.name == "bfloat16":
        return np.dtype(np.float32)
    return dt
