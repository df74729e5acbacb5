"""Headline benchmark: fp64 SpMV effective bandwidth on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}

The config mirrors the reference's published headline (README:130-146):
Lynx68_reordered.mtx is an RCM-reordered unstructured-FEM mesh matrix
(6.8M rows, ~17 nnz/row); the default matrix here is `fem_mesh_2d` — a
jittered-mesh FEM matrix in banded (RCM-like) node order with variable
row lengths (~13-21 nnz/row), the faithful synthetic stand-in (BASELINE
configs[2]) — at 2.07M rows / 32.3M nnz, fp64, the auto-chosen format
(DIA here: the mesh lives on 25 distinct diagonals; BENCH_FORMAT=ell pins
ELLPACK for format-parity runs), chained SpMV timing, effective bandwidth
by the reference's ELLPACK min-bytes model (ellspmv.c:1858, padded
ellsize * 12B + x + y) so the figure is comparable to the reference's
148 GB/s on 2x Xeon Gold 6130 (32 threads, AVX-512). Effective bandwidth
above the device's memory line means the format moves fewer bytes than
ELLPACK's minimum (DIA stores no column indices).

`BENCH_GEN=banded` instead benchmarks a uniform-random banded matrix
(16 nnz/row, band 512) — no local smoothness within the band.

Needs a GPU: on any other platform it exits non-zero without a result.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REFERENCE_GBPS = 148.0    # README:135-144, best-iteration effective GB/s
RTOL = 1e-12              # per row, against the row's sum of |a_ij x_j|

N_ROWS = int(os.environ.get("BENCH_ROWS", 2_073_600))
GEN = os.environ.get("BENCH_GEN", "mesh")
NNZ_PER_ROW = 16          # banded config only
BANDWIDTH = int(os.environ.get("BENCH_BAND", 512))


def main() -> int:
    import jax

    from ellspmv_jax.config import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)

    from ellspmv_jax.bench.harness import SpmvMetrics, benchmark_spmv
    from ellspmv_jax.formats.auto import auto_from_coo
    from ellspmv_jax.formats.ell import ell_from_coo
    from ellspmv_jax.models.generators import banded_random, fem_mesh_2d
    from ellspmv_jax.ops import spmv
    from ellspmv_jax.ops.reference import spmv_error

    if GEN == "mesh":
        coo = fem_mesh_2d(int(round(N_ROWS ** 0.5)))
    else:
        coo = banded_random(N_ROWS, NNZ_PER_ROW, BANDWIDTH, seed=0)
    n = coo.num_rows
    if os.environ.get("BENCH_FORMAT", "auto") == "ell":
        mat = ell_from_coo(coo, sort_rows=True, value_dtype=np.float64,
                           row_tile=256)
    else:
        mat = auto_from_coo(coo, sort_rows=True, value_dtype=np.float64)
    chosen = getattr(mat, "_auto_choice", type(mat).__name__.lower())
    mat = mat.device_put()
    x = np.random.RandomState(1).rand(n)

    # effective bandwidth on the reference's ELLPACK min-bytes basis
    # (ellspmv.c:1858: padded ellsize * (value+index) + x + y) so the
    # number is comparable to the reference's 148 GB/s headline whatever
    # format the chooser picked
    rowsize = int(np.bincount(np.asarray(coo.rowidx)).max())
    ellsize = n * rowsize
    metrics = SpmvMetrics(
        num_nonzeros=coo.num_nonzeros, num_flops=2 * ellsize,
        min_bytes=n * 8 + coo.num_columns * 8 + ellsize * (8 + 4),
        max_bytes=n * 8 + ellsize * (8 + 4 + 8))

    res = benchmark_spmv(None, mat, x, repeat=10, warmup=2,
                         protocol="chained", metrics=metrics)

    # correctness against the exact host oracle; the chained protocol
    # accumulates several iterations, so check one clean step
    rel = spmv_error(coo, x, spmv(mat, x))
    if not rel <= RTOL:
        print(f"CORRECTNESS FAILURE: max row error {rel:.3e} > {RTOL}",
              file=sys.stderr)
        return 1

    gbps = res.min_gb_per_s()
    print(json.dumps({
        "metric": "spmv_fp64_effective_bandwidth",
        "value": round(gbps, 2),
        "unit": "GB/s",
        "vs_baseline": round(gbps / REFERENCE_GBPS, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    # dual-report: the effective (reference min-bytes model) number is the
    # parity metric; the stored-bytes number is the format's own traffic
    act = res.actual_gb_per_s()
    print(f"  config: {GEN}, {n} rows, {coo.num_nonzeros} nnz "
          f"(rowsize {rowsize}), fp64, format={chosen}, "
          f"{res.best * 1e3:.6f} ms/iter, "
          f"{res.gnz_per_s():.2f} Gnz/s, {res.gflop_per_s():.2f} Gflop/s, "
          f"effective {100 * res.roofline_fraction():.1f}% of the "
          f"published memory bandwidth by the reference's ELLPACK "
          f"min-bytes model; stored bytes {act:.1f} GB/s = "
          f"{100 * res.physical_roofline():.1f}% "
          f"({res.actual_bytes / 1e6:.0f} MB/iter; max row error "
          f"{rel:.2e}) on {dev.device_kind}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
