"""Reference-scale end-to-end run.

Generates a Lynx68_reordered-class matrix (README:130: 6,810,586 rows,
115,779,962 nnz, ~17 nnz/row, RCM-reordered FEM mesh) as a real .mtx
file, then drives the actual `ellspmv` CLI on it, reporting the same
phases the reference publishes: mtxfile_read, ell_from_coo, SpMV.

Reference numbers to beat (BASELINE.md, 2x Xeon Gold 6130 / 32 threads):
read 32.03 s (99.7 MB/s), convert 0.773 s, SpMV 148 GB/s.

The CLI runs in a child process; this parent only generates the file
(NumPy) and never touches the device, so the child has the card to itself.

Usage: python benchmarks/reference_scale.py [--nx 2610] [--keep]
       [--gen-only | --run-only]
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# gitignored scratch directory inside the checkout
PATH = os.path.join(ROOT, "smoke_data", "refscale.mtx")


def generate(nx: int):
    import numpy as np
    from ellspmv_jax.io.mtx import write_matrix
    from ellspmv_jax.models.generators import fem_mesh_2d

    t0 = time.perf_counter()
    coo = fem_mesh_2d(nx, nx, extras=5, seed=1)
    t_gen = time.perf_counter() - t0
    print(f"fem_mesh_2d({nx}): {coo.num_rows:,} rows, "
          f"{coo.num_nonzeros:,} nnz ({t_gen:.1f} s)", flush=True)
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    write_matrix(PATH, coo)
    t_w = time.perf_counter() - t0
    mb = os.path.getsize(PATH) / 1e6
    print(f"write: {mb:.0f} MB in {t_w:.1f} s ({mb / t_w:.0f} MB/s)",
          flush=True)


def run():
    cmd = [sys.executable, "-u", "-m", "ellspmv_jax.cli.ellspmv",
           "-q", "-v", "--protocol=chained", "--repeat=4", "--warmup=2",
           PATH]
    print("run:", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=7200,
                       cwd=ROOT)
    print(f"CLI wall: {time.perf_counter() - t0:.1f} s, rc={p.returncode}",
          flush=True)
    for line in p.stderr.splitlines():
        if "WARNING" not in line:
            print("  " + line, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2610)
    ap.add_argument("--gen-only", action="store_true")
    ap.add_argument("--run-only", action="store_true")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    if not args.run_only:
        generate(args.nx)
    if not args.gen_only:
        run()
        if not args.keep:
            os.unlink(PATH)


if __name__ == "__main__":
    main()
