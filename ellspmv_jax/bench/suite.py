"""Benchmark suite over the BASELINE.json configs.

Run: ``python -m ellspmv_jax.bench.suite [--quick] [--json]``

Covers the five driver configs (BASELINE.json):
  0. bundled-test.mtx-equivalent golden check (ELL vs CSR vs dense)
  1. 2-D 5-point Poisson (ideal ELL; also the DIA gather-free path)
  2. banded FEM stand-in (variable rows, ELL vs CSR crossover)
  3. power-law and dense-rows (auto=CSR vs SELL vs hub hybrid)
  4. row-sharded SpMV + CG loop over the device mesh

Each row reports the reference metric set (Gnz/s, Gflop/s, min/max GB/s,
roofline fraction — ellspmv.c:1868-1875 formulas).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _bench(matrix, x, repeat, protocol="chained"):
    from ellspmv_jax.bench.harness import benchmark_spmv

    # spmv_fn=None -> library dispatch, matrix arrays passed as jit
    # arguments inside the timing loop
    return benchmark_spmv(None, matrix, x,
                          repeat=repeat, warmup=2, protocol=protocol)


def run_suite(quick: bool = False, as_json: bool = False,
              stream=sys.stderr) -> list[dict]:
    import jax

    jax.config.update("jax_enable_x64", True)

    from ellspmv_jax.bench.stream import measure_copy_bandwidth
    from ellspmv_jax.config import hbm_peak_bytes_per_s
    from ellspmv_jax.formats.csr import csr_from_coo
    from ellspmv_jax.formats.dia import dia_from_coo
    from ellspmv_jax.formats.ell import ell_from_coo
    from ellspmv_jax.formats.sell import sell_from_coo
    from ellspmv_jax.models.generators import (banded_random, poisson2d,
                                               power_law)
    from ellspmv_jax.models.solvers import cg
    from ellspmv_jax.ops import spmv
    from ellspmv_jax.ops.reference import coo_spmv_numpy

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"the suite measures a GPU; found {dev.platform!r}")
    scale = 8 if quick else 1
    results = []
    stream.write(f"device: {dev.platform} {dev.device_kind} x "
                 f"{len(jax.devices())}\n")

    def record(name, res, note=""):
        act = res.actual_gb_per_s()
        row = {
            "config": name,
            "best_s": res.best,
            "gnz_per_s": res.gnz_per_s(),
            "gflop_per_s": res.gflop_per_s(),
            "min_gb_per_s": res.min_gb_per_s(),
            "max_gb_per_s": res.max_gb_per_s(),
            "roofline_effective": res.roofline_fraction(),
            # stored-bytes columns (bench/traffic.py): the effective
            # roofline is the reference min-bytes MODEL and can exceed 1.0
            # for formats that store less than ELLPACK
            "actual_bytes": res.actual_bytes,
            "actual_gb_per_s": act,
            "roofline_physical": res.physical_roofline(),
            "note": note,
        }
        results.append(row)
        phys = "    --     " if act is None else \
            f"{act:6.1f} GB/s ({100 * res.physical_roofline():5.1f}%)"
        stream.write(
            f"{name:34s} {res.best * 1e3:9.3f} ms  "
            f"{res.gnz_per_s():7.2f} Gnz/s  eff {res.min_gb_per_s():7.1f} "
            f"GB/s ({100 * res.roofline_fraction():5.1f}%)  phys {phys}  "
            f"{note}\n")

    def oracle(name, mat, coo, x):
        got = np.asarray(spmv(mat, x), np.float64)
        want = coo_spmv_numpy(coo, x)
        err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
        stream.write(f"{name + ' oracle':34s} normwise err {err:.2e}\n")
        results.append({"config": name + " oracle",
                        "normwise_err": float(err)})

    # --- measured copy vs published peak ----------------------------------
    measured = measure_copy_bandwidth()
    nominal = hbm_peak_bytes_per_s(dev)
    stream.write(f"{'copy measured/published':34s} "
                 f"{measured / 1e9:7.1f} / {nominal / 1e9:.1f} GB/s "
                 f"({100 * measured / nominal:.1f}%)\n")
    results.append({"config": "copy", "measured_gb_per_s": measured / 1e9,
                    "published_gb_per_s": nominal / 1e9})

    # --- config 0: golden correctness -------------------------------------
    rows = np.array([0, 0, 1, 2, 3, 3, 3, 3, 3], np.int32)
    cols = np.array([0, 3, 1, 2, 0, 1, 2, 3, 4], np.int32)
    vals = np.array([1.5, 1.5, 1.0, 3.0, 2.0, 1.0, 1.0, 1.0, 1.0])
    from ellspmv_jax.formats.coo import CooMatrix
    coo0 = CooMatrix(4, 5, rows, cols, vals)
    x0 = np.ones(5)
    ye = np.asarray(spmv(ell_from_coo(coo0).device_put(), x0))
    yc = np.asarray(spmv(csr_from_coo(coo0).device_put(), x0))
    ok = (np.allclose(ye, [3, 1, 3, 6], rtol=1e-13)
          and np.allclose(yc, [3, 1, 3, 6], rtol=1e-13))
    stream.write(f"{'config0 golden test.mtx':34s} "
                 f"{'PASS' if ok else 'FAIL'}  y={ye.tolist()}\n")
    results.append({"config": "config0 golden", "pass": bool(ok)})

    # --- config 1: Poisson stencil ---------------------------------------
    nx = 1024 // (2 if quick else 1)
    coo = poisson2d(nx)
    x = np.random.RandomState(0).rand(coo.num_rows)
    ell = ell_from_coo(coo, sort_rows=True,
                       value_dtype=np.float64).device_put()
    record(f"config1 poisson {nx}x{nx} ELL f64", _bench(ell, x, 128))
    dia = dia_from_coo(coo, value_dtype=np.float64).device_put()
    # DIA is so fast the slope needs many iterations to resolve
    record(f"config1 poisson {nx}x{nx} DIA f64", _bench(dia, x, 256),
           note="gather-free")
    # IDXTYPEWIDTH=64 analogue (ellspmv.c:112-130, README:25-30): 4 more
    # index bytes per slot than the int32 row above
    ell64 = ell_from_coo(coo, sort_rows=True, value_dtype=np.float64,
                         index_dtype="int64").device_put()
    record(f"config1 poisson {nx}x{nx} ELL f64 idx64",
           _bench(ell64, x, 128), note="--index-width=64")

    # --- headline: FEM mesh, auto-chosen flagship format ------------------
    # bench.py's config (the reference's Lynx68-class matrix stand-in,
    # BASELINE configs[2]); metrics on the reference's ELLPACK min-bytes
    # model (ellspmv.c:1858) so the row is comparable to its 148 GB/s
    from ellspmv_jax.bench.harness import SpmvMetrics
    from ellspmv_jax.formats.auto import auto_from_coo
    from ellspmv_jax.models.generators import fem_mesh_2d
    nmesh = int(round((2_073_600 // scale) ** 0.5))
    coo = fem_mesh_2d(nmesh)
    x = np.random.RandomState(1).rand(coo.num_rows)
    rowsize = int(np.bincount(np.asarray(coo.rowidx)).max())
    ellsize = coo.num_rows * rowsize
    mmetrics = SpmvMetrics(
        num_nonzeros=coo.num_nonzeros, num_flops=2 * ellsize,
        min_bytes=coo.num_rows * 8 + coo.num_columns * 8
        + ellsize * (8 + 4),
        max_bytes=coo.num_rows * 8 + ellsize * (8 + 4 + 8))
    mat = auto_from_coo(coo, sort_rows=True, value_dtype=np.float64)
    chosen = getattr(mat, "_auto_choice", type(mat).__name__.lower())
    mat = mat.device_put()
    from ellspmv_jax.bench.harness import benchmark_spmv as _bspmv
    record(f"headline fem-mesh {nmesh}^2 auto f64",
           _bspmv(None, mat, x, repeat=64, warmup=2, protocol="chained",
                  metrics=mmetrics),
           note=f"auto={chosen} (ELLPACK min-bytes basis)")

    # --- config 2: banded FEM stand-in -----------------------------------
    n = 2_000_000 // scale
    coo = banded_random(n, 16, 512, seed=0)
    x = np.random.RandomState(1).rand(n)
    ell = ell_from_coo(coo, sort_rows=True,
                       value_dtype=np.float64).device_put()
    record("config2 banded 16/row ELL f64", _bench(ell, x, 32))
    csr = csr_from_coo(coo, sort_rows=True,
                       value_dtype=np.float64).device_put()
    record("config2 banded 16/row CSR f64", _bench(csr, x, 32),
           note="segment-sum")

    # --- config 3: power-law ---------------------------------------------
    # padded ELL would hold rows x max-row-nnz slots (373 GiB at full
    # size), so auto takes CSR; SELL and the hub hybrid are the
    # alternatives that keep ELL-like rows
    from ellspmv_jax.formats.hybrid import hybrid_from_coo
    sizes = [1_000_000 // scale] + ([] if quick else [10_000_000])
    for n in sizes:
        tag = f"config3 power-law {n:,} rows"
        coo = power_law(n, 8 if n < 10_000_000 else 7, seed=0)
        x = np.random.RandomState(2).rand(n)
        t0 = time.perf_counter()
        mat = auto_from_coo(coo, sort_rows=True, value_dtype=np.float64)
        t_conv = time.perf_counter() - t0
        chosen = mat._auto_choice
        results.append({"config": f"{tag} convert", "convert_s": t_conv,
                        "nnz": int(coo.num_nonzeros)})
        mat = mat.device_put()
        record(f"{tag} auto f64", _bench(mat, x, 8),
               note=f"auto={chosen}, convert {t_conv:.2f} s")
        oracle(f"{tag} auto", mat, coo, x)
        sell = sell_from_coo(coo, sort_rows=True, length_sort=True,
                             value_dtype=np.float64).device_put()
        record(f"{tag} SELL f64", _bench(sell, x, 8))
        if n < 10_000_000:
            hyb = hybrid_from_coo(coo, value_dtype=np.float64).device_put()
            record(f"{tag} hub-hybrid f64", _bench(hyb, x, 8),
                   note=f"hub {100 * hyb.hub_nnz_fraction:.0f}%")
        del coo, mat, sell

    # --- dense-rows class: few long random rows over a local bulk --------
    from ellspmv_jax.models.generators import dense_rows
    n = 1_000_000 // scale
    coo = dense_rows(n, 8, num_dense=16, dense_nnz=n // 8, seed=0)
    x = np.random.RandomState(3).rand(n)
    mat = auto_from_coo(coo, sort_rows=True, value_dtype=np.float64)
    chosen = mat._auto_choice
    mat = mat.device_put()
    record("config-dense-rows auto f64", _bench(mat, x, 8),
           note=f"auto={chosen}")
    oracle("config-dense-rows auto", mat, coo, x)
    sell = sell_from_coo(coo, sort_rows=True, length_sort=True,
                         value_dtype=np.float64).device_put()
    record("config-dense-rows SELL f64", _bench(sell, x, 8))

    # --- config 4: sharded SpMV + CG -------------------------------------
    ndev = len(jax.devices())
    if ndev > 1:
        from ellspmv_jax.parallel.spmv import shard_matrix, sharded_spmv_fn
        coo = poisson2d(128 if quick else 256)
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=np.float64)
        sm = shard_matrix(ell, ndev)
        fn = sharded_spmv_fn(sm)
        x = np.ones(sm.num_columns)
        res = _bspmv(fn, sm, x, repeat=3, warmup=1, metrics_matrix=ell)
        record(f"config4 sharded x{ndev} SpMV f64", res)
        t0 = time.perf_counter()
        operand, tfn = fn.traceable
        sol = cg(tfn, jax.numpy.ones(sm.num_rows), tol=1e-8, maxiter=1500,
                 operand=operand)
        stream.write(f"{'config4 CG solve':34s} {int(sol.iterations)} iters,"
                     f" residual {float(sol.residual_norm):.2e}, "
                     f"{time.perf_counter() - t0:.1f} s\n")
        results.append({"config": "config4 cg",
                        "iterations": int(sol.iterations),
                        "residual": float(sol.residual_norm)})
    else:
        stream.write("config4 skipped (single device)\n")

    if as_json:
        print(json.dumps(results, indent=1))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    run_suite(quick=args.quick, as_json=args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
