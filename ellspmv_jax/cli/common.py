"""Shared CLI implementation for the `ellspmv` and `csrspmv` programs.

Flag-compatible with the reference's hand-rolled parsers
(parse_program_options, ellspmv.c:465-611 / csrspmv.c:667-899): both
``--opt=v`` and ``--opt v`` forms, ``--`` terminator, up to three positional
Matrix Market paths ``A [x] [y]``, and the full option set. CPU-specific
options are accepted and mapped to their device meaning or no-op'd with
a notice:

- ``--partition-rows`` / ``--rows-per-thread`` → row sharding across mesh
  devices (the OpenMP-thread analogue, SURVEY §2.4);
- ``--partition-nonzeros`` / ``--precompute-partition`` → nonzero-balanced
  device row splits;
- ``--columns-per-thread`` → no-op (NUMA first-touch placement has no
  device-memory analogue);
- ``--l1/l2-prefetch-distance`` → no-op (A64FX MSRs);
- ``--papi-*`` → the roofline/metrics reporter (PAPI counters have no
  accelerator analogue; achieved-bandwidth-vs-peak replaces them, SURVEY §5).

Output protocol matches the reference: stderr is the log channel, stdout the
data channel (y as a Matrix Market vector, suppressed by ``-q``,
ellspmv.c:1899-1912).
"""

from __future__ import annotations

import sys
import time

import numpy as np

PROGRAM_VERSION = "0.1.0"


class CliError(Exception):
    pass


def _split_eq(arg: str, name: str):
    if arg == name:
        return None
    if arg.startswith(name + "="):
        return arg[len(name) + 1:]
    return False


class Options:
    def __init__(self, program: str):
        self.program = program
        self.A_path = None
        self.x_path = None
        self.y_path = None
        self.gzip = False
        self.separate_diagonal = False
        self.sort_rows = False
        self.repeat = 1
        self.warmup = 0
        self.quiet = False
        self.verbose = 0
        # csrspmv partition flags (mapped to device sharding)
        self.partition = "rows"
        self.precompute_partition = False
        self.rows_per_thread = None
        self.columns_per_thread = None
        self.l1_prefetch_distance = None
        self.l2_prefetch_distance = None
        # papi flags (mapped to roofline reporting)
        self.papi_event_file = None
        self.papi_event_format = "plain"
        self.papi_event_per_thread = False
        self.papi_event_summary = False
        # extensions beyond the reference's option set
        self.precision = "float64"
        self.index_width = None          # None=auto, 32, 64
        self.protocol = "per_iter"
        self.devices = 1
        self.trace_dir = None
        self.reorder = "none"
        self.format = None               # ellspmv: ell (default) | auto |
                                         # dia | sell | hybrid


def print_help(program: str, csr: bool, f=None):
    f = f or sys.stdout
    f.write(f"Usage: {program} [OPTION..] A [x] [y]\n\n")
    f.write(" Multiply a matrix by a vector: y := A*x + y.\n\n")
    f.write(" Positional arguments are:\n")
    f.write("  A    path to Matrix Market file for the matrix A\n")
    f.write("  x    optional path to Matrix Market file for the vector x\n")
    f.write("  y    optional path to Matrix Market file for the vector y\n\n")
    f.write(" Other options are:\n")
    f.write("  -z, --gzip, --gunzip, --ungzip    filter files through gzip\n")
    f.write("  --separate-diagonal       store diagonal nonzeros separately\n")
    f.write("  --sort-rows               sort nonzeros by column within each row\n")
    if csr:
        f.write("  --partition-rows          partition rows evenly among devices (default)\n")
        f.write("  --partition-nonzeros      partition nonzeros evenly among devices\n")
        f.write("  --precompute-partition    perform per-device partitioning once as a precomputation\n")
        f.write("  --rows-per-thread=N..     comma-separated list of rows assigned to devices\n")
        f.write("  --columns-per-thread=N..  accepted for compatibility (no HBM analogue)\n")
    f.write("  --repeat=N                repeat matrix-vector multiplication N times\n")
    f.write("  --warmup=N                perform N additional warmup iterations\n")
    f.write("  -q, --quiet               do not print Matrix Market output\n")
    f.write("  -v, --verbose             be more verbose\n\n")
    f.write(" Options for performance monitoring are:\n")
    f.write("  --papi-event-file=FILE    derived-metric definition file (formulas over\n")
    f.write("                            time/flops/bytes; see examples/membw.metrics)\n")
    f.write("  --papi-event-format=FMT   output format for metrics: plain or csv. [plain]\n")
    f.write("  --papi-event-per-thread   display metrics per device\n")
    f.write("  --papi-event-summary      display summary of performance monitoring\n\n")
    if csr:
        f.write(" Options for hardware cache/prefetch tuning are:\n")
        f.write("  --l1-prefetch-distance=N  accepted for compatibility (A64FX only)\n")
        f.write("  --l2-prefetch-distance=N  accepted for compatibility (A64FX only)\n\n")
    f.write(" Further options are:\n")
    f.write("  --precision=DTYPE         float64 (default), float32 or bfloat16\n")
    f.write("  --index-width=N           32 or 64 (default: auto; IDXTYPEWIDTH analogue)\n")
    f.write("  --protocol=P              per_iter (default) or chained timing\n")
    f.write("  --devices=N               shard rows across N mesh devices\n")
    f.write("  --trace=DIR               write a jax.profiler device trace of the\n")
    f.write("                            benchmark loop to DIR (PAPI-region analogue)\n")
    f.write("  --reorder=R               none (default) or rcm: bandwidth-reducing\n")
    f.write("                            reorder applied internally (output y unchanged)\n")
    if not csr:
        f.write("  --format=F                ell (default), auto (structural chooser:\n")
        f.write("                            dia, ell or csr), dia (stencil diagonals),\n")
        f.write("                            sell (sliced-ELL) or hybrid (hub columns +\n")
        f.write("                            sliced-ELL)\n")
    f.write("\n")
    f.write("  -h, --help                display this help and exit\n")
    f.write("  --version                 display version information and exit\n")
    f.write("\n")
    f.write(" Compiled kernels are cached persistently in\n")
    f.write(" $JAX_COMPILATION_CACHE_DIR, or else in .jax_cache at the root\n")
    f.write(" of the checkout.\n")


def print_version(program: str, f=None):
    f = f or sys.stdout
    import jax
    f.write(f"{program} {PROGRAM_VERSION} (ellspmv-jax)\n")
    f.write("row/column offsets: 32-bit or 64-bit (auto-selected)\n")
    f.write(f"jax: {jax.__version__}\n")
    try:
        devs = jax.devices()
        f.write(f"devices: {len(devs)} x {devs[0].device_kind}\n")
    except Exception:
        f.write("devices: unavailable\n")


def parse_args(argv: list[str], program: str, csr: bool) -> Options:
    opts = Options(program)
    positional = []
    i = 0
    only_positional = False

    def need_value(val, name, it):
        if val is None:
            nonlocal i
            i += 1
            if i >= len(argv):
                raise CliError(f"option '{name}' requires an argument")
            return argv[i]
        return val

    while i < len(argv):
        arg = argv[i]
        if only_positional or not arg.startswith("-") or arg == "-":
            positional.append(arg)
            i += 1
            continue
        if arg == "--":
            only_positional = True
            i += 1
            continue
        if arg in ("-h", "--help"):
            print_help(program, csr)
            raise SystemExit(0)
        if arg == "--version":
            print_version(program)
            raise SystemExit(0)
        if arg in ("-z", "--gzip", "--gunzip", "--ungzip"):
            opts.gzip = True
        elif arg == "--separate-diagonal":
            opts.separate_diagonal = True
        elif arg == "--sort-rows":
            opts.sort_rows = True
        elif arg in ("-q", "--quiet"):
            opts.quiet = True
        elif arg in ("-v", "--verbose"):
            opts.verbose += 1
        elif arg == "-vv":
            opts.verbose += 2
        elif (v := _split_eq(arg, "--repeat")) is not False:
            opts.repeat = int(need_value(v, "--repeat", i))
        elif (v := _split_eq(arg, "--warmup")) is not False:
            opts.warmup = int(need_value(v, "--warmup", i))
        elif csr and arg == "--partition-rows":
            opts.partition = "rows"
        elif csr and arg == "--partition-nonzeros":
            opts.partition = "nonzeros"
        elif csr and arg == "--precompute-partition":
            opts.precompute_partition = True
        elif csr and (v := _split_eq(arg, "--rows-per-thread")) is not False:
            v = need_value(v, "--rows-per-thread", i)
            opts.rows_per_thread = [int(s) for s in v.split(",") if s]
        elif csr and (v := _split_eq(arg, "--columns-per-thread")) is not False:
            v = need_value(v, "--columns-per-thread", i)
            opts.columns_per_thread = [int(s) for s in v.split(",") if s]
        elif csr and (v := _split_eq(arg, "--l1-prefetch-distance")) is not False:
            opts.l1_prefetch_distance = int(need_value(v, "--l1-prefetch-distance", i))
        elif csr and (v := _split_eq(arg, "--l2-prefetch-distance")) is not False:
            opts.l2_prefetch_distance = int(need_value(v, "--l2-prefetch-distance", i))
        elif (v := _split_eq(arg, "--papi-event-file")) is not False:
            opts.papi_event_file = need_value(v, "--papi-event-file", i)
        elif (v := _split_eq(arg, "--papi-event-format")) is not False:
            opts.papi_event_format = need_value(v, "--papi-event-format", i)
            if opts.papi_event_format not in ("plain", "csv"):
                raise CliError("--papi-event-format must be plain or csv")
        elif arg == "--papi-event-per-thread":
            opts.papi_event_per_thread = True
        elif arg == "--papi-event-summary":
            opts.papi_event_summary = True
        elif (v := _split_eq(arg, "--precision")) is not False:
            opts.precision = need_value(v, "--precision", i)
            if opts.precision not in ("float64", "float32", "bfloat16"):
                raise CliError("--precision must be float64, float32 or bfloat16")
        elif (v := _split_eq(arg, "--index-width")) is not False:
            opts.index_width = int(need_value(v, "--index-width", i))
            if opts.index_width not in (32, 64):
                raise CliError("--index-width must be 32 or 64")
        elif (v := _split_eq(arg, "--protocol")) is not False:
            opts.protocol = need_value(v, "--protocol", i)
            if opts.protocol not in ("per_iter", "chained"):
                raise CliError("--protocol must be per_iter or chained")
        elif (v := _split_eq(arg, "--devices")) is not False:
            opts.devices = int(need_value(v, "--devices", i))
        elif (v := _split_eq(arg, "--trace")) is not False:
            opts.trace_dir = need_value(v, "--trace", i)
        elif not csr and (v := _split_eq(arg, "--format")) is not False:
            opts.format = need_value(v, "--format", i)
            if opts.format not in ("auto", "ell", "dia", "sell", "hybrid"):
                raise CliError("--format must be auto, ell, dia, sell or "
                               "hybrid")
        elif (v := _split_eq(arg, "--reorder")) is not False:
            opts.reorder = need_value(v, "--reorder", i)
            if opts.reorder not in ("none", "rcm"):
                raise CliError("--reorder must be none or rcm")
        else:
            raise CliError(f"unrecognized option '{arg}'")
        i += 1

    if len(positional) > 3:
        raise CliError("too many positional arguments")
    if not positional:
        # mirror the reference: print usage and fail (ellspmv.c:607-610)
        sys.stderr.write(f"Usage: {program} [OPTION..] A [x] [y]\n")
        raise SystemExit(1)
    opts.A_path = positional[0]
    if len(positional) > 1:
        opts.x_path = positional[1]
    if len(positional) > 2:
        opts.y_path = positional[2]
    return opts


def run(argv: list[str], program: str, fmt: str) -> int:
    """Main body shared by both programs; `fmt` is 'ell' or 'csr'."""
    csr = fmt == "csr"
    try:
        opts = parse_args(argv, program, csr)
    except (CliError, ValueError) as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1

    log = sys.stderr
    import jax

    from ellspmv_jax.config import enable_compile_cache
    from ellspmv_jax.io.mtx import read_matrix, write_vector

    enable_compile_cache()
    if opts.precision == "float64":
        jax.config.update("jax_enable_x64", True)

    # Phase 2: read the matrix (timed, like ellspmv.c:1264-1377)
    t0 = time.perf_counter()
    try:
        coo = read_matrix(opts.A_path, gzipped=opts.gzip or None,
                          index_dtype=(f"int{opts.index_width}"
                                       if opts.index_width else None),
                          value_dtype=np.float64)
    except Exception as e:
        sys.stderr.write(f"{program}: {opts.A_path}: {e}\n")
        return 1
    t_read = time.perf_counter() - t0
    if opts.verbose:
        import os
        try:
            mb = os.path.getsize(opts.A_path) / 1e6
        except OSError:
            mb = 0.0
        log.write(f"mtxfile_read: {t_read:.6f} seconds ({mb / t_read:.1f} "
                  f"MB/s)\n")

    rc, y = execute(opts, coo, csr)
    if rc:
        return rc

    # Phase 6: write y to stdout (ellspmv.c:1898-1912)
    if not opts.quiet:
        t0 = time.perf_counter()
        write_vector(sys.stdout, np.asarray(y, dtype=np.float64))
        if opts.verbose:
            log.write(f"mtxfile_write: {time.perf_counter() - t0:.6f} "
                      "seconds\n")
    return 0


def execute(opts: Options, coo, csr: bool):
    """Phases 3-5 for a matrix already in memory: reorder, convert, load
    the vectors, benchmark, report. Returns (exit code, y), y in the
    caller's row order (None on failure)."""
    program = opts.program
    log = sys.stderr
    from ellspmv_jax.bench.harness import benchmark_spmv
    from ellspmv_jax.io.mtx import read_vector

    if (opts.columns_per_thread or opts.l1_prefetch_distance
            or opts.l2_prefetch_distance) and opts.verbose:
        log.write(f"{program}: note: NUMA/A64FX placement options have no "
                  "device analogue; ignored\n")
    if (opts.separate_diagonal and opts.format in ("dia", "sell", "hybrid")
            and opts.verbose):
        log.write(f"{program}: note: --format={opts.format} stores the "
                  "diagonal inline; --separate-diagonal ignored\n")
    if opts.format == "auto" and opts.verbose and not opts.sort_rows:
        log.write(f"{program}: note: --format=auto implies sorted rows\n")

    # Optional internal reordering (output-equivalent: x/y are permuted at
    # the edges). Square matrices only.
    reorder_map = None
    if opts.reorder == "rcm":
        if coo.num_rows != coo.num_columns:
            sys.stderr.write(f"{program}: --reorder=rcm needs a square "
                             "matrix\n")
            return 1, None
        from ellspmv_jax.models.reorder import reorder_rcm
        t0 = time.perf_counter()
        reorder_map = reorder_rcm(coo)
        coo = reorder_map.coo
        if opts.verbose:
            log.write(f"reorder_rcm: {time.perf_counter() - t0:.6f} "
                      "seconds\n")

    # Phase 3: convert (timed, like ellspmv.c:1379-1486). Wrapped so a
    # padding blowup (ELLPACK on a power-law matrix can demand rows x
    # max-row-nnz slots) reports cleanly like the reference's malloc
    # failure paths (ellspmv.c:1418-1424) instead of a traceback.
    t0 = time.perf_counter()
    try:
        mat, convert_name, per_row = _convert(coo, opts, csr, program)
    except MemoryError as e:
        sys.stderr.write(
            f"{program}: conversion failed: {e}\n"
            f"{program}: hint: --format=auto or csrspmv avoid ELLPACK "
            "padding on skewed matrices\n")
        return 1, None
    except _ConvertError as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1, None
    t_conv = time.perf_counter() - t0
    if opts.verbose:
        log.write(f"{convert_name}: {t_conv:.6f} seconds, "
                  f"{mat.num_rows:,} rows, {mat.num_nonzeros:,} nonzeros"
                  f"{per_row}\n")

    # Phase 4: vectors
    try:
        if opts.x_path:
            x = read_vector(opts.x_path, gzipped=opts.gzip or None)
            if len(x) != mat.num_columns:
                sys.stderr.write(
                    f"{program}: {opts.x_path}: expected vector of length "
                    f"{mat.num_columns}, got {len(x)}\n")
                return 1, None
        else:
            x = np.ones(mat.num_columns)   # ellspmv.c:1502-1505
        if opts.y_path:
            y = read_vector(opts.y_path, gzipped=opts.gzip or None)
            if len(y) != mat.num_rows:
                sys.stderr.write(
                    f"{program}: {opts.y_path}: expected vector of length "
                    f"{mat.num_rows}, got {len(y)}\n")
                return 1, None
            y = y.astype(opts.precision)
        else:
            y = None                        # zeros (ellspmv.c:1610-1613)
    except Exception as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1, None
    x = x.astype(opts.precision)
    if reorder_map is not None:
        x = reorder_map.permute_x(x)
        if y is not None:
            y = reorder_map.permute_x(y)   # same row permutation

    # Sharded path when requested
    if opts.devices > 1:
        from ellspmv_jax.parallel.spmv import shard_matrix, sharded_spmv_fn
        try:
            sharded = shard_matrix(
                mat, opts.devices,
                partition=opts.partition,
                rows_per_device=opts.rows_per_thread)
        except (TypeError, ValueError) as e:
            sys.stderr.write(f"{program}: {e}\n")
            return 1, None
        spmv_fn = sharded_spmv_fn(sharded)
        mat_for_bench = sharded
        if opts.verbose >= 2:
            for line in sharded.workload_report():
                log.write(line + "\n")
        if opts.verbose:
            # min/max workload summary at verbose>=1 (csrspmv.c:2225-2285)
            for line in _workload_summary(sharded):
                log.write(line + "\n")
    else:
        mat = mat.device_put()
        spmv_fn = None                      # library dispatch
        mat_for_bench = mat

    # Phase 5: benchmark (warmup + timed loop, ellspmv.c:1745-1876)
    kernel_name = _kernel_name(csr, opts, mat)
    from ellspmv_jax.utils.trace import device_trace
    try:
        with device_trace(opts.trace_dir):
            res = benchmark_spmv(spmv_fn, mat_for_bench, x, y,
                                 repeat=opts.repeat, warmup=opts.warmup,
                                 protocol=opts.protocol, metrics_matrix=mat)
    except Exception as e:
        sys.stderr.write(f"{program}: benchmark failed: {e}\n")
        return 1, None
    if opts.verbose:
        for line in res.iteration_lines():
            log.write(f"{kernel_name}: {line}\n")
    try:
        if opts.papi_event_file:
            from ellspmv_jax.bench import metrics as metrics_mod
            try:
                mfile = metrics_mod.read_metrics_file(opts.papi_event_file)
                metrics_mod.report(
                    mfile, metrics_mod.base_events(res, opts.devices), log,
                    fmt=opts.papi_event_format, region=kernel_name)
            except (OSError, metrics_mod.MetricsError) as e:
                sys.stderr.write(f"{program}: {opts.papi_event_file}: {e}\n")
                return 1, None
        if opts.papi_event_summary:
            _metrics_report(res, opts, log)
    except ValueError as e:     # no published peak for this device kind
        sys.stderr.write(f"{program}: {e}\n")
        return 1, None
    if opts.papi_event_per_thread and opts.devices > 1:
        # per-device breakdown (the papi per-thread rows analogue,
        # papi_util.c:692-712): measured per-shard kernel micro-runs
        _per_device_report(res, sharded, opts, log, coo, csr)
    elif opts.papi_event_per_thread:
        log.write(f"{program}: note: --papi-event-per-thread with one "
                  "device: the whole-matrix region IS the per-device row "
                  "(use --devices=N for a breakdown)\n")

    y_out = res.y
    if reorder_map is not None:
        y_out = reorder_map.unpermute_y(np.asarray(y_out))
    return 0, y_out


def _kernel_name(csr: bool, opts, mat) -> str:
    """Kernel label in the reference's naming (gemv/gemvsd/gemv16, README:133
    output; csrgemv variants csrspmv.c:2851-2868)."""
    if not csr:
        from ellspmv_jax.formats.csr import CsrMatrix
        from ellspmv_jax.formats.dia import DiaMatrix
        if opts.format == "auto":
            if isinstance(mat, DiaMatrix):
                return "gemv_dia"
            if isinstance(mat, CsrMatrix):
                return "gemv_csr"
        elif opts.format not in (None, "ell"):
            return f"gemv_{opts.format}"
        if opts.separate_diagonal and mat.rowsize == 16:
            return "gemv16"
        return "gemvsd" if opts.separate_diagonal else "gemv"
    if opts.partition == "nonzeros":
        return "csrgemvnz"
    if opts.rows_per_thread:
        return "csrgemvrp"
    return "csrgemvsd" if opts.separate_diagonal else "csrgemv"


def _metrics_report(res, opts, log):
    """Roofline summary — the stand-in for the PAPI region report
    (papi_util.c:424-494), honoring the plain/csv format switch."""
    m = res.metrics
    t = res.best
    act = res.actual_gb_per_s()
    if opts.papi_event_format == "csv":
        log.write("region,repeat,time,nonzeros,flops,min_bytes,max_bytes,"
                  "gnz_per_s,gflop_per_s,min_gb_per_s,max_gb_per_s,"
                  "hbm_peak_gb_per_s,roofline_fraction,"
                  "actual_bytes,actual_gb_per_s,physical_roofline\n")
        log.write(f"gemv,{len(res.times)},{t:.9f},{m.num_nonzeros},"
                  f"{m.num_flops},{m.min_bytes},{m.max_bytes},"
                  f"{res.gnz_per_s():.3f},{res.gflop_per_s():.3f},"
                  f"{res.min_gb_per_s():.3f},{res.max_gb_per_s():.3f},"
                  f"{res.hbm_peak / 1e9:.1f},"
                  f"{res.roofline_fraction():.4f},"
                  + ("," if act is None else
                     f"{res.actual_bytes},{act:.3f},"
                     f"{res.physical_roofline():.4f}") + "\n")
        return
    log.write("Region: gemv\n")
    log.write(f"  iterations: {len(res.times)}\n")
    log.write(f"  best time: {t:.9f} s\n")
    log.write(f"  nonzeros: {m.num_nonzeros:,}  flops/iter: {m.num_flops:,}\n")
    log.write(f"  bytes/iter: {m.min_bytes:,} (x once) to {m.max_bytes:,} "
              "(x per nonzero)\n")
    log.write(f"  throughput: {res.gnz_per_s():.3f} Gnz/s, "
              f"{res.gflop_per_s():.3f} Gflop/s\n")
    log.write(f"  effective bandwidth: {res.min_gb_per_s():.1f} to "
              f"{res.max_gb_per_s():.1f} GB/s\n")
    log.write(f"  HBM roofline: {res.hbm_peak / 1e9:.1f} GB/s peak -> "
              f"{100 * res.roofline_fraction():.1f}% of peak "
              "(min-bytes model; formats that store less than ELLPACK can "
              "exceed 100%)\n")
    if act is not None:
        log.write(f"  stored traffic: {res.actual_bytes:,} bytes/iter "
                  f"(format arrays + x + y) -> {act:.1f} GB/s = "
                  f"{100 * res.physical_roofline():.1f}% of raw HBM\n")


def _workload_summary(sharded) -> list[str]:
    """Min/max rows and nonzeros per device — the verbose>=1 summary the
    reference computes with OpenMP reductions (csrspmv.c:2225-2285)."""
    rows = sharded.workload_report()
    rows_per = [int(r.split()[1]) for r in rows[1:]]
    nnz_per = [int(r.split()[2]) for r in rows[1:]]
    return [
        f"rows per device: min {min(rows_per):,} max {max(rows_per):,}",
        f"nonzeros per device: min {min(nnz_per):,} max {max(nnz_per):,}",
    ]


def _per_device_times(sharded, opts, coo, csr):
    """Measured per-shard kernel times: each device's row block is
    converted with the run's format settings and micro-benchmarked one
    shard at a time on one chip, so imbalance shows as time. Replaces the
    reference's per-thread PAPI counters (papi_util.c:672-730) with
    measured numbers. Timing: iterations chained through y inside one jit
    (x perturbed by eps*y[0] with eps=0 at runtime, so XLA cannot hoist
    the loop-invariant SpMV), two loop lengths, slope — dispatch-free."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ellspmv_jax.formats.coo import CooMatrix
    from ellspmv_jax.ops import spmv

    bounds = sharded.boundaries
    times = []
    for d in range(len(bounds) - 1):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        sel = (coo.rowidx >= lo) & (coo.rowidx < hi)
        sub = CooMatrix(max(hi - lo, 1), coo.num_columns,
                        (coo.rowidx[sel] - lo).astype(coo.rowidx.dtype),
                        coo.colidx[sel], coo.values[sel])
        try:
            mat_d, _, _ = _convert(sub, opts, csr, opts.program)
            mat_d = mat_d.device_put()
            x = jnp.asarray(np.ones(sub.num_columns, opts.precision))
            y0 = jnp.zeros(sub.num_rows, opts.precision)
            eps = jnp.asarray(0.0, x.dtype)

            @jax.jit
            def loop(op, xv, y, e, iters):
                def body(_, yk):
                    return spmv(op, xv * (1 + e * yk[0]), yk)
                return jax.lax.fori_loop(0, iters, body, y)

            t = float("inf")
            sync = jax.block_until_ready
            sync(loop(mat_d, x, y0, eps, 2))
            sync(loop(mat_d, x, y0, eps, 10))
            for _ in range(2):
                t0 = time.perf_counter()
                sync(loop(mat_d, x, y0, eps, 2))
                t_lo = time.perf_counter() - t0
                t0 = time.perf_counter()
                sync(loop(mat_d, x, y0, eps, 10))
                t_hi = time.perf_counter() - t0
                t = min(t, max((t_hi - t_lo) / 8, 1e-12))
            times.append(t)
        except Exception:
            times.append(float("nan"))
    return times


def _per_device_report(res, sharded, opts, log, coo, csr):
    rows = sharded.workload_report()
    t_dev = _per_device_times(sharded, opts, coo, csr)
    if opts.papi_event_format == "csv":
        log.write("device,rows,nonzeros,measured_s,gnz_per_s\n")
        for line, t in zip(rows[1:], t_dev):
            d, r, nnz = line.split()
            gnz = int(nnz) / t * 1e-9 if t == t and t > 0 else 0.0
            log.write(f"{d},{r},{nnz},{t:.9f},{gnz:.3f}\n")
        return
    log.write("Per-device workload (measured per-shard micro-runs, one "
              "shard at a time):\n")
    log.write("  " + rows[0] + "   measured    Gnz/s\n")
    for line, t in zip(rows[1:], t_dev):
        d, r, nnz = line.split()
        gnz = int(nnz) / t * 1e-9 if t == t and t > 0 else 0.0
        log.write(f"  {d:<7s} {r:<10s} {nnz:<10s} "
                  f"{t * 1e3:8.3f} ms  {gnz:.3f}\n")


class _ConvertError(RuntimeError):
    pass


def _convert(coo, opts, csr, program):
    from ellspmv_jax.formats.csr import csr_from_coo
    from ellspmv_jax.formats.ell import ell_from_coo
    if csr:
        mat = csr_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                           sort_rows=opts.sort_rows,
                           value_dtype=opts.precision,
                           index_dtype=(f"int{opts.index_width}"
                                        if opts.index_width else None))
        convert_name = "csr_from_coo"
        per_row = (f", {mat.rowsize_min} to {mat.rowsize_max} "
                   f"nonzeros per row")
    elif opts.format == "auto":
        from ellspmv_jax.formats.auto import auto_from_coo
        mat = auto_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                            sort_rows=opts.sort_rows,
                            value_dtype=opts.precision,
                            index_dtype=(f"int{opts.index_width}"
                                         if opts.index_width else None),
                            allow_dia=opts.devices <= 1)
        convert_name = f"auto_from_coo [{mat._auto_choice}]"
        per_row = f", {mat._auto_reason}"
    elif opts.format == "dia":
        from ellspmv_jax.formats.dia import dia_from_coo
        mat = dia_from_coo(coo, value_dtype=opts.precision)
        if mat is None:
            raise _ConvertError("--format=dia: matrix has too many "
                                "distinct diagonals for DIA")
        convert_name = "dia_from_coo"
        per_row = f", {mat.data.shape[0]} diagonals"
    elif opts.format == "sell":
        from ellspmv_jax.formats.sell import sell_from_coo
        mat = sell_from_coo(coo, sort_rows=True, length_sort=True,
                            value_dtype=opts.precision,
                            index_dtype=(f"int{opts.index_width}"
                                         if opts.index_width else None))
        convert_name = "sell_from_coo"
        per_row = f", {len(mat.buckets)} slice buckets"
    elif opts.format == "hybrid":
        from ellspmv_jax.formats.hybrid import hybrid_from_coo
        mat = hybrid_from_coo(coo, value_dtype=opts.precision,
                              index_dtype=(f"int{opts.index_width}"
                                           if opts.index_width else None))
        convert_name = "hybrid_from_coo"
        per_row = f", hub fraction {mat.hub_nnz_fraction:.2f}"
    else:
        mat = ell_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                           sort_rows=opts.sort_rows,
                           value_dtype=opts.precision,
                           index_dtype=(f"int{opts.index_width}"
                                        if opts.index_width else None))
        convert_name = "ell_from_coo"
        per_row = f", {mat.rowsize} nonzeros per row"
    return mat, convert_name, per_row
