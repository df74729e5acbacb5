"""`cgsolve` — conjugate-gradient solve over the SpMV kernels.

The reference has no solver, but its y-accumulation contract exists so runs
can be chained (SURVEY §5 checkpoint/resume); the driver's north-star
config asks for a CG loop over the row-sharded SpMV (BASELINE configs[4]).
This CLI solves A x = b for SPD A:

    cgsolve [OPTION..] A [b]

Options mirror the SpMV CLIs where they apply (gzip, precision, devices,
reorder) plus --tol and --maxiter. Prints x as a Matrix Market vector.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ellspmv_jax.cli.common import CliError, _split_eq


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    program = "cgsolve"
    gzip_flag = False
    tol = 1e-8
    maxiter = 1000
    precision = "float64"
    devices = 1
    reorder = "none"
    verbose = 0
    quiet = False
    positional = []
    i = 0
    try:
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("-"):
                positional.append(arg)
            elif arg in ("-z", "--gzip", "--gunzip", "--ungzip"):
                gzip_flag = True
            elif arg in ("-q", "--quiet"):
                quiet = True
            elif arg in ("-v", "--verbose"):
                verbose += 1
            elif (v := _split_eq(arg, "--tol")) is not False:
                tol = float(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--maxiter")) is not False:
                maxiter = int(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--precision")) is not False:
                precision = v if v is not None else argv[(i := i + 1)]
            elif (v := _split_eq(arg, "--devices")) is not False:
                devices = int(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--reorder")) is not False:
                reorder = v if v is not None else argv[(i := i + 1)]
            elif arg in ("-h", "--help"):
                sys.stdout.write(__doc__)
                return 0
            else:
                raise CliError(f"unrecognized option '{arg}'")
            i += 1
        if not positional:
            sys.stderr.write(f"Usage: {program} [OPTION..] A [b]\n")
            return 1
    except (CliError, ValueError, IndexError) as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1

    import jax

    from ellspmv_jax.config import enable_compile_cache
    from ellspmv_jax.io.mtx import read_matrix, read_vector, write_vector

    enable_compile_cache()
    if precision == "float64":
        jax.config.update("jax_enable_x64", True)

    try:
        coo = read_matrix(positional[0], gzipped=gzip_flag or None)
    except Exception as e:
        sys.stderr.write(f"{program}: {positional[0]}: {e}\n")
        return 1
    if coo.num_rows != coo.num_columns:
        sys.stderr.write(f"{program}: CG needs a square (SPD) matrix\n")
        return 1
    n = coo.num_rows
    if len(positional) > 1:
        b = read_vector(positional[1], gzipped=gzip_flag or None)
        if len(b) != n:
            sys.stderr.write(f"{program}: b has length {len(b)}, "
                             f"expected {n}\n")
            return 1
    else:
        b = np.ones(n)
    b = b.astype(precision)

    t0 = time.perf_counter()
    try:
        res = solve(coo, b, tol=tol, maxiter=maxiter, precision=precision,
                    devices=devices, reorder=reorder)
    except ValueError as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1
    x = np.asarray(res.x, np.float64)
    dt = time.perf_counter() - t0
    if verbose:
        sys.stderr.write(
            f"cg: {int(res.iterations)} iterations, residual "
            f"{float(res.residual_norm):.3e}, {dt:.3f} seconds\n")
    if not quiet:
        write_vector(sys.stdout, x)
    return 0 if float(res.residual_norm) <= tol * np.linalg.norm(b) * 10 \
        else 2


def solve(coo, b, tol: float = 1e-8, maxiter: int = 1000,
          precision: str = "float64", devices: int = 1,
          reorder: str = "none"):
    """CG on A x = b with `coo` converted to sorted-row ELLPACK, on one
    device or row-sharded over `devices`. Returns a CgResult whose x is in
    the caller's row order."""
    import jax.numpy as jnp

    from ellspmv_jax.formats.ell import ell_from_coo
    from ellspmv_jax.models.solvers import cg
    from ellspmv_jax.ops import spmv

    rm = None
    if reorder == "rcm":
        from ellspmv_jax.models.reorder import reorder_rcm
        rm = reorder_rcm(coo)
        coo = rm.coo
        b = rm.permute_x(b)

    ell = ell_from_coo(coo, sort_rows=True, value_dtype=precision)
    b = jnp.asarray(b, precision)
    if devices > 1:
        from ellspmv_jax.parallel.spmv import shard_matrix, sharded_spmv_fn
        sm = shard_matrix(ell, devices)
        operand, fn = sharded_spmv_fn(sm).traceable
        res = cg(fn, b, tol=tol, maxiter=maxiter, operand=operand)
    else:
        res = cg(spmv, b, tol=tol, maxiter=maxiter,
                 operand=ell.device_put())
    if rm is not None:
        res = res._replace(x=rm.unpermute_y(np.asarray(res.x)))
    return res


if __name__ == "__main__":
    raise SystemExit(main())
