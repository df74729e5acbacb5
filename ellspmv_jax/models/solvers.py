"""Iterative solvers on top of the SpMV kernels.

The reference has no solver; its y-accumulation contract ("runs can be
chained through files", SURVEY §5 checkpoint/resume) is the seed of one.
The driver's north-star config (BASELINE.json configs[4]) asks for a CG
iteration loop over the row-sharded SpMV — dot products are the only
additional communication (`psum` over the mesh, inserted automatically by
XLA when the operands carry shardings).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CgResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array      # int32
    residual_norm: jax.Array   # ||r||_2 of the recurrence residual


@partial(jax.jit, static_argnames=("matvec", "maxiter"))
def _cg_impl(matvec: Callable, b, x0, operand, tol: float,
             maxiter: int) -> CgResult:
    mv = (lambda v: matvec(operand, v)) if operand is not None else matvec
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    p = r
    rs = jnp.vdot(r, r)
    tol2 = jnp.asarray(tol, rs.dtype) ** 2 * jnp.vdot(b, b)

    def cond(state):
        _, _, _, rs, k = state
        return (rs > tol2) & (k < maxiter)

    def body(state):
        x, r, p, rs, k = state
        ap = mv(p)
        alpha = rs / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, k + 1

    x, r, p, rs, k = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0, jnp.int32)))
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rs))


def cg(matvec: Callable, b, x0=None, tol: float = 1e-8,
       maxiter: int = 1000, operand=None) -> CgResult:
    """Conjugate gradient for SPD A, fully jittable (`lax.while_loop`).

    `matvec(v) -> A v` may be a single-device kernel or the sharded SpMV;
    in the sharded case every `jnp.vdot` below becomes a cross-device
    reduction — the entire comm surface of distributed CG (SURVEY §5).

    For large matrices pass `operand` (a pytree of the matrix data) and a
    `matvec(operand, v)` so the data enters the compiled solver as jit
    arguments rather than multi-hundred-MB embedded constants — e.g.
    `cg(lambda A, v: ops.spmv(A, v), b, operand=A)`.
    """
    return _cg_impl(matvec, b, x0, operand, tol, maxiter)
