"""Least-absolute-deviations (L1) regression via ADMM.

Reference: vlindex `SolveLeastAbsoluteDeviations`
(optim/least_absolute_deviations.{h,cc}) — ADMM for min ||Ax - b||_1
after Boyd et al., "Distributed Optimization and Statistical Learning
via the Alternating Direction Method of Multipliers" (the reference
cites the Stanford lad.m reference implementation). The reference
solves a sparse Eigen system with a cached sparse Cholesky; here A is
dense and the normal equations are prefactorized once with a dense
Cholesky — the per-iteration work is then two matmuls and two
triangular solves, all accelerator friendly, inside a lax.while_loop with
the reference's absolute/relative stopping rule.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LADResult(NamedTuple):
    x: jax.Array            # [D] solution
    iterations: jax.Array   # scalar int32
    converged: jax.Array    # scalar bool


@partial(jax.jit, static_argnames=("max_iters",))
def solve_lad(A, b, x0=None, *, rho: float = 1.0, alpha: float = 1.0,
              max_iters: int = 1000, absolute_tolerance: float = 1e-4,
              relative_tolerance: float = 1e-2) -> LADResult:
    """Solve min_x ||A x - b||_1 for dense A [N, D], b [N].

    Defaults mirror LeastAbsoluteDeviationsOptions
    (least_absolute_deviations.h:42-56): rho=1, over-relaxation
    alpha in [1, 1.8], Boyd's primal/dual residual stopping rule.
    x0 optionally warm-starts the solver (the reference initializes
    from the caller's vector).
    """
    A = jnp.asarray(A, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    n, d = A.shape
    x = jnp.zeros((d,), jnp.float32) if x0 is None else jnp.asarray(
        x0, jnp.float32)

    # Prefactorize A^T A (the reference caches a sparse Cholesky of the
    # same normal matrix). Small ridge keeps rank-deficient A solvable.
    AtA = A.T @ A + 1e-8 * jnp.eye(d, dtype=jnp.float32)
    L = jnp.linalg.cholesky(AtA)

    def solve_normal(rhs):
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    def shrink(v, kappa):
        return jnp.sign(v) * jnp.maximum(jnp.abs(v) - kappa, 0.0)

    z = A @ x - b
    u = jnp.zeros((n,), jnp.float32)

    def cond(state):
        _, _, _, it, done = state
        return (it < max_iters) & ~done

    def body(state):
        x, z, u, it, _ = state
        # x-update: argmin_x (rho/2)||Ax - b - z + u||^2
        x_new = solve_normal(A.T @ (b + z - u))
        Ax = A @ x_new
        Ax_hat = alpha * Ax + (1.0 - alpha) * (z + b)   # over-relaxation
        z_old = z
        z_new = shrink(Ax_hat - b + u, 1.0 / rho)
        u_new = u + (Ax_hat - z_new - b)
        # Boyd's stopping criterion (lad.m): primal r = Ax - z - b,
        # dual s = -rho * A^T (z - z_old)
        r_norm = jnp.linalg.norm(Ax - z_new - b)
        s_norm = jnp.linalg.norm(-rho * (A.T @ (z_new - z_old)))
        # eps_pri uses max(||Ax||, ||z||, ||b||) — the reference
        # (least_absolute_deviations.cc / lad.m) includes ||b||
        eps_pri = (jnp.sqrt(float(n)) * absolute_tolerance
                   + relative_tolerance * jnp.maximum(
                       jnp.maximum(jnp.linalg.norm(Ax),
                                   jnp.linalg.norm(z_new)),
                       jnp.linalg.norm(b)))
        eps_dual = (jnp.sqrt(float(d)) * absolute_tolerance
                    + relative_tolerance * jnp.linalg.norm(rho * (A.T @ u_new)))
        done = (r_norm < eps_pri) & (s_norm < eps_dual)
        return x_new, z_new, u_new, it + 1, done

    x, z, u, it, done = jax.lax.while_loop(
        cond, body, (x, z, u, jnp.int32(0), jnp.bool_(False)))
    return LADResult(x=x, iterations=it, converged=done)
