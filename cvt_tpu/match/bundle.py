"""Bundle adjustment: matrix-free Levenberg-Marquardt, batched.

Reference: vlindex/src/optim/bundle_adjustment.cc (Ceres solver over
reprojection residuals) and lib/PBA (CUDA parallel bundle adjustment —
ProgramCU.cu implements exactly this matrix-free normal-equation CG on
the GPU). Redesign: poses are axis-angle 6-vectors, points
are [P, 3]; residuals are one masked [O, 2] tensor over a static
observation list; the LM inner solve is conjugate gradient with
J^T J products computed by jvp/vjp (no Jacobian ever materialized), so
the whole optimizer is one fixed-shape `lax.scan` — XLA fuses each CG
step into a handful of matmul-shaped passes over the observations.

Gauge freedom is fixed by freezing the first `n_fixed_poses` cameras.
Robust (Huber) weighting is applied by IRLS rescaling of residuals.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-12


def rodrigues(rvec: jax.Array) -> jax.Array:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Uses sin(t)/t and (1-cos t)/t^2 forms on the UNNORMALIZED cross
    matrix so the map is smooth (and differentiable) at rvec = 0 —
    plain normalize-then-Rodrigues has a NaN gradient at the identity,
    which poisons BA problems whose first camera is at the origin.
    """
    sq = jnp.sum(rvec * rvec, axis=-1, keepdims=True)
    small = sq < 1e-8
    # safe-where: the untaken branch must still have finite gradients,
    # so divide by a clamped sq and Taylor-expand the small branch
    sq_safe = jnp.where(small, 1.0, sq)
    theta = jnp.sqrt(sq_safe)
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = jnp.zeros_like(x)
    kmat = jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1)], -2)        # [t]_x, unnormalized
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), kmat.shape)
    a = jnp.where(small, 1.0 - sq / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - sq / 24.0,
                  (1.0 - jnp.cos(theta)) / sq_safe)
    return (eye + a[..., None] * kmat
            + b[..., None] * jnp.matmul(kmat, kmat))


def rotation_to_rvec(r: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    tr = jnp.trace(r, axis1=-2, axis2=-1)
    cos_t = jnp.clip((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    axis = jnp.stack([r[..., 2, 1] - r[..., 1, 2],
                      r[..., 0, 2] - r[..., 2, 0],
                      r[..., 1, 0] - r[..., 0, 1]], -1)
    axis = axis / jnp.maximum(
        jnp.linalg.norm(axis, axis=-1, keepdims=True), _EPS)
    return axis * theta[..., None]


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem.

    poses   [C, 6]  : (rvec, tvec) world->camera
    points  [P, 3]  : 3D points
    cam_idx [O]     : observation -> camera
    pt_idx  [O]     : observation -> point
    uv      [O, 2]  : observed NORMALIZED image coords
    mask    [O]     : 1.0 for real observations, 0.0 for padding
    """
    poses: jax.Array
    points: jax.Array
    cam_idx: jax.Array
    pt_idx: jax.Array
    uv: jax.Array
    mask: jax.Array


def _residuals(poses, points, cam_idx, pt_idx, uv, mask, huber_delta):
    rv = poses[cam_idx, :3]
    tv = poses[cam_idx, 3:]
    x = points[pt_idx]
    cam = jnp.einsum("oij,oj->oi", rodrigues(rv), x) + tv
    z = jnp.where(jnp.abs(cam[..., 2:3]) < _EPS, _EPS, cam[..., 2:3])
    proj = cam[..., :2] / z
    r = (proj - uv) * mask[..., None]
    if huber_delta is not None:
        # IRLS sqrt-weight: w = sqrt(huber'(|r|)/|r|), scales residual rows
        nrm = jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), _EPS)
        w = jnp.sqrt(jnp.minimum(1.0, huber_delta / nrm))
        r = r * jax.lax.stop_gradient(w)
    return r


@partial(jax.jit, static_argnames=("iters", "cg_iters", "n_fixed_poses",
                                   "huber_delta"))
def bundle_adjust(problem: BAProblem, *, iters: int = 20,
                  cg_iters: int = 30, n_fixed_poses: int = 1,
                  huber_delta: float | None = None,
                  init_lambda: float = 1e-3):
    """Run LM; returns (poses [C,6], points [P,3], final_cost scalar).

    Each LM iteration: solve (J^T J + lam*diag) d = -J^T r by CG with
    jvp/vjp matvecs, accept the step iff the true cost decreases
    (lam /= 3 on accept, *= 9 on reject) — a fixed-iteration, branch-free
    restatement of Ceres/PBA's trust-region loop.
    """
    cam_idx = problem.cam_idx
    pt_idx = problem.pt_idx
    uv = problem.uv
    mask = problem.mask.astype(problem.uv.dtype)
    pose_free = (jnp.arange(problem.poses.shape[0]) >=
                 n_fixed_poses).astype(problem.poses.dtype)[:, None]

    def res_fn(params):
        poses, points = params
        return _residuals(poses, points, cam_idx, pt_idx, uv, mask,
                          huber_delta)

    def cost_fn(params):
        r = res_fn(params)
        return 0.5 * jnp.sum(r * r)

    def mask_update(d):
        # jnp.where (not multiply) so NaN/inf in frozen entries is killed
        dp, dx = d
        return (jnp.where(pose_free > 0, dp, 0.0), dx)

    def jtj_matvec(params, v, lam, diag):
        _, jv = jax.jvp(res_fn, (params,), (v,))
        (_, vjp) = jax.vjp(res_fn, params)
        (jtjv,) = vjp(jv)
        jtjv = mask_update(jtjv)
        return jax.tree.map(lambda a, b, dg: a + lam * dg * b,
                            jtjv, v, diag)

    def cg_solve(params, rhs, lam, diag):
        """Jacobi-preconditioned CG on the damped normal equations."""
        precon = jax.tree.map(
            lambda dg: 1.0 / (dg * (1.0 + lam) + 1e-8), diag)
        x0 = jax.tree.map(jnp.zeros_like, rhs)

        def dot(a, b):
            return sum(jnp.vdot(x, y) for x, y in
                       zip(jax.tree.leaves(a), jax.tree.leaves(b)))

        def papply(z):
            return jax.tree.map(lambda m, a: m * a, precon, z)

        z0 = papply(rhs)

        def body(carry, _):
            x, r, z, p, rz = carry
            ap = jtj_matvec(params, p, lam, diag)
            alpha = rz / jnp.maximum(dot(p, ap), _EPS)
            x = jax.tree.map(lambda a, b: a + alpha * b, x, p)
            r = jax.tree.map(lambda a, b: a - alpha * b, r, ap)
            z = papply(r)
            rz_new = dot(r, z)
            beta = rz_new / jnp.maximum(rz, _EPS)
            p = jax.tree.map(lambda a, b: a + beta * b, z, p)
            return (x, r, z, p, rz_new), None

        (x, _, _, _, _), _ = jax.lax.scan(
            body, (x0, rhs, z0, z0, dot(rhs, z0)), None, length=cg_iters)
        return x

    def gn_diag(params):
        """Exact diag(J^T J) from per-observation Jacobians: each
        observation touches one pose (2x6 block) and one point (2x3),
        so column-square sums scatter-add by cam/pt index (the Marquardt
        scaling PBA uses)."""
        poses, points = params

        def obs_res(pose6, pt3, uv_o, m_o):
            cam = rodrigues(pose6[:3]) @ pt3 + pose6[3:]
            z = jnp.where(jnp.abs(cam[2]) < _EPS, _EPS, cam[2])
            return (cam[:2] / z - uv_o) * m_o

        jc, jp = jax.vmap(jax.jacfwd(obs_res, argnums=(0, 1)))(
            poses[cam_idx], points[pt_idx], uv, mask)        # [O,2,6],[O,2,3]
        dc = jax.ops.segment_sum(jnp.sum(jc * jc, axis=1), cam_idx,
                                 num_segments=poses.shape[0])
        dp = jax.ops.segment_sum(jnp.sum(jp * jp, axis=1), pt_idx,
                                 num_segments=points.shape[0])
        return (jnp.maximum(dc, 1e-6) * pose_free + (1.0 - pose_free),
                jnp.maximum(dp, 1e-6))

    def lm_step(carry, _):
        params, lam, cost = carry
        r = res_fn(params)
        (_, vjp) = jax.vjp(res_fn, params)
        (grad,) = vjp(r)
        grad = mask_update(grad)
        rhs = jax.tree.map(lambda g: -g, grad)
        diag = gn_diag(params)
        d = cg_solve(params, rhs, lam, diag)
        d = mask_update(d)
        new_params = jax.tree.map(lambda a, b: a + b, params, d)
        new_cost = cost_fn(new_params)
        accept = new_cost < cost
        params = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), params, new_params)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam / 3.0, lam * 9.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (params, lam, cost), cost

    params0 = (problem.poses.astype(jnp.float32),
               problem.points.astype(jnp.float32))
    cost0 = cost_fn(params0)
    (params, _, cost), _ = jax.lax.scan(
        lm_step, (params0, jnp.float32(init_lambda), cost0), None,
        length=iters)
    return params[0], params[1], cost
