"""Camera models: project / unproject with distortion, fully batched.

Reference: vlindex/src/base/camera_models.h — COLMAP's 10 camera models
expose WorldToImage / ImageToWorld per model with distortion handled by
an iterative undistort. Redesign: each model is a pair of
pure functions over [..., 2] point arrays; undistortion uses a
fixed-iteration Newton loop (no data-dependent control flow), so the
whole thing vmaps/jits over batches of cameras and points.

Params layout (trailing axis of `params`), matching COLMAP's ordering:
  pinhole               : fx, fy, cx, cy
  simple_pinhole        : f, cx, cy
  simple_radial         : f, cx, cy, k
  radial                : f, cx, cy, k1, k2
  opencv                : fx, fy, cx, cy, k1, k2, p1, p2
  full_opencv           : fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
  opencv_fisheye        : fx, fy, cx, cy, k1, k2, k3, k4
  fov                   : fx, fy, cx, cy, omega
  simple_radial_fisheye : f, cx, cy, k
  radial_fisheye        : f, cx, cy, k1, k2
  thin_prism_fisheye    : fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1

For the fisheye family the equidistant theta-mapping is folded into the
distortion map, so the one generic Newton loop inverts the full model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MODELS = ("simple_pinhole", "pinhole", "simple_radial", "radial", "opencv",
          "full_opencv", "opencv_fisheye", "fov", "simple_radial_fisheye",
          "radial_fisheye", "thin_prism_fisheye")

_NEWTON_ITERS = 10
_EPS = 1e-8


def _focal_principal(model: str, params):
    if model in ("simple_pinhole", "simple_radial", "radial",
                 "simple_radial_fisheye", "radial_fisheye"):
        f = params[..., 0:1]
        return jnp.concatenate([f, f], -1), params[..., 1:3]
    # fx, fy, cx, cy family
    return params[..., 0:2], params[..., 2:4]


def _fisheye_scale(xy):
    """Equidistant fisheye mapping factor: theta/r (==1 at r->0)."""
    r2 = jnp.sum(jnp.square(xy), axis=-1)
    r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
    theta = jnp.arctan(r)
    return jnp.where(r2 > _EPS * _EPS, theta / r, 1.0), theta


def _distort(model: str, params, xy):
    """Apply the model's distortion to normalized coords xy [..., n, 2]."""
    if model in ("simple_pinhole", "pinhole"):
        return xy
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    if model == "simple_radial":
        radial = 1.0 + params[..., 3] * r2
        return xy * radial[..., None]
    if model == "radial":
        k1, k2 = params[..., 3], params[..., 4]
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        return xy * radial[..., None]
    if model == "opencv":
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        dy = (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return jnp.stack([x * radial + dx, y * radial + dy], axis=-1)
    if model == "full_opencv":
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        k3, k4 = params[..., 8], params[..., 9]
        k5, k6 = params[..., 10], params[..., 11]
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
                  / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
        dx = (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        dy = (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return jnp.stack([x * radial + dx, y * radial + dy], axis=-1)
    if model == "fov":
        # camera_models.h FOVCameraModel: rd = atan(2 r tan(w/2)) / w
        omega = params[..., 4]
        r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
        num = jnp.arctan(2.0 * r * jnp.tan(0.5 * omega))
        # signed safe denominator: the model is even in omega and the
        # reference divides by signed omega (negative omega is valid,
        # e.g. from intrinsics refinement) — clamping with max() would
        # flip the sign and explode the factor for omega < 0
        safe_w = jnp.where(jnp.abs(omega) > _EPS, omega, 1.0)
        factor = jnp.where(
            (r2 > _EPS * _EPS) & (jnp.abs(omega) > _EPS),
            num / (safe_w * r), 1.0)
        return xy * factor[..., None]
    if model in ("opencv_fisheye", "simple_radial_fisheye",
                 "radial_fisheye"):
        scale, theta = _fisheye_scale(xy)
        t2 = theta * theta
        if model == "opencv_fisheye":
            k1, k2 = params[..., 4], params[..., 5]
            k3, k4 = params[..., 6], params[..., 7]
            poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        elif model == "simple_radial_fisheye":
            poly = 1.0 + params[..., 3] * t2
        else:  # radial_fisheye
            poly = 1.0 + t2 * (params[..., 3] + t2 * params[..., 4])
        return xy * (scale * poly)[..., None]
    if model == "thin_prism_fisheye":
        scale, _ = _fisheye_scale(xy)
        u, v = x * scale, y * scale
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        k3, k4 = params[..., 8], params[..., 9]
        sx1, sy1 = params[..., 10], params[..., 11]
        q2 = u * u + v * v
        radial = q2 * (k1 + q2 * (k2 + q2 * (k3 + q2 * k4)))
        du = (u * radial + 2.0 * p1 * u * v + p2 * (q2 + 2.0 * u * u)
              + sx1 * q2)
        dv = (v * radial + 2.0 * p2 * u * v + p1 * (q2 + 2.0 * v * v)
              + sy1 * q2)
        return jnp.stack([u + du, v + dv], axis=-1)
    raise ValueError(f"unknown camera model {model!r}")


def world_to_image(model: str, params: jax.Array,
                   xy: jax.Array) -> jax.Array:
    """Normalized camera coords [..., n, 2] -> pixel coords [..., n, 2].

    `params` broadcasts over the leading axes (one camera or a batch).
    """
    params = jnp.asarray(params, jnp.float32)[..., None, :]  # over n
    f, c = _focal_principal(model, params)
    d = _distort(model, params, jnp.asarray(xy, jnp.float32))
    return d * f + c


def image_to_world(model: str, params: jax.Array,
                   uv: jax.Array) -> jax.Array:
    """Pixel coords [..., n, 2] -> normalized camera coords [..., n, 2].

    Distortion inverted by fixed-iteration Newton on the 2x2 Jacobian
    (jax.jacfwd over the distortion map), matching COLMAP's
    IterativeUndistortion but with static iteration count.
    """
    params = jnp.asarray(params, jnp.float32)[..., None, :]
    f, c = _focal_principal(model, params)
    xy = (jnp.asarray(uv, jnp.float32) - c) / f
    if model in ("simple_pinhole", "pinhole"):
        return xy

    # Newton: x_{t+1} = x_t - J^-1 (distort(x_t) - target)
    def undistort_one(target, params_one):
        def dfun(p):
            return _distort(model, params_one[None, :], p[None, :])[0]

        def body(p, _):
            r = dfun(p) - target
            jac = jax.jacfwd(dfun)(p)
            step = jnp.linalg.solve(jac + 1e-9 * jnp.eye(2), r)
            return p - step, None

        p0, _ = jax.lax.scan(body, target, None, length=_NEWTON_ITERS)
        return p0

    flat_xy = xy.reshape(-1, 2)
    flat_params = jnp.broadcast_to(
        params, xy.shape[:-1] + params.shape[-1:]).reshape(
            -1, params.shape[-1])
    out = jax.vmap(undistort_one)(flat_xy, flat_params)
    return out.reshape(xy.shape)


def calibration_matrix(model: str, params: jax.Array) -> jax.Array:
    """K [..., 3, 3] from intrinsic params (distortion excluded)."""
    params = jnp.asarray(params, jnp.float32)
    f, c = _focal_principal(model, params[..., None, :])
    f, c = f[..., 0, :], c[..., 0, :]
    k = jnp.zeros(params.shape[:-1] + (3, 3), jnp.float32)
    k = k.at[..., 0, 0].set(f[..., 0]).at[..., 1, 1].set(f[..., 1])
    k = k.at[..., 0, 2].set(c[..., 0]).at[..., 1, 2].set(c[..., 1])
    return k.at[..., 2, 2].set(1.0)
