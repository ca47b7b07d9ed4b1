"""Image undistortion: batched inverse-warp resampling through the
camera models.

Reference: retrieval/vlindex/src/exe/image.cc:77-407 (image_undistorter:
per-image UndistortImage via Camera models + bilinear interpolation,
with blank-pixel / scale ROI selection in
base/undistortion.cc:UndistortCamera).

Batched design: the whole warp is one fused program — an output pixel grid
is pushed through the FORWARD distortion of the source camera (pixel ->
normalized pinhole ray -> distorted source pixel; no iterative inverse
needed for this direction) and sampled with bilinear interpolation
(jax.scipy.ndimage.map_coordinates, order=1), vmapped over image
batches. The reference's per-pixel scalar loop with 4-tap interpolation
(undistortion.cc) becomes two gathers + fused elementwise arithmetic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cvt_tpu.match.cameras import (_distort, _focal_principal,
                                   calibration_matrix)


def undistort_camera(model: str, params, width: int, height: int, *,
                     blank_pixels: float = 0.0):
    """Pinhole params (fx, fy, cx, cy) for the undistorted output camera.

    blank_pixels in [0, 1] interpolates between max_scale (0: no blank
    corners — the undistorted frame is cropped to valid source pixels)
    and min_scale (1: every source pixel visible, corners blank) — the
    reference's UndistortCameraOptions.blank_pixels semantics
    (base/undistortion.cc). The focal is scaled accordingly; the
    principal point is preserved.
    """
    params = np.asarray(params, np.float32)
    f, c = _focal_principal(model, jnp.asarray(params)[None, :])
    f = np.asarray(f)[0]
    c = np.asarray(c)[0]
    if model in ("simple_pinhole", "pinhole"):
        return np.array([f[0], f[1], c[0], c[1]], np.float32)
    # probe the frame border (true normalized extent of the image) and
    # measure the distortion's radial stretch there; the output focal
    # scale that exactly crops/covers the border follows from it.
    x0, x1 = (0.0 - c[0]) / f[0], (width - 1.0 - c[0]) / f[0]
    y0, y1 = (0.0 - c[1]) / f[1], (height - 1.0 - c[1]) / f[1]
    tx = np.linspace(x0, x1, 65, dtype=np.float32)
    ty = np.linspace(y0, y1, 65, dtype=np.float32)
    border = np.concatenate([
        np.stack([tx, np.full_like(tx, y0)], -1),
        np.stack([tx, np.full_like(tx, y1)], -1),
        np.stack([np.full_like(ty, x0), ty], -1),
        np.stack([np.full_like(ty, x1), ty], -1)], 0)
    d = np.asarray(_distort(model, jnp.asarray(params)[None, None, :],
                            jnp.asarray(border)[None, :, :]))[0]
    # radial gain of the distortion at the border (distorted radius per
    # undistorted radius)
    rn = np.linalg.norm(border, axis=-1)
    rd = np.linalg.norm(d, axis=-1)
    gain = rd / np.maximum(rn, 1e-6)
    s_min, s_max = float(gain.min()), float(gain.max())
    s = s_max + (s_min - s_max) * float(np.clip(blank_pixels, 0.0, 1.0))
    return np.array([f[0] * s, f[1] * s, c[0], c[1]], np.float32)


@partial(jax.jit, static_argnames=("model", "h_out", "w_out"))
def _undistort_one(image, params, new_params, model, h_out, w_out):
    """image [H, W] or [H, W, C] f32 -> undistorted [h_out, w_out(, C)]."""
    fx, fy, cx, cy = (new_params[0], new_params[1], new_params[2],
                      new_params[3])
    vv, uu = jnp.meshgrid(jnp.arange(h_out, dtype=jnp.float32),
                          jnp.arange(w_out, dtype=jnp.float32),
                          indexing="ij")
    # output pixel -> ideal pinhole ray
    x = (uu - cx) / fx
    y = (vv - cy) / fy
    xy = jnp.stack([x, y], axis=-1).reshape(1, -1, 2)
    # forward distortion -> source pixel coordinates
    f, c = _focal_principal(model, params[None, None, :])
    src = _distort(model, params[None, None, :], xy) * f + c   # [1, N, 2]
    su = src[0, :, 0].reshape(h_out, w_out)
    sv = src[0, :, 1].reshape(h_out, w_out)

    def sample(chan):
        return jax.scipy.ndimage.map_coordinates(
            chan, [sv, su], order=1, mode="constant", cval=0.0)

    if image.ndim == 2:
        return sample(image)
    return jnp.stack([sample(image[..., ch])
                      for ch in range(image.shape[-1])], axis=-1)


def undistort_images(images, model: str, params, *,
                     blank_pixels: float = 0.0,
                     out_shape: tuple[int, int] | None = None):
    """Undistort a batch of images [B, H, W(, C)] through one camera.

    Returns (undistorted [B, h, w(, C)] f32, new_params [4] f32 pinhole
    (fx, fy, cx, cy)). Mirrors exe/image.cc's ImageUndistorter loop; the
    batch dimension is vmapped into one device program.
    """
    images = jnp.asarray(images, jnp.float32)
    params = jnp.asarray(params, jnp.float32)
    h, w = images.shape[1], images.shape[2]
    h_out, w_out = out_shape if out_shape is not None else (h, w)
    newp = jnp.asarray(undistort_camera(model, np.asarray(params), w, h,
                                        blank_pixels=blank_pixels))
    out = jax.vmap(lambda im: _undistort_one(im, params, newp, model,
                                             h_out, w_out))(images)
    return out, np.asarray(newp)


@partial(jax.jit, static_argnames=("h_out", "w_out"))
def warp_image_homography(image, h_mat, h_out: int, w_out: int):
    """Warp with a 3x3 homography H mapping TARGET pixel -> SOURCE pixel
    (base/warp.cc WarpImageWithHomography): bilinear inverse warp."""
    image = jnp.asarray(image, jnp.float32)
    h_mat = jnp.asarray(h_mat, jnp.float32)
    vv, uu = jnp.meshgrid(jnp.arange(h_out, dtype=jnp.float32),
                          jnp.arange(w_out, dtype=jnp.float32),
                          indexing="ij")
    ones = jnp.ones_like(uu)
    p = jnp.einsum("ij,jhw->ihw", h_mat, jnp.stack([uu, vv, ones]))
    su = p[0] / p[2]
    sv = p[1] / p[2]

    def sample(chan):
        return jax.scipy.ndimage.map_coordinates(
            chan, [sv, su], order=1, mode="constant", cval=0.0)

    if image.ndim == 2:
        return sample(image)
    return jnp.stack([sample(image[..., c])
                      for c in range(image.shape[-1])], axis=-1)


def warp_between_cameras(image, src_model: str, src_params,
                         dst_model: str, dst_params):
    """Resample `image` taken by the source camera as if taken by the
    target camera (base/warp.cc WarpImageBetweenCameras): target pixel
    -> target-normalized ray (iterative undistortion) -> source
    distortion -> source pixel -> bilinear sample."""
    from cvt_tpu.match.cameras import image_to_world
    image = jnp.asarray(image, jnp.float32)
    h, w = image.shape[:2]
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    uv = np.stack([uu.ravel(), vv.ravel()], -1)
    xy = image_to_world(dst_model, jnp.asarray(dst_params, jnp.float32),
                        jnp.asarray(uv))
    sp = jnp.asarray(src_params, jnp.float32)
    f, c = _focal_principal(src_model, sp[None, None, :])
    src = _distort(src_model, sp[None, None, :], xy[None]) * f + c
    su = src[0, :, 0].reshape(h, w)
    sv = src[0, :, 1].reshape(h, w)

    def sample(chan):
        return jax.scipy.ndimage.map_coordinates(
            chan, [sv, su], order=1, mode="constant", cval=0.0)

    if image.ndim == 2:
        return sample(image)
    return jnp.stack([sample(image[..., ch])
                      for ch in range(image.shape[-1])], axis=-1)
