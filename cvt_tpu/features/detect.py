"""DoG keypoint detection: 3x3x3 extrema, edge rejection, subpixel fit.

Reference behavior: VLFeat sift/covdet detection as configured by
covdet/vl_covdet.hpp:79-88 (peakThreshold, edgeThreshold=10, boundary
margin drop at :150-156) and sift.h:59-84 (peak_threshold 0.02/3).

Batched design: extrema tests are two 3x3x3 reduce_windows over the whole
[B, L, H, W] DoG stack (no per-pixel loops); candidate selection is a
top-K over response magnitude (fixed maxK slots + validity mask — the
fixed-shape replacement for cvt's ragged keypoint vectors); the 3D
quadratic subpixel refinement solves a batched 3x3 system on gathered
neighborhoods only.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one octave (or merged).
    x, y: [B, K] input-image coordinates; sigma: [B, K] scale in input
    pixels; level: [B, K] int32 pyramid level; response: [B, K] DoG value;
    valid: [B, K] bool."""
    x: jax.Array
    y: jax.Array
    sigma: jax.Array
    level: jax.Array
    response: jax.Array
    valid: jax.Array


def _window_max(d: jax.Array) -> jax.Array:
    return jax.lax.reduce_window(
        d, -jnp.inf, jax.lax.max, (1, 3, 3, 3), (1, 1, 1, 1),
        "SAME")


def _window_min(d: jax.Array) -> jax.Array:
    return jax.lax.reduce_window(
        d, jnp.inf, jax.lax.min, (1, 3, 3, 3), (1, 1, 1, 1),
        "SAME")


@partial(jax.jit, static_argnames=("n_scales", "sigma0"))
def hessian_response(gauss: jax.Array, n_scales: int = 3,
                     sigma0: float = 1.6) -> jax.Array:
    """Scale-normalized determinant-of-Hessian response stack.

    The reference covdet's DEFAULT detector (vl_covdet.hpp:73-88,
    VL_COVDET_METHOD_HESSIAN; VLFeat covdet.c _vl_det_hessian_response):
    R = sigma^4 * (Lxx * Lyy - Lxy^2) per Gaussian level. gauss
    [B, L, H, W] (octave levels); sigma in octave pixels per level.
    """
    g = gauss
    lxx = jnp.roll(g, -1, 3) + jnp.roll(g, 1, 3) - 2 * g
    lyy = jnp.roll(g, -1, 2) + jnp.roll(g, 1, 2) - 2 * g
    lxy = 0.25 * (jnp.roll(jnp.roll(g, -1, 2), -1, 3)
                  + jnp.roll(jnp.roll(g, 1, 2), 1, 3)
                  - jnp.roll(jnp.roll(g, -1, 2), 1, 3)
                  - jnp.roll(jnp.roll(g, 1, 2), -1, 3))
    resp = lxx * lyy - lxy * lxy
    lvl = np.arange(g.shape[1], dtype=np.float32)
    sig = sigma0 * (2.0 ** (lvl / float(n_scales)))
    return resp * jnp.asarray(sig ** 4)[None, :, None, None]


@partial(jax.jit, static_argnames=("max_k", "peak_threshold",
                                   "edge_threshold", "border"))
def detect_octave(dog: jax.Array, *, max_k: int,
                  peak_threshold: float = 0.02 / 3,
                  edge_threshold: float = 10.0,
                  border: int = 4):
    """Response stack [B, L, H, W] (DoG or Hessian) -> per-octave
    keypoints in OCTAVE coordinates.

    Returns (x, y, level, response, valid, offsets) where x/y/level are
    subpixel-refined floats ([B, max_k]) and valid marks real detections.
    """
    b, l, h, w = dog.shape

    is_max = (dog >= _window_max(dog)) & (dog > peak_threshold)
    is_min = (dog <= _window_min(dog)) & (dog < -peak_threshold)
    extremum = is_max | is_min

    # edge rejection: spatial Hessian ratio (Lowe; vl_sift.c update_*)
    dxx = (jnp.roll(dog, -1, 3) + jnp.roll(dog, 1, 3) - 2 * dog)
    dyy = (jnp.roll(dog, -1, 2) + jnp.roll(dog, 1, 2) - 2 * dog)
    dxy = 0.25 * (jnp.roll(jnp.roll(dog, -1, 2), -1, 3)
                  + jnp.roll(jnp.roll(dog, 1, 2), 1, 3)
                  - jnp.roll(jnp.roll(dog, -1, 2), 1, 3)
                  - jnp.roll(jnp.roll(dog, 1, 2), -1, 3))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    # borders: levels 0 and L-1 and image margins are invalid
    lev = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 1)
    yy = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 2)
    xx = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 3)
    inb = ((lev > 0) & (lev < l - 1)
           & (yy >= border) & (yy < h - border)
           & (xx >= border) & (xx < w - border))

    ok = extremum & edge_ok & inb
    score = jnp.where(ok, jnp.abs(dog), 0.0).reshape(b, -1)
    # small octaves can hold fewer candidate positions than max_k (at
    # the reference operating point max_num_features=8192, sift.h:62,
    # the top pyramid levels always do): select what exists, then pad
    # invalid slots so the caller sees a fixed [B, max_k] shape.
    k_eff = min(max_k, score.shape[1])
    topv, topi = jax.lax.top_k(score, k_eff)                     # [B, K]
    if k_eff < max_k:
        pad = max_k - k_eff
        topv = jnp.pad(topv, ((0, 0), (0, pad)))
        # point padded slots at an interior position (level 1, (1, 1));
        # valid=False masks them everywhere downstream
        topi = jnp.pad(topi, ((0, 0), (0, pad)),
                       constant_values=h * w + w + 1)
    valid = topv > 0.0
    lev_i = topi // (h * w)
    rem = topi % (h * w)
    y_i = rem // w
    x_i = rem % w

    # ---- subpixel refinement on gathered 3x3x3 neighborhoods -----------
    def gather_patch(d_img, li, yi, xi):
        return jax.lax.dynamic_slice(d_img, (li - 1, yi - 1, xi - 1),
                                     (3, 3, 3))

    patches = jax.vmap(lambda d_img, li, yi, xi: jax.vmap(
        gather_patch, in_axes=(None, 0, 0, 0))(d_img, li, yi, xi))(
            dog, lev_i, y_i, x_i)                                # [B,K,3,3,3]

    p = patches
    g = jnp.stack([
        0.5 * (p[..., 1, 1, 2] - p[..., 1, 1, 0]),   # d/dx
        0.5 * (p[..., 1, 2, 1] - p[..., 1, 0, 1]),   # d/dy
        0.5 * (p[..., 2, 1, 1] - p[..., 0, 1, 1]),   # d/ds
    ], axis=-1)                                                  # [B,K,3]
    hxx = p[..., 1, 1, 2] + p[..., 1, 1, 0] - 2 * p[..., 1, 1, 1]
    hyy = p[..., 1, 2, 1] + p[..., 1, 0, 1] - 2 * p[..., 1, 1, 1]
    hss = p[..., 2, 1, 1] + p[..., 0, 1, 1] - 2 * p[..., 1, 1, 1]
    hxy = 0.25 * (p[..., 1, 2, 2] - p[..., 1, 2, 0]
                  - p[..., 1, 0, 2] + p[..., 1, 0, 0])
    hxs = 0.25 * (p[..., 2, 1, 2] - p[..., 2, 1, 0]
                  - p[..., 0, 1, 2] + p[..., 0, 1, 0])
    hys = 0.25 * (p[..., 2, 2, 1] - p[..., 2, 0, 1]
                  - p[..., 0, 2, 1] + p[..., 0, 0, 1])
    # closed-form symmetric 3x3 solve (adjugate/Cramer): a batched
    # linalg.solve here lowers to a per-keypoint LU loop
    a00 = hxx + 1e-6
    a11 = hyy + 1e-6
    a22 = hss + 1e-6
    c00 = a11 * a22 - hys * hys
    c01 = hxs * hys - hxy * a22
    c02 = hxy * hys - hxs * a11
    c11 = a00 * a22 - hxs * hxs
    c12 = hxy * hxs - a00 * hys
    c22 = a00 * a11 - hxy * hxy
    det = a00 * c00 + hxy * c01 + hxs * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
    gx_, gy_, gs_ = g[..., 0], g[..., 1], g[..., 2]
    off = -inv_det[..., None] * jnp.stack([
        c00 * gx_ + c01 * gy_ + c02 * gs_,
        c01 * gx_ + c11 * gy_ + c12 * gs_,
        c02 * gx_ + c12 * gy_ + c22 * gs_,
    ], axis=-1)                                                  # [B,K,3]
    off = jnp.clip(off, -1.0, 1.0)   # reject divergent fits conservatively

    x_f = x_i.astype(jnp.float32) + off[..., 0]
    y_f = y_i.astype(jnp.float32) + off[..., 1]
    l_f = lev_i.astype(jnp.float32) + off[..., 2]
    resp = p[..., 1, 1, 1] + 0.5 * jnp.sum(g * off, axis=-1)
    return x_f, y_f, l_f, lev_i, resp, valid
