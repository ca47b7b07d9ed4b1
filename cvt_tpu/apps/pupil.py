"""Pupil tracking: Swirski-style coarse-to-fine pupil ellipse fit.

Reference: detection_and_tracking/pupil_tracking — pupiltracker::
findPupilEllipse (src/pupil_tracker.cc, include/pupil_tracker.h:13-78):
1) specular-highlight erase, 2) Haar-like coarse pupil localization
(dark box vs bright surround response over a radius range), 3) intensity
-histogram threshold ("KMeans" split in the reference), 4) edge points +
RANSAC ellipse fit through a conic section (include/conic_section.h).

Batched design: every stage is batched over [B, H, W] eye crops —
  * specular erase = mask + blur infill (elementwise + conv),
  * the Haar search = two box convolutions per radius (XLA fuses the
    stack), argmax over (radius, y, x),
  * threshold = 256-bin histogram + between-class variance (Otsu-style
    split, the fixed-shape analogue of the reference's 2-means),
  * edge sampling = top-K gradient magnitudes inside the coarse ROI
    (fixed K keeps shapes static),
  * ellipse fit = batched RANSAC: S random 5-point minimal conic solves
    via jnp.linalg.lstsq under vmap, scored by algebraic inlier count.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PupilResult(NamedTuple):
    center: jax.Array      # [B, 2] (x, y)
    axes: jax.Array        # [B, 2] semi-axes (a, b)
    angle: jax.Array       # [B] radians
    conic: jax.Array       # [B, 6] (A, B, C, D, E, F)
    n_inliers: jax.Array   # [B] int32
    ok: jax.Array          # [B] bool


def _box_mean(ii: jax.Array, y0, x0, h, w) -> jax.Array:
    """Mean over [y0:y0+h, x0:x0+w) windows from an integral image
    ii [B, H+1, W+1], for arrays of window positions."""
    s = (ii[:, y0 + h, x0 + w] - ii[:, y0, x0 + w]
         - ii[:, y0 + h, x0] + ii[:, y0, x0])
    return s / (h * w)


def remove_specular(images: jax.Array, *, thresh: float = 0.9,
                    blur: int = 7) -> jax.Array:
    """Replace saturated highlights with a blurred infill
    (pupil_tracker.cc's specular erase + inpaint, shape-static)."""
    x = jnp.asarray(images, jnp.float32)
    k = jnp.ones((blur, blur), jnp.float32) / (blur * blur)
    sm = jax.lax.conv_general_dilated(
        x[:, None], k[None, None], (1, 1), "SAME")[:, 0]
    return jnp.where(x > thresh, sm, x)


@partial(jax.jit, static_argnames=("radii",))
def coarse_pupil_center(images: jax.Array,
                        radii: tuple[int, ...] = (8, 12, 16, 24)):
    """Haar-like dark-center/bright-surround search. Returns
    (center [B, 2] (x, y) float32, radius [B] float32)."""
    x = jnp.asarray(images, jnp.float32)
    b, h, w = x.shape
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(x, axis=1), axis=2),
                 ((0, 0), (1, 0), (1, 0)))
    best_resp = jnp.full((b,), -jnp.inf)
    best_yx = jnp.zeros((b, 2), jnp.int32)
    best_r = jnp.zeros((b,), jnp.float32)
    for r in radii:
        r2 = 3 * r
        if 2 * r2 >= min(h, w):
            continue
        ys = jnp.arange(0, h - 2 * r2)
        xs = jnp.arange(0, w - 2 * r2)
        yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
        yy = yy.reshape(-1)
        xx = xx.reshape(-1)
        # 1-D position vectors: ii[:, (P,), (P,)] broadcasts to [B, P]
        # (a [1, P] operand would make it [B, 1, P] and break the argmax)
        inner = _box_mean(ii, yy + r2 - r, xx + r2 - r,
                          2 * r, 2 * r)                      # [B, P]
        outer = _box_mean(ii, yy, xx, 2 * r2, 2 * r2)
        resp = outer - inner       # bright surround minus dark center
        i = jnp.argmax(resp, axis=1)
        v = jnp.take_along_axis(resp, i[:, None], axis=1)[:, 0]
        cy = yy[i] + r2
        cx = xx[i] + r2
        upd = v > best_resp
        best_resp = jnp.where(upd, v, best_resp)
        best_yx = jnp.where(upd[:, None],
                            jnp.stack([cy, cx], -1), best_yx)
        best_r = jnp.where(upd, float(r), best_r)
    center_xy = jnp.stack([best_yx[:, 1], best_yx[:, 0]], -1)
    return center_xy.astype(jnp.float32), best_r


def _otsu_threshold(x: jax.Array, mask: jax.Array, bins: int = 64):
    """Between-class-variance-maximizing split of masked pixels [B,H,W]
    (fixed-shape analogue of the reference's 2-means intensity split)."""
    b = x.shape[0]
    q = jnp.clip((x * (bins - 1)).astype(jnp.int32), 0, bins - 1)
    oh = jax.nn.one_hot(q.reshape(b, -1), bins, dtype=jnp.float32)
    msk = mask.reshape(b, -1, 1).astype(jnp.float32)
    hist = jnp.sum(oh * msk, axis=1)                         # [B, bins]
    total = jnp.maximum(hist.sum(-1, keepdims=True), 1.0)
    p = hist / total
    centers = (jnp.arange(bins) + 0.5) / bins
    w0 = jnp.cumsum(p, axis=-1)
    mu = jnp.cumsum(p * centers, axis=-1)
    mu_t = mu[:, -1:]
    var_b = (mu_t * w0 - mu) ** 2 / (w0 * (1 - w0) + 1e-9)
    t = jnp.argmax(var_b, axis=-1)
    return (t.astype(jnp.float32) + 0.5) / bins              # [B]


def _conic_from_points(pts: jax.Array) -> jax.Array:
    """5-point minimal conic solve: A x2 + B xy + C y2 + D x + E y + F = 0
    with F = -1 normalization. pts [5, 2] -> conic [6]."""
    x, y = pts[:, 0], pts[:, 1]
    m = jnp.stack([x * x, x * y, y * y, x, y], axis=-1)     # [5, 5]
    rhs = jnp.ones((5,), jnp.float32)
    sol = jnp.linalg.lstsq(m, rhs)[0]
    return jnp.concatenate([sol, jnp.array([-1.0])])


def _conic_residual(conic: jax.Array, pts: jax.Array) -> jax.Array:
    """Normalized algebraic distance of points to the conic."""
    a, bb, c, d, e, f = [conic[i] for i in range(6)]
    x, y = pts[..., 0], pts[..., 1]
    val = a * x * x + bb * x * y + c * y * y + d * x + e * y + f
    gx = 2 * a * x + bb * y + d
    gy = bb * x + 2 * c * y + e
    return jnp.abs(val) / jnp.sqrt(gx * gx + gy * gy + 1e-9)


def conic_to_ellipse(conic: jax.Array):
    """(A..F) -> center [2], semi-axes [2], angle. Invalid conics give
    nan axes (caller checks `ok`)."""
    a, b2, c, d, e, f = [conic[i] for i in range(6)]
    b = b2 / 2
    det = a * c - b * b
    cx = (b * (e / 2) - c * (d / 2)) / (det + 1e-12)
    cy = (b * (d / 2) - a * (e / 2)) / (det + 1e-12)
    # translate to center: constant term
    fc = f + (d / 2) * cx + (e / 2) * cy
    tr = a + c
    disc = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4 * b * b, 0.0))
    l1 = (tr + disc) / 2
    l2 = (tr - disc) / 2
    ax1 = jnp.sqrt(jnp.maximum(-fc / (l2 + 1e-12), 0.0))
    ax2 = jnp.sqrt(jnp.maximum(-fc / (l1 + 1e-12), 0.0))
    angle = 0.5 * jnp.arctan2(2 * b, a - c)
    return jnp.stack([cx, cy]), jnp.stack([ax1, ax2]), angle


@partial(jax.jit, static_argnames=("n_edge", "n_trials", "radii"))
def find_pupil(key, images: jax.Array, *, n_edge: int = 128,
               n_trials: int = 64, inlier_tol: float = 1.5,
               min_inliers: int = 24,
               radii: tuple[int, ...] = (8, 12, 16, 24)) -> PupilResult:
    """Batched pupil ellipse detection on [B, H, W] gray crops in [0,1]."""
    x = remove_specular(jnp.asarray(images, jnp.float32))
    b, h, w = x.shape
    center, radius = coarse_pupil_center(x, radii)

    # ROI mask around the coarse center (3x the Haar radius)
    yy = jnp.arange(h)[None, :, None]
    xx = jnp.arange(w)[None, None, :]
    roi_r = (3.0 * radius)[:, None, None]
    roi = ((jnp.abs(yy - center[:, 1][:, None, None]) < roi_r)
           & (jnp.abs(xx - center[:, 0][:, None, None]) < roi_r))

    thresh = _otsu_threshold(x, roi)                          # [B]

    # gradient magnitude of the thresholded (dark) region boundary
    dark = (x < thresh[:, None, None]) & roi
    df = dark.astype(jnp.float32)
    gy = df[:, 2:, 1:-1] - df[:, :-2, 1:-1]
    gx = df[:, 1:-1, 2:] - df[:, 1:-1, :-2]
    mag = jnp.pad(jnp.abs(gx) + jnp.abs(gy), ((0, 0), (1, 1), (1, 1)))
    mag = jnp.where(roi, mag, 0.0)

    # fixed-K edge sample: top-K gradient pixels
    flat = mag.reshape(b, -1)
    val, idx = jax.lax.top_k(flat, n_edge)                    # [B, K]
    ey = (idx // w).astype(jnp.float32)
    ex = (idx % w).astype(jnp.float32)
    pts = jnp.stack([ex, ey], axis=-1)                        # [B, K, 2]
    valid = val > 0

    # center+scale normalize for conditioning
    scale = jnp.maximum(radius, 1.0)[:, None, None]
    pn = (pts - center[:, None, :]) / scale

    def fit_one(key, pn, valid):
        def trial(k):
            sel = jax.random.choice(k, n_edge, (5,), replace=False,
                                    p=valid / jnp.maximum(valid.sum(), 1))
            conic = _conic_from_points(pn[sel])
            res = _conic_residual(conic, pn)
            inl = (res < inlier_tol / 16.0) & (valid > 0)
            return conic, jnp.sum(inl)
        keys = jax.random.split(key, n_trials)
        conics, scores = jax.vmap(trial)(keys)
        best = jnp.argmax(scores)
        return conics[best], scores[best]

    keys = jax.random.split(key, b)
    conic_n, score = jax.vmap(fit_one)(keys, pn,
                                       valid.astype(jnp.float32))
    cen_n, axes_n, angle = jax.vmap(conic_to_ellipse)(conic_n)
    cen = cen_n * scale[:, 0, :] + center
    axes = axes_n * scale[:, 0, :]
    ok = ((score >= min_inliers) & jnp.all(jnp.isfinite(axes), -1)
          & (axes[:, 0] > 1.0))
    return PupilResult(center=cen, axes=axes, angle=angle, conic=conic_n,
                       n_inliers=score.astype(jnp.int32), ok=ok)


def render_eye(h: int = 96, w: int = 128, cx: float = 64.0, cy: float = 48.0,
               a: float = 14.0, b: float = 10.0, angle: float = 0.3,
               iris_r: float = 30.0, specular: bool = True) -> np.ndarray:
    """Synthetic eye crop for tests/demos: bright sclera, mid iris, dark
    elliptical pupil, optional specular dot."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca
    img = np.full((h, w), 0.85, np.float32)
    ir = (xx - cx) ** 2 + (yy - cy) ** 2 < iris_r ** 2
    img[ir] = 0.45
    pup = (u / a) ** 2 + (v / b) ** 2 < 1.0
    img[pup] = 0.05
    if specular:
        sp = (xx - cx - 3) ** 2 + (yy - cy - 2) ** 2 < 4
        img[sp] = 1.0
    return img
