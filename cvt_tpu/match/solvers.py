"""Minimal solvers for 2D geometric models (affine, homography).

Reference: covdet/geo_verification.hpp (3-stage affine->pinv->normalized
DLT homography verifier, `toAffinity` :217-256, `centering` :181-212) and
vlindex estimators (affine_transform.h 3-pt DLT, homography_matrix 4-pt
DLT with Hartley normalization).

All solvers are batched: [S, n, 2] point sets -> [S, ...] models, so
RANSAC evaluates every hypothesis in parallel (lstsq/SVD over
small batched systems).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fit_affine(src: jax.Array, dst: jax.Array,
               weights: jax.Array | None = None) -> jax.Array:
    """Least-squares affine A (2x3) with dst ~= A @ [src; 1].

    src/dst [..., n, 2] (n >= 3). Batched closed-form normal equations.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    ones = jnp.ones(src.shape[:-1] + (1,), src.dtype)
    x = jnp.concatenate([src, ones], axis=-1)            # [..., n, 3]
    if weights is not None:
        w = weights[..., None]
        xtx = jnp.einsum("...ni,...nj->...ij", x * w, x)
        xty = jnp.einsum("...ni,...nj->...ij", x * w, dst)
    else:
        xtx = jnp.einsum("...ni,...nj->...ij", x, x)
        xty = jnp.einsum("...ni,...nj->...ij", x, dst)
    eye = jnp.eye(3, dtype=src.dtype) * 1e-6
    sol = jnp.linalg.solve(xtx + eye, xty)               # [..., 3, 2]
    return jnp.swapaxes(sol, -1, -2)                     # [..., 2, 3]


def apply_affine(a: jax.Array, pts: jax.Array) -> jax.Array:
    """a [..., 2, 3], pts [..., n, 2] -> [..., n, 2]."""
    return (jnp.einsum("...ij,...nj->...ni", a[..., :2], pts)
            + a[..., None, :, 2])


def _hartley_normalize(pts, weights=None):
    """Similarity transform T s.t. T(pts) has zero mean, sqrt(2) RMS.

    With `weights` [..., n], the mean/scale are weighted (zero-weight
    points do not influence the conditioning transform)."""
    if weights is None:
        mean = jnp.mean(pts, axis=-2, keepdims=True)
        d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
        scale = jnp.sqrt(2.0) / (jnp.mean(d, axis=-1, keepdims=True) + 1e-12)
    else:
        w = weights[..., None]
        wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
        mean = jnp.sum(pts * w, axis=-2, keepdims=True) / wsum
        d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
        scale = jnp.sqrt(2.0) / (
            jnp.sum(d * weights, axis=-1, keepdims=True)
            / wsum[..., 0] + 1e-12)
    s = scale[..., None]
    t = jnp.zeros(pts.shape[:-2] + (3, 3), pts.dtype)
    t = t.at[..., 0, 0].set(scale[..., 0]).at[..., 1, 1].set(scale[..., 0])
    t = t.at[..., 0, 2].set(-scale[..., 0] * mean[..., 0, 0])
    t = t.at[..., 1, 2].set(-scale[..., 0] * mean[..., 0, 1])
    t = t.at[..., 2, 2].set(1.0)
    return (pts - mean) * s, t


def fit_homography_dlt(src: jax.Array, dst: jax.Array,
                       weights: jax.Array | None = None) -> jax.Array:
    """Normalized 4+-point DLT homography H (3x3, h22=1-ish).

    src/dst [..., n, 2] (n >= 4). Batched SVD of the 2n x 9 system with
    Hartley normalization (geo_verification.hpp:117-160 semantics).
    Optional `weights` [..., n] give a weighted least-squares fit
    (rows scaled by sqrt(w)) for LO-RANSAC inlier refits.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    sn, t1 = _hartley_normalize(src, weights)
    dn, t2 = _hartley_normalize(dst, weights)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u],
                   axis=-1)
    r2 = jnp.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v],
                   axis=-1)
    if weights is not None:
        sw = jnp.sqrt(jnp.asarray(weights, jnp.float32))[..., None]
        r1 = r1 * sw
        r2 = r2 * sw
    a = jnp.concatenate([r1, r2], axis=-2)               # [..., 2n, 9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    h = vt[..., -1, :].reshape(src.shape[:-2] + (3, 3))
    # denormalize: H = T2^-1 Hn T1
    h = jnp.linalg.solve(t2, jnp.matmul(h, t1))
    return h / (h[..., 2:3, 2:3] + 1e-12)


def apply_homography(h: jax.Array, pts: jax.Array) -> jax.Array:
    """h [..., 3, 3], pts [..., n, 2] -> projected [..., n, 2]."""
    ones = jnp.ones(pts.shape[:-1] + (1,), pts.dtype)
    ph = jnp.concatenate([pts, ones], axis=-1)
    out = jnp.einsum("...ij,...nj->...ni", h, ph)
    return out[..., :2] / (out[..., 2:3] + 1e-12)


def fit_translation(src: jax.Array, dst: jax.Array,
                    weights: jax.Array | None = None) -> jax.Array:
    """2-D translation estimator (estimators/translation_transform.h):
    the weighted mean displacement. src/dst [..., n, 2] -> [..., 2]."""
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    if weights is None:
        return jnp.mean(dst - src, axis=-2)
    w = weights[..., None]
    return (jnp.sum((dst - src) * w, axis=-2)
            / jnp.maximum(jnp.sum(w, axis=-2), 1e-12))


def apply_translation(t: jax.Array, pts: jax.Array) -> jax.Array:
    return jnp.asarray(pts, jnp.float32) + t[..., None, :]


def fit_similarity2d(src: jax.Array, dst: jax.Array,
                     weights: jax.Array | None = None) -> jax.Array:
    """2-D similarity (scale+rotation+translation) as a [2, 3] matrix,
    the closed-form complex least squares (dst ~ s*R*src + t). Batched;
    weights optional. (estimators/similarity_transform.h at 2-D.)"""
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None] / (jnp.sum(weights, axis=-1)[..., None, None]
                              + 1e-12)
    mu_s = jnp.sum(src * w, axis=-2, keepdims=True)
    mu_d = jnp.sum(dst * w, axis=-2, keepdims=True)
    s0 = src - mu_s
    d0 = dst - mu_d
    # complex regression: (a + ib) = sum(conj(s) d) / sum(|s|^2)
    num_re = jnp.sum((s0[..., 0] * d0[..., 0]
                      + s0[..., 1] * d0[..., 1]) * weights, axis=-1)
    num_im = jnp.sum((s0[..., 0] * d0[..., 1]
                      - s0[..., 1] * d0[..., 0]) * weights, axis=-1)
    den = jnp.sum((s0[..., 0] ** 2 + s0[..., 1] ** 2) * weights, axis=-1)
    a = num_re / jnp.maximum(den, 1e-12)
    b = num_im / jnp.maximum(den, 1e-12)
    rot = jnp.stack([jnp.stack([a, -b], -1), jnp.stack([b, a], -1)], -2)
    t = (mu_d[..., 0, :]
         - jnp.einsum("...ij,...j->...i", rot, mu_s[..., 0, :]))
    return jnp.concatenate([rot, t[..., :, None]], axis=-1)   # [..., 2, 3]


def apply_similarity2d(m: jax.Array, pts: jax.Array) -> jax.Array:
    return (jnp.einsum("...ij,...nj->...ni", m[..., :2],
                       jnp.asarray(pts, jnp.float32))
            + m[..., None, :, 2])
