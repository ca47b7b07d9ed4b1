"""Affine shape adaptation: second-moment-matrix iteration per keypoint.

Reference: vl_covdet_extract_affine_shape as driven by
covdet/vl_covdet.hpp:159-173 (the Baumberg/Mikolajczyk iteration VLFeat
implements in covdet.c): iterate  A <- A * M^{-1/2}  where M is the
windowed second-moment (structure tensor) of the image gradients sampled
through the current A, until the normalized patch is isotropic (M ~ I).
The resulting unit-determinant A maps the unit circle to the feature's
ellipse; descriptors sample through R(angle) * A.

Batched design: fixed ITERS iterations of a closed-form 2x2 inverse square
root, vmapped over all keypoints — no per-feature convergence loops
(non-converging features simply keep their last iterate; VLFeat drops
them, which costs keypoints without helping recall).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.features.descriptor import _sample_level


def _inv_sqrt_2x2(m11, m12, m22, eps=1e-12):
    """Closed-form inverse square root of an SPD 2x2 [[a,b],[b,c]]:
    sqrt(M) = (M + s I) / t with s = sqrt(det M), t = sqrt(tr M + 2 s);
    the inverse follows from the 2x2 adjugate."""
    det = jnp.maximum(m11 * m22 - m12 * m12, eps)
    s = jnp.sqrt(det)
    t = jnp.sqrt(jnp.maximum(m11 + m22 + 2.0 * s, eps))
    # sqrt(M) entries
    r11 = (m11 + s) / t
    r12 = m12 / t
    r22 = (m22 + s) / t
    rdet = jnp.maximum(r11 * r22 - r12 * r12, eps)
    return r22 / rdet, -r12 / rdet, r11 / rdet


@partial(jax.jit, static_argnames=("n_samples", "iters"))
def estimate_affine_shape(dx, dy, x, y, sigma_oct, level, valid, *,
                          n_samples: int = 16, iters: int = 5):
    """Per-keypoint affine shape A [B, K, 2, 2], det(A) = 1.

    dx/dy [B, L, H, W] octave gradient fields; x/y [B, K] octave coords;
    sigma_oct [B, K]; level [B, K] int32. A maps normalized (isotropic)
    patch coordinates to image coordinates; identity for invalid slots.
    """
    p = n_samples
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))    # [P^2, 2]
    r2 = grid[:, 0] ** 2 + grid[:, 1] ** 2
    wgt = jnp.exp(-r2 / (2.0 * 0.5 ** 2)) * (r2 <= 1.0)
    win_r = 3.0

    def per_kp(dxs, dys, xi, yi, si, li):
        a = jnp.eye(2, dtype=jnp.float32)

        def body(a, _):
            # sample gradients through the current shape
            uv = grid * (win_r * si)                              # [P^2, 2]
            px = a[0, 0] * uv[:, 0] + a[0, 1] * uv[:, 1]
            py = a[1, 0] * uv[:, 0] + a[1, 1] * uv[:, 1]
            vx = _sample_level(dxs, li, xi + px, yi + py)
            vy = _sample_level(dys, li, xi + px, yi + py)
            # gradients in the normalized frame: g' = A^T g
            g1 = a[0, 0] * vx + a[1, 0] * vy
            g2 = a[0, 1] * vx + a[1, 1] * vy
            m11 = jnp.sum(wgt * g1 * g1)
            m12 = jnp.sum(wgt * g1 * g2)
            m22 = jnp.sum(wgt * g2 * g2)
            tr = m11 + m22
            ok = tr > 1e-12
            scale = jnp.where(ok, 2.0 / jnp.maximum(tr, 1e-12), 1.0)
            m11n = jnp.where(ok, m11 * scale, 1.0)
            m12n = jnp.where(ok, m12 * scale, 0.0)
            m22n = jnp.where(ok, m22 * scale, 1.0)
            i11, i12, i22 = _inv_sqrt_2x2(m11n, m12n, m22n)
            a_new = jnp.stack([
                jnp.stack([a[0, 0] * i11 + a[0, 1] * i12,
                           a[0, 0] * i12 + a[0, 1] * i22]),
                jnp.stack([a[1, 0] * i11 + a[1, 1] * i12,
                           a[1, 0] * i12 + a[1, 1] * i22]),
            ])
            # renormalize to unit determinant (shape only; scale lives
            # in sigma)
            d = jnp.abs(a_new[0, 0] * a_new[1, 1]
                        - a_new[0, 1] * a_new[1, 0])
            a_new = a_new / jnp.sqrt(jnp.maximum(d, 1e-12))
            bad = ~jnp.all(jnp.isfinite(a_new))
            return jnp.where(bad, a, a_new), None

        a, _ = jax.lax.scan(body, a, None, length=iters)
        return a

    f = jax.vmap(jax.vmap(per_kp, in_axes=(None, None, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0))
    a = f(dx, dy, x, y, sigma_oct, level)
    eye = jnp.eye(2, dtype=jnp.float32)
    return jnp.where(valid[..., None, None], a, eye)
