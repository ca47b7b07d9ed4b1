"""Guided matching: geometry-gated 2-NN re-matching.

Reference: MatchGuidedSiftFeaturesCPU / the guided variants in
retrieval/vlindex/src/feature/sift.cc:252-340 — after a two-view geometry
is estimated from plain ratio matches, descriptors are RE-matched with the
candidate set restricted to pairs consistent with the estimated epipolar
geometry (fundamental/essential: point-to-epipolar-line distance) or
homography (transfer error). Guided matching recovers correspondences the
plain Lowe-ratio test rejects, because the ratio is computed only among
geometrically plausible candidates.

Batched design: the geometric residual for ALL K1*K2 pairs is one broadcasted
matrix (no candidate lists) fused with the descriptor distance matmul;
pairs failing the gate get +inf distance before the top-2/ratio/cross
checks, so the whole guided re-match is a single jitted program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cvt_tpu.match.nn import MatchResult


def _epipolar_residual_matrix(f: jax.Array, pts1: jax.Array,
                              pts2: jax.Array) -> jax.Array:
    """Squared symmetric point-to-epipolar-line distance for all pairs.

    f [3, 3] with x2^T F x1 = 0; pts1 [K1, 2]; pts2 [K2, 2].
    Returns [K1, K2] max of the two squared line distances — the gate the
    reference applies per candidate pair (sift.cc guided match residual).
    """
    one1 = jnp.ones((pts1.shape[0], 1), pts1.dtype)
    one2 = jnp.ones((pts2.shape[0], 1), pts2.dtype)
    x1 = jnp.concatenate([pts1, one1], axis=-1)               # [K1, 3]
    x2 = jnp.concatenate([pts2, one2], axis=-1)               # [K2, 3]
    l2 = x1 @ f.T                                             # [K1, 3] lines in im2
    l1 = x2 @ f                                               # [K2, 3] lines in im1
    num = jnp.square(l2 @ x2.T)                               # [K1, K2] (x2^T F x1)^2
    d2_2 = num / jnp.maximum(
        jnp.square(l2[:, 0]) + jnp.square(l2[:, 1]), 1e-12)[:, None]
    d2_1 = num / jnp.maximum(
        jnp.square(l1[:, 0]) + jnp.square(l1[:, 1]), 1e-12)[None, :]
    return jnp.maximum(d2_2, d2_1)


def _homography_residual_matrix(h: jax.Array, pts1: jax.Array,
                                pts2: jax.Array) -> jax.Array:
    """Squared transfer error ||H x1 - x2||^2 for all pairs -> [K1, K2]."""
    one1 = jnp.ones((pts1.shape[0], 1), pts1.dtype)
    x1 = jnp.concatenate([pts1, one1], axis=-1)               # [K1, 3]
    hx = x1 @ h.T                                             # [K1, 3]
    proj = hx[:, :2] / jnp.where(jnp.abs(hx[:, 2:3]) > 1e-12,
                                 hx[:, 2:3], 1e-12)
    diff = proj[:, None, :] - pts2[None, :, :]                # [K1, K2, 2]
    return jnp.sum(jnp.square(diff), axis=-1)


@partial(jax.jit, static_argnames=("model_type", "ratio", "cross_check",
                                   "max_dist", "max_error"))
def match_guided(d1, d2, pts1, pts2, model, *,
                 model_type: str = "fundamental",
                 max_error: float = 4.0, ratio: float = 0.9,
                 cross_check: bool = True, max_dist: float = jnp.inf,
                 valid1=None, valid2=None) -> MatchResult:
    """Geometry-guided 2-NN matching (sift.cc:252-340 semantics).

    d1 [K1, D], d2 [K2, D] descriptors; pts1 [K1, 2], pts2 [K2, 2]
    keypoint locations; model [3, 3] fundamental/essential-in-pixels or
    homography; max_error in pixels. The ratio + cross checks run over the
    geometrically gated candidate set only.
    """
    d1 = jnp.asarray(d1, jnp.float32)
    d2 = jnp.asarray(d2, jnp.float32)
    pts1 = jnp.asarray(pts1, jnp.float32)
    pts2 = jnp.asarray(pts2, jnp.float32)
    model = jnp.asarray(model, jnp.float32)
    k1, k2 = d1.shape[0], d2.shape[0]
    if valid1 is None:
        valid1 = jnp.ones((k1,), bool)
    if valid2 is None:
        valid2 = jnp.ones((k2,), bool)

    if model_type in ("fundamental", "essential"):
        resid = _epipolar_residual_matrix(model, pts1, pts2)
    elif model_type == "homography":
        resid = _homography_residual_matrix(model, pts1, pts2)
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    gate = resid <= max_error * max_error                     # [K1, K2]

    n1 = jnp.sum(jnp.square(d1), axis=-1)
    n2 = jnp.sum(jnp.square(d2), axis=-1)
    ip = jnp.matmul(d1, d2.T, preferred_element_type=jnp.float32)
    dist = n1[:, None] - 2.0 * ip + n2[None, :]
    dist = jnp.where(gate & valid2[None, :], dist, jnp.inf)
    neg2, top2 = jax.lax.top_k(-dist, 2)
    best, second = -neg2[:, 0], -neg2[:, 1]
    idx2 = top2[:, 0]
    ok = (valid1 & jnp.isfinite(best)
          & (best < (ratio * ratio) * second) & (best < max_dist))
    if cross_check:
        distT = jnp.where(valid1[:, None], dist, jnp.inf)
        back = jnp.argmin(distT, axis=0)
        ok = ok & (back[idx2] == jnp.arange(k1))
    return MatchResult(idx2=idx2, dist=jnp.where(jnp.isfinite(best),
                                                 jnp.maximum(best, 0.0),
                                                 jnp.inf), valid=ok)
