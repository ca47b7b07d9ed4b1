"""Vote-and-verify: multi-resolution Hough voting + affine refit.

Reference: retrieval/vlindex/src/retrieval/vote_and_verify.cc — each
match casts a vote for a 4-D similarity (tx, ty, log sigma, theta) into a
6-LEVEL multi-resolution Hough pyramid (:238-288); occupied finest bins
are scored as their own votes plus 0.5^l-weighted parent votes
(:294-318); the top bins seed affine LO-refits whose inliers must pass
BOTH the two-way transfer error and the feature-scale-consistency test
(ComputeInliers :173-189, ComputeScaleError :104-115); the final score is
the EFFECTIVE inlier count — occupied cells of a 64x64 grid over the
inlier spread (ComputeEffectiveInlierCount :152-204) — which discounts
bursts of co-located matches. Also GHT octave-histogram validation
(video_object_match/src/GHT.cpp:157-180).

Batched design: votes are batched scatter-adds into SIX dense histograms (one
per level, same stride layout as the reference's shifted-coordinate
index); per-bin pyramid scores come from static parent-index gathers; the
refit reuses batched least-squares affine fits seeded from the top bins
instead of a sequential RANSAC loop; the effective-inlier grid is a
scatter-max. Everything is fixed-shape and jittable (vmapped per
candidate inside the vocab-tree Query).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.match.solvers import apply_affine, fit_affine


class VoteVerifyResult(NamedTuple):
    score: jax.Array       # scalar: EFFECTIVE inlier count of best model
    model: jax.Array       # [2, 3] affine
    inliers: jax.Array     # [N] bool
    n_inliers: jax.Array   # scalar: raw inlier count


def _parent_maps(bins_t, bins_s, bins_r, n_levels):
    """Static parent flat-index maps per pyramid level: level-0 flat bin
    -> flat index formed from right-shifted coordinates with the SAME
    strides (the reference's index formula, vote_and_verify.cc:270-283).
    """
    a = np.arange(bins_t * bins_t * bins_s * bins_r)
    br = a % bins_r
    rest = a // bins_r
    bs = rest % bins_s
    rest //= bins_s
    bty = rest % bins_t
    bt = rest // bins_t
    maps = []
    for lvl in range(1, n_levels):
        t1, t2 = bt >> lvl, bty >> lvl
        s1, r1 = bs >> lvl, br >> lvl
        maps.append(((t1 * bins_t + t2) * bins_s + s1) * bins_r + r1)
    return [jnp.asarray(m, jnp.int32) for m in maps]


@partial(jax.jit, static_argnames=("bins_t", "bins_s", "bins_r",
                                   "n_seeds", "threshold", "n_levels",
                                   "max_scale_error", "eff_bins"))
def vote_and_verify(frames1, frames2, valid=None, *,
                    image_extent: float = 1024.0, bins_t: int = 16,
                    bins_s: int = 8, bins_r: int = 8, n_seeds: int = 8,
                    threshold: float = 8.0, n_levels: int = 6,
                    max_scale_error: float = 2.0,
                    eff_bins: int = 64) -> VoteVerifyResult:
    """frames1/frames2 [N, 4] matched (x, y, sigma, angle) keypoint
    frames; each match votes for a similarity transform into a
    multi-resolution pyramid; the best-scored bins seed affine refits;
    the best refit's EFFECTIVE inlier count (spatial-coverage-discounted,
    64x64 grid) is the verification score.
    """
    f1 = jnp.asarray(frames1, jnp.float32)
    f2 = jnp.asarray(frames2, jnp.float32)
    n = f1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)

    # per-match similarity parameters (TransformFromMatch, geometry.cc)
    ds = jnp.log2((f2[:, 2] + 1e-6) / (f1[:, 2] + 1e-6))   # log2 scale
    dr = f2[:, 3] - f1[:, 3]                               # rotation
    dr = jnp.arctan2(jnp.sin(dr), jnp.cos(dr))             # wrap to [-pi,pi]
    s = 2.0 ** ds
    ca, sa = jnp.cos(dr), jnp.sin(dr)
    tx = f2[:, 0] - s * (ca * f1[:, 0] - sa * f1[:, 1])
    ty = f2[:, 1] - s * (sa * f1[:, 0] + ca * f1[:, 1])

    # quantize into the finest 4-D histogram
    bt = jnp.clip(((tx / (2 * image_extent) + 0.5) * bins_t)
                  .astype(jnp.int32), 0, bins_t - 1)
    bty = jnp.clip(((ty / (2 * image_extent) + 0.5) * bins_t)
                   .astype(jnp.int32), 0, bins_t - 1)
    bs = jnp.clip(((ds / 8.0 + 0.5) * bins_s).astype(jnp.int32),
                  0, bins_s - 1)
    br = jnp.clip(((dr / (2 * jnp.pi) + 0.5) * bins_r).astype(jnp.int32),
                  0, bins_r - 1)
    flat_bin = ((bt * bins_t + bty) * bins_s + bs) * bins_r + br
    n_bins = bins_t * bins_t * bins_s * bins_r
    vote = valid.astype(jnp.float32)
    hist = jnp.zeros((n_bins,), jnp.float32).at[flat_bin].add(vote)

    # ---- multi-resolution pyramid score (vote_and_verify.cc:294-318):
    # score(bin) = votes(bin) + sum_l 0.5^l * votes(parent_l(bin)),
    # via per-level scatter-add + static parent-index gather
    score_arr = hist
    maps = _parent_maps(bins_t, bins_s, bins_r, n_levels)
    weight = 0.5
    for pm in maps:
        parent_bin = pm[flat_bin]                          # [N]
        hist_l = jnp.zeros((n_bins,), jnp.float32).at[parent_bin].add(vote)
        score_arr = score_arr + weight * hist_l[pm]
        weight *= 0.5
    # only occupied finest bins compete
    score_arr = jnp.where(hist > 0, score_arr, -1.0)

    # top bins seed refits: matches voting into a seed bin fit an affine
    _, top_bins = jax.lax.top_k(score_arr, n_seeds)        # [S]
    in_bin = (flat_bin[None, :] == top_bins[:, None]) & valid[None, :]
    w = in_bin.astype(jnp.float32)                         # [S, N]
    src = jnp.broadcast_to(f1[:, :2], (n_seeds, n, 2))
    dst = jnp.broadcast_to(f2[:, :2], (n_seeds, n, 2))
    models = fit_affine(src, dst, w)                       # [S, 2, 3]

    def model_inliers(model):
        """Two-way transfer + scale-consistency inlier test
        (ComputeInliers / ComputeScaleError semantics)."""
        proj = apply_affine(model, f1[:, :2])
        res2 = jnp.sum((proj - f2[:, :2]) ** 2, axis=-1)
        # scale consistency: feature area under the transform's linear
        # part vs measured area, ratio capped at max_scale_error
        det = jnp.abs(model[0, 0] * model[1, 1]
                      - model[0, 1] * model[1, 0])
        area_t = jnp.square(f1[:, 2]) * jnp.maximum(det, 1e-12)
        area_m = jnp.square(f2[:, 2]) + 1e-12
        ratio = jnp.maximum(area_t / area_m, area_m / area_t)
        return (res2 < threshold * threshold) \
            & (ratio <= max_scale_error * max_scale_error) & valid

    inl = jax.vmap(model_inliers)(models)                  # [S, N]
    support = jnp.sum(inl, axis=-1)
    finite = jnp.all(jnp.isfinite(models.reshape(n_seeds, -1)), axis=-1)
    support = jnp.where(finite & (jnp.sum(w, axis=-1) >= 3), support, 0)
    best = jnp.argmax(support)

    # one more refit on the winning inlier set (the LO step,
    # vote_and_verify.cc:379-397)
    w2 = inl[best].astype(jnp.float32)
    model2 = fit_affine(f1[:, :2], f2[:, :2], w2)
    inl2 = model_inliers(model2)
    ok2 = jnp.all(jnp.isfinite(model2)) & (jnp.sum(w2) >= 3)
    better = (jnp.sum(inl2) >= support[best]) & ok2
    model = jnp.where(better, model2, models[best])
    inliers = jnp.where(better, inl2, inl[best])
    n_inl = jnp.sum(inliers)

    # ---- effective inlier count (vote_and_verify.cc:152-204): occupied
    # cells of an eff_bins x eff_bins grid over the inliers' bbox in
    # image 1 — co-located (bursty) inliers count once
    xi = jnp.where(inliers, f1[:, 0], jnp.nan)
    yi = jnp.where(inliers, f1[:, 1], jnp.nan)
    min_x = jnp.nanmin(xi)
    max_x = jnp.nanmax(xi)
    min_y = jnp.nanmin(yi)
    max_y = jnp.nanmax(yi)
    sx = eff_bins / jnp.maximum(max_x - min_x, 1e-6)
    sy = eff_bins / jnp.maximum(max_y - min_y, 1e-6)
    cx = jnp.clip(((f1[:, 0] - min_x) * sx).astype(jnp.int32),
                  0, eff_bins - 1)
    cy = jnp.clip(((f1[:, 1] - min_y) * sy).astype(jnp.int32),
                  0, eff_bins - 1)
    cell = cx * eff_bins + cy
    occ = jnp.zeros((eff_bins * eff_bins,), jnp.float32).at[cell].max(
        inliers.astype(jnp.float32))
    eff = jnp.where(n_inl > 0, jnp.sum(occ), 0.0)
    return VoteVerifyResult(score=eff, model=model, inliers=inliers,
                            n_inliers=n_inl.astype(jnp.float32))
