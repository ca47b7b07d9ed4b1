"""Batched RANSAC with local optimization (LO) refit.

Reference: vlindex `RANSAC<Estimator,SupportMeasurer,Sampler>` — the
sequential adaptive-trial loop (optim/ransac.h:184-259, trial bound
:159-169) and `LORANSAC` (optim/loransac.h:54).

Redesign (SURVEY.md §7 hard part "data-dependent control
flow"): instead of a sequential loop with a data-dependent stopping rule,
over-provision S hypotheses, solve them ALL as one batched minimal-solver
call, score all S x N residuals in one broadcasted pass, pick the best
support, then LO-refit on its inliers (optionally iterated). Deterministic
given the key, fixed shapes, no host sync.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np

from cvt_tpu.match.solvers import (
    apply_affine, apply_homography, apply_similarity2d, apply_translation,
    fit_affine, fit_homography_dlt, fit_similarity2d, fit_translation)

_MODELS = {
    "affine": dict(min_n=3, fit=fit_affine, apply=apply_affine),
    "homography": dict(min_n=4, fit=fit_homography_dlt,
                       apply=apply_homography),
    # translation_transform.h / similarity at 2-D
    "translation": dict(min_n=1, fit=fit_translation,
                        apply=apply_translation),
    "similarity": dict(min_n=2, fit=fit_similarity2d,
                       apply=apply_similarity2d),
}


def progressive_minimal_samples(key, n_hypotheses: int, mn: int, valid,
                                scores=None):
    """PROSAC-style batched minimal-set sampling (reference:
    optim/sampler/progressive_sampler.cc): hypothesis j draws its
    minimal set from the T_j TOP-RANKED correspondences, with T_j
    ramping from ~2*mn up to all N — early hypotheses concentrate on
    confident matches, late ones recover the uniform sampler.

    The reference's sequential growth-function loop becomes one
    vectorized Gumbel top-k with a per-hypothesis rank cutoff.
    Returns picks [S, mn]. scores: higher = more confident (None =
    uniform over valid)."""
    n = valid.shape[0]
    if scores is None:
        logits = jnp.where(valid, 0.0, -jnp.inf)
        g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
        _, picks = jax.lax.top_k(g, mn)
        return picks
    s = jnp.where(valid, jnp.asarray(scores, jnp.float32), -jnp.inf)
    order = jnp.argsort(-s)                     # best first
    rank = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    nv = jnp.sum(valid)
    j = jnp.arange(n_hypotheses, dtype=jnp.float32) / max(
        n_hypotheses - 1, 1)
    # quadratic ramp (the PROSAC growth function's shape): T_j from
    # 2*mn to nv
    t_j = (2.0 * mn + (nv.astype(jnp.float32) - 2.0 * mn)
           * j * j).astype(jnp.int32)           # [S]
    t_j = jnp.clip(t_j, mn, nv)
    ok = (rank[None, :] < t_j[:, None]) & valid[None, :]
    logits = jnp.where(ok, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits
    _, picks = jax.lax.top_k(g, mn)
    return picks


def combination_minimal_samples(n_hypotheses: int, mn: int, n: int):
    """Deterministic exhaustive combination enumeration (reference:
    optim/combination_sampler.cc): hypothesis j gets the j-th
    lexicographic mn-combination of [0, n), wrapping around once all
    C(n, mn) combinations are exhausted — the reference resets its
    iota state the same way (combination_sampler.cc:64-68). With
    n_hypotheses >= C(n, mn) this makes RANSAC exhaustive and
    deterministic on small problems. Shape-only (no data dependence):
    computed host-side and baked as a constant under jit.

    With n < mn there are no valid combinations (C(n, mn) = 0): picks
    degenerate to repeated indices so the solver sees a rank-deficient
    sample and ransac reports success=False instead of crashing — the
    same graceful failure the uniform sampler gives."""
    out = np.empty((n_hypotheses, mn), np.int32)
    if n < mn:
        out[:] = np.arange(mn, dtype=np.int32) % max(n, 1)
        return jnp.asarray(out)
    it = itertools.combinations(range(n), mn)
    for j in range(n_hypotheses):
        c = next(it, None)
        if c is None:
            it = itertools.combinations(range(n), mn)
            c = next(it)
        out[j] = c
    return jnp.asarray(out)


def n_combinations(n: int, mn: int) -> int:
    """MaxNumSamples of the combination sampler (NChooseK)."""
    return math.comb(n, mn)


class RansacResult(NamedTuple):
    model: jax.Array       # [2, 3] affine or [3, 3] homography
    inliers: jax.Array     # [N] bool
    n_inliers: jax.Array   # scalar int32
    success: jax.Array     # scalar bool


@partial(jax.jit, static_argnames=("model", "n_hypotheses", "lo_iters",
                                   "min_inliers", "sampler"))
def ransac(key, src, dst, valid=None, *, model: str = "affine",
           threshold: float = 4.0, n_hypotheses: int = 256,
           lo_iters: int = 2, min_inliers: int = 6,
           scores=None, sampler: str = "auto") -> RansacResult:
    """src/dst [N, 2] matched points, valid [N] mask; threshold in pixels.

    scores (optional [N], higher = more confident) switches sampling to
    the PROSAC-style progressive sampler (progressive_sampler.cc).
    sampler="combination" enumerates minimal sets deterministically in
    lexicographic order (combination_sampler.cc) — exhaustive when
    n_hypotheses >= n_combinations(N, min_n); like the reference it
    ignores scores and the valid mask when sampling (invalid rows still
    never count as inliers).
    Returns the best model by inlier count and its inlier mask.
    """
    spec = _MODELS[model]
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    n = src.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    mn = spec["min_n"]
    t2 = threshold * threshold

    # ---- sample S minimal sets (uniform, progressive, or exhaustive) ---
    if sampler == "combination":
        picks = combination_minimal_samples(n_hypotheses, mn, n)
    else:
        picks = progressive_minimal_samples(key, n_hypotheses, mn, valid,
                                            scores)          # [S, mn]
    s_src = src[picks]                                       # [S, mn, 2]
    s_dst = dst[picks]

    # ---- fit all hypotheses and score all residuals --------------------
    models = spec["fit"](s_src, s_dst)                       # [S, ...]
    proj = spec["apply"](models, jnp.broadcast_to(src, (n_hypotheses, n, 2)))
    res2 = jnp.sum((proj - dst[None]) ** 2, axis=-1)         # [S, N]
    inl = (res2 < t2) & valid[None, :]
    support = jnp.sum(inl, axis=-1)                          # [S]
    finite = jnp.all(jnp.isfinite(models.reshape(n_hypotheses, -1)),
                     axis=-1)
    support = jnp.where(finite, support, -1)
    best = jnp.argmax(support)
    best_model = models[best]
    best_inl = inl[best]

    # ---- local optimization: weighted refit on inliers -----------------
    # (LORANSAC's inner refit, loransac.h:54; homography uses the
    # inlier-weighted DLT)
    refit = spec["fit"]

    def lo_step(carry, _):
        mdl, inl_mask = carry
        w = inl_mask.astype(jnp.float32)
        mdl2 = refit(src, dst, w)
        proj2 = spec["apply"](mdl2, src)
        r2 = jnp.sum((proj2 - dst) ** 2, axis=-1)
        new_inl = (r2 < t2) & valid
        # require a non-degenerate refit set: with 0 inliers the
        # all-zero-weight fit is finite garbage and 0 >= 0 would accept it
        better = ((jnp.sum(new_inl) >= jnp.sum(inl_mask))
                  & (jnp.sum(inl_mask) >= mn)
                  & jnp.all(jnp.isfinite(mdl2)))
        mdl = jnp.where(better, mdl2, mdl)
        inl_mask = jnp.where(better, new_inl, inl_mask)
        return (mdl, inl_mask), None

    if lo_iters > 0:
        (best_model, best_inl), _ = jax.lax.scan(
            lo_step, (best_model, best_inl), None, length=lo_iters)

    n_inl = jnp.sum(best_inl)
    return RansacResult(model=best_model, inliers=best_inl,
                        n_inliers=n_inl.astype(jnp.int32),
                        success=n_inl >= min_inliers)


@partial(jax.jit, static_argnames=("model", "n_hypotheses", "n_survivors",
                                   "n_probe", "lo_iters", "min_inliers"))
def ransac_preemptive(key, src, dst, valid=None, *, model: str = "affine",
                      threshold: float = 4.0, n_hypotheses: int = 1024,
                      n_survivors: int = 64, n_probe: int = 32,
                      lo_iters: int = 2,
                      min_inliers: int = 6) -> RansacResult:
    """Two-stage preemptive RANSAC — the batched analogue of SPRT
    (optim/sprt.h:45): instead of sequentially abandoning bad hypotheses
    by a probability-ratio test, ALL hypotheses are scored on a random
    n_probe-point subsample (cheap [S, n_probe] pass), the n_survivors
    best advance to full [S', N] scoring. Same compute-saving role, fixed
    shapes, one extra matmul-shaped pass instead of a data-dependent loop.
    """
    spec = _MODELS[model]
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    n = src.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    mn = spec["min_n"]
    t2 = threshold * threshold
    k_sample, k_probe = jax.random.split(key)

    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(k_sample, (n_hypotheses, n)) + logits[None, :]
    _, picks = jax.lax.top_k(g, mn)
    models = spec["fit"](src[picks], dst[picks])             # [S, ...]
    finite = jnp.all(jnp.isfinite(models.reshape(n_hypotheses, -1)), -1)

    # stage 1: probe on a shared random subset of valid observations
    gp = jax.random.gumbel(k_probe, (n,)) + logits
    _, probe = jax.lax.top_k(gp, min(n_probe, n))            # [P]
    proj_p = spec["apply"](models, jnp.broadcast_to(
        src[probe], (n_hypotheses,) + src[probe].shape))
    res_p = jnp.sum((proj_p - dst[probe][None]) ** 2, -1)
    sup_p = jnp.sum((res_p < t2) & valid[probe][None], -1)
    sup_p = jnp.where(finite, sup_p, -1)
    _, keep = jax.lax.top_k(sup_p, min(n_survivors, n_hypotheses))

    # stage 2: full scoring of the survivors only
    mk = models[keep]
    proj = spec["apply"](mk, jnp.broadcast_to(src, (keep.shape[0], n, 2)))
    res2 = jnp.sum((proj - dst[None]) ** 2, axis=-1)
    inl = (res2 < t2) & valid[None, :]
    support = jnp.where(finite[keep], jnp.sum(inl, -1), -1)
    best = jnp.argmax(support)
    best_model, best_inl = mk[best], inl[best]

    refit = fit_affine if model == "affine" else fit_homography_dlt

    def lo_step(carry, _):
        mdl, inl_mask = carry
        mdl2 = refit(src, dst, inl_mask.astype(jnp.float32))
        r2 = jnp.sum((spec["apply"](mdl2, src) - dst) ** 2, axis=-1)
        new_inl = (r2 < t2) & valid
        better = ((jnp.sum(new_inl) >= jnp.sum(inl_mask))
                  & (jnp.sum(inl_mask) >= mn)
                  & jnp.all(jnp.isfinite(mdl2)))
        return (jnp.where(better, mdl2, mdl),
                jnp.where(better, new_inl, inl_mask)), None

    if lo_iters > 0:
        (best_model, best_inl), _ = jax.lax.scan(
            lo_step, (best_model, best_inl), None, length=lo_iters)

    n_inl = jnp.sum(best_inl)
    return RansacResult(model=best_model, inliers=best_inl,
                        n_inliers=n_inl.astype(jnp.int32),
                        success=n_inl >= min_inliers)
