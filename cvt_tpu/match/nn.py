"""Descriptor matching: 2-NN ratio test + cross-check + threshold.

Reference: `ComputeSiftDistanceMatrix` + `FindBestMatchesBruteForce`
(retrieval/vlindex/src/feature/sift.cc:171, :55-150 — ratio and cross
checks) and the FLANN 2-NN ratio filter used everywhere else
(video_object_match/src/demo.cpp distRatio=0.9,
correspondence_matching/examples/opencv_sift_matching.cc 1nn/2nn).

Batched design: the distance matrix is one matmul; both nearest
neighbors come from a single top-2; masks handle padded keypoint slots.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class MatchResult(NamedTuple):
    """idx1 [K] int32 into set 1 (= arange), idx2 [K] best match in set 2,
    dist [K] squared L2, valid [K] bool (passed ratio/cross/threshold and
    both endpoints are real keypoints)."""
    idx2: jax.Array
    dist: jax.Array
    valid: jax.Array


@partial(jax.jit, static_argnames=("ratio", "cross_check", "max_dist"))
def match_descriptors(d1, d2, valid1=None, valid2=None, *,
                      ratio: float = 0.9, cross_check: bool = True,
                      max_dist: float = jnp.inf) -> MatchResult:
    """d1 [K1, D], d2 [K2, D] (unit-normalized or raw); returns per-row-of-
    d1 best match in d2. Lowe ratio test on squared distances uses
    dist1 < ratio^2 * dist2."""
    d1 = jnp.asarray(d1, jnp.float32)
    d2 = jnp.asarray(d2, jnp.float32)
    k1, k2 = d1.shape[0], d2.shape[0]
    if valid1 is None:
        valid1 = jnp.ones((k1,), bool)
    if valid2 is None:
        valid2 = jnp.ones((k2,), bool)
    n1 = jnp.sum(jnp.square(d1), axis=-1)
    n2 = jnp.sum(jnp.square(d2), axis=-1)
    ip = jnp.matmul(d1, d2.T, preferred_element_type=jnp.float32)
    dist = n1[:, None] - 2.0 * ip + n2[None, :]                  # [K1, K2]
    dist = jnp.where(valid2[None, :], dist, jnp.inf)
    neg2, top2 = jax.lax.top_k(-dist, 2)                         # [K1, 2]
    best, second = -neg2[:, 0], -neg2[:, 1]
    idx2 = top2[:, 0]
    ok = valid1 & (best < (ratio * ratio) * second) & (best < max_dist)
    if cross_check:
        distT = jnp.where(valid1[:, None], dist, jnp.inf)
        back = jnp.argmin(distT, axis=0)                         # [K2]
        ok = ok & (back[idx2] == jnp.arange(k1))
    return MatchResult(idx2=idx2, dist=jnp.maximum(best, 0.0), valid=ok)
