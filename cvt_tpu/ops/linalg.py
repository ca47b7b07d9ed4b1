"""Normalization and pairwise-distance primitives.

Batched replacements for the reference's scalar/SIMD math:
  * L2 normalization: cvt `MathUtil::L2NormVec` (utils/math_util.h:15-40,
    eps guard) and the RootSIFT L2 step (hnsw_sifts_retrieval/makeSIFTs.cpp:79-95).
  * Inner-product / L2 distance scans: cvt's hand-rolled AVX kernels
    `InnerProductSIMD16Ext` (brute_force_search/src/space_ip.hpp:134-208) and
    `L2SqrSIMD16Ext` (hnsw_sifts_retrieval/hnswlib/space_l2.h:41-151).
    Here the whole scan is one contraction `[B,D] x [D,N]`; the
    `||x||^2 - 2<x,c> + ||c||^2` expansion keeps it matmul-shaped.

The products default to Precision.HIGHEST: these scans are the ground
truth of every recall figure, and a GPU would otherwise run a float32
product in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-12  # matches cvt math_util.h:21 epsilon guard


def l2_normalize(x: jax.Array, axis: int = -1, eps: float = EPS) -> jax.Array:
    """L2-normalize along `axis` with an epsilon guard.

    Matches cvt `MathUtil::L2NormVec` semantics: x / sqrt(sum(x^2) + eps).
    """
    sq = jnp.sum(jnp.square(x), axis=axis, keepdims=True)
    return x * jax.lax.rsqrt(sq + eps)


HIGHEST = jax.lax.Precision.HIGHEST


def pairwise_ip(q: jax.Array, db: jax.Array, *,
                precision=HIGHEST) -> jax.Array:
    """Inner products between all query/database pairs.

    q: [B, D], db: [N, D] -> [B, N]. One matmul — the batched equivalent
    of cvt's AVX `InnerProduct*` kernel looped over N.
    """
    return jnp.matmul(q, db.T, precision=precision,
                      preferred_element_type=jnp.float32)


def pairwise_l2sq(q: jax.Array, db: jax.Array, *,
                  db_sqnorm: jax.Array | None = None,
                  precision=HIGHEST) -> jax.Array:
    """Squared L2 distances between all query/database pairs.

    q: [B, D], db: [N, D] -> [B, N] via the matmul expansion
    ||q||^2 - 2 q.db + ||db||^2 so the O(B*N*D) work is one matmul.
    `db_sqnorm` ([N]) may be precomputed once per database.
    """
    qn = jnp.sum(jnp.square(q), axis=-1, keepdims=True)          # [B, 1]
    if db_sqnorm is None:
        db_sqnorm = jnp.sum(jnp.square(db), axis=-1)             # [N]
    ip = jnp.matmul(q, db.T, precision=precision,
                    preferred_element_type=jnp.float32)          # [B, N]
    d = qn - 2.0 * ip + db_sqnorm[None, :]
    return jnp.maximum(d, 0.0)


def pairwise_distance(q: jax.Array, db: jax.Array, metric: str = "l2",
                      **kw) -> jax.Array:
    """Dispatch on metric. 'l2' -> squared L2 (smaller=closer);
    'ip' -> negative inner product (smaller=closer), mirroring hnswlib's
    `1 - ip` convention up to an affine shift (space_ip.hpp:31)."""
    if metric == "l2":
        return pairwise_l2sq(q, db, **kw)
    if metric == "ip":
        return -pairwise_ip(q, db, **kw)
    raise ValueError(f"unknown metric: {metric!r}")
