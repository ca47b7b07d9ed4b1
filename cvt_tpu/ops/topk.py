"""Top-k selection and shard-merge.

Replaces the reference's heap-based top-K (std::priority_queue push/pop in
brute_force_search/src/brutoforce.hpp:73-93 and hnswlib searchKnn) with
XLA's vectorized TopK, plus a chunked variant that never materializes the
full [B, N] distance matrix in HBM, and a merge used to combine per-shard
results after an all_gather (the collective top-k of SURVEY.md §2.5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def top_k_largest(scores: jax.Array, k: int):
    """Top-k largest along the last axis -> (values [..., k], idx [..., k])."""
    return jax.lax.top_k(scores, k)


def top_k_smallest(dists: jax.Array, k: int):
    """Top-k smallest along the last axis -> (values, idx)."""
    neg, idx = jax.lax.top_k(-dists, k)
    return -neg, idx


def merge_topk(dists: jax.Array, idx: jax.Array, k: int, *,
               largest: bool = False):
    """Merge candidate lists along the last axis.

    dists/idx: [..., C] candidates (e.g. per-shard or per-chunk top-k
    concatenated) -> ([..., k], [..., k]) globally-best k. `idx` carries
    global ids so the merge is a pure re-selection.
    """
    if largest:
        v, j = jax.lax.top_k(dists, k)
    else:
        v, j = jax.lax.top_k(-dists, k)
        v = -v
    return v, jnp.take_along_axis(idx, j, axis=-1)


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def chunked_topk_scan(q: jax.Array, db: jax.Array, k: int,
                      metric: str = "l2", chunk: int = 65536):
    """Exact top-k scan over a large database without a [B, N] intermediate.

    Scans `db` in chunks of `chunk` rows with lax.map; each chunk is one
    matmul + local top-k; chunk winners are merged at the end. This is
    the batched equivalent of the reference's single-thread scan loop
    (brute_force_search/src/brutoforce.hpp:73-93) and the ground-truth
    generator for every recall harness (brute_force_search/README.md:3).

    Returns (dists [B, k], idx [B, k]); for metric='ip' dists are negative
    inner products (smaller = closer) to keep one ordering convention.
    """
    from cvt_tpu.ops.linalg import pairwise_distance

    n = db.shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        # Padding rows score +inf so they never enter the top-k.
        db = jnp.concatenate(
            [db, jnp.zeros((pad, db.shape[1]), db.dtype)], axis=0)

    db_c = db.reshape(n_chunks, chunk, db.shape[1])

    def scan_chunk(carry, xs):
        c_idx, chunk_db = xs
        d = pairwise_distance(q, chunk_db, metric)              # [B, chunk]
        base = c_idx * chunk
        local_ids = base + jax.lax.broadcasted_iota(
            jnp.int32, (1, chunk), 1)
        valid = local_ids < n
        d = jnp.where(valid, d, jnp.inf)
        neg, j = jax.lax.top_k(-d, min(k, chunk))               # [B, k]
        ids = jnp.take_along_axis(
            jnp.broadcast_to(local_ids, d.shape), j, axis=-1)
        best_d, best_i = carry
        cat_d = jnp.concatenate([best_d, -neg], axis=-1)
        cat_i = jnp.concatenate([best_i, ids], axis=-1)
        return merge_topk(cat_d, cat_i, k), None

    b = q.shape[0]
    # init derived from q so it inherits device-varying axes under
    # shard_map (jax vma typing)
    zero = jnp.sum(q * 0.0, axis=-1, keepdims=True) + db[0, 0] * 0.0
    init = (jnp.broadcast_to(zero + jnp.inf, (b, k)),
            jnp.broadcast_to(zero.astype(jnp.int32) - 1, (b, k)))
    (best_d, best_i), _ = jax.lax.scan(
        scan_chunk, init, (jnp.arange(n_chunks, dtype=jnp.int32), db_c))
    return best_d, best_i
