"""Batched Lloyd's k-means, the replacement for yael kmeans.

The reference trains its coarse (K=8192) and product (K=256 x M subspaces)
codebooks with yael's multithreaded CPU kmeans
(opq/train_codebook/train_PQ_codebook.cpp:150-244, 64 OpenMP threads) and
FLANN hierarchical k-means (retrieval/vlindex/src/retrieval/visual_index.h:624-665).
Here every Lloyd iteration is two matmuls:
  assign:  argmin_k ||x - c_k||^2 via the  x.c  expansion      [N,D]x[D,K]
  update:  new_c = onehot(assign)^T @ x / counts               [K,N]x[N,D]
Empty-cluster repair mirrors the reference's check at
train_PQ_codebook.cpp:173-179: an empty centroid is re-seeded from the
point currently farthest from its assigned centroid.

PQ trains M independent codebooks by `jax.vmap`ing this whole routine over
the subspace axis — the reference's `#pragma omp parallel for` over m
(train_PQ_codebook.cpp:208) becomes one vectorized program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class KMeansResult(NamedTuple):
    centroids: jax.Array   # [K, D]
    assignments: jax.Array  # [N] int32
    objective: jax.Array   # scalar: mean squared distance


def kmeans_assign(x: jax.Array, centroids: jax.Array,
                  chunk: int | None = None):
    """Nearest-centroid assignment. x: [N, D], centroids: [K, D].

    Returns (assign [N] int32, dist [N] f32 squared L2 to the winner).
    `chunk` bounds the [chunk, K] intermediate for large N*K.
    """
    c_sq = jnp.sum(jnp.square(centroids), axis=-1)               # [K]

    def _one(xc):
        d = (jnp.sum(jnp.square(xc), axis=-1, keepdims=True)
             - 2.0 * jnp.matmul(xc, centroids.T,
                                preferred_element_type=jnp.float32)
             + c_sq[None, :])
        a = jnp.argmin(d, axis=-1).astype(jnp.int32)
        best = jnp.take_along_axis(d, a[:, None], axis=-1)[:, 0]
        return a, jnp.maximum(best, 0.0)

    n = x.shape[0]
    if chunk is None or n <= chunk:
        return _one(x)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    a, d = jax.lax.map(_one, xp.reshape(n_chunks, chunk, x.shape[1]))
    return a.reshape(-1)[:n], d.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("word_block",))
def _blocked_argmin_chunk(xc, centroids, word_block):
    """Exact argmin over a HUGE centroid set without materializing the
    [T, K] distance matrix: scan over word blocks keeping a running
    (best dist, best id). Pure matmuls + elementwise min — no gathers."""
    k = centroids.shape[0]
    n_blocks = k // word_block
    x_sq = jnp.sum(jnp.square(xc), -1, keepdims=True)             # [T, 1]
    cb3 = centroids.reshape(n_blocks, word_block, centroids.shape[1])
    c_sq3 = jnp.sum(jnp.square(cb3), -1)                          # [NB, WB]

    def body(carry, inp):
        bd, bw = carry
        off, cb, c_sq = inp
        d = (x_sq - 2.0 * jnp.matmul(xc, cb.T,
                                     preferred_element_type=jnp.float32)
             + c_sq[None, :])                                     # [T, WB]
        # argmin WITHOUT a variadic reduction: min first, then recover
        # the index by equality + int-min — three cheap reductions
        db = jnp.min(d, -1)
        cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        a = jnp.min(jnp.where(d <= db[:, None], cols, jnp.int32(2**30)),
                    -1)
        upd = db < bd
        return (jnp.where(upd, db, bd),
                jnp.where(upd, a + off, bw)), None

    big = jnp.full((xc.shape[0],), 3.4e38, jnp.float32)
    offs = jnp.arange(n_blocks, dtype=jnp.int32) * word_block
    (bd, bw), _ = jax.lax.scan(
        body, (big, jnp.zeros((xc.shape[0],), jnp.int32)),
        (offs, cb3, c_sq3))
    return bw, jnp.maximum(bd, 0.0)


def kmeans_assign_blocked(x, centroids, *, chunk: int = 8192,
                          word_block: int = 16384):
    """Exact nearest-centroid assignment for centroid sets too large for
    one [N, K] distance matrix (e.g. the 1,048,576-word vocabulary,
    visual_index.h:624-665 / exe/vocab_tree.cc:74-78).

    Scans centroid blocks with a running min: 2*N*K*D matmul flops total,
    peak memory one [chunk, word_block] block. At N=1M, K=1M, D=128 this
    is ~256 TFLOP — a few seconds of matrix-unit time — with zero gather traffic,
    so EXACT assignment is practical where the reference needed an
    approximate FLANN tree. Returns (assign [N] i32, sq dist [N] f32).
    """
    x = jnp.asarray(x, jnp.float32)
    centroids = jnp.asarray(centroids, jnp.float32)
    k = centroids.shape[0]
    wb = min(word_block, k)
    while k % wb:
        wb //= 2
    n = x.shape[0]
    if n <= chunk:
        return _blocked_argmin_chunk(x, centroids, wb)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    w, dd = jax.lax.map(
        lambda xc: _blocked_argmin_chunk(xc, centroids, wb),
        xp.reshape(n_chunks, chunk, x.shape[1]))
    return w.reshape(-1)[:n], dd.reshape(-1)[:n]


def _update(x, assign, k):
    """Centroid update via one-hot matmul. Returns (sums, counts)."""
    onehot = jax.nn.one_hot(assign, k, dtype=x.dtype)            # [N, K]
    sums = jnp.matmul(onehot.T, x, preferred_element_type=jnp.float32)
    counts = jnp.sum(onehot, axis=0, dtype=jnp.float32)          # [K]
    return sums, counts


def _repair_empty(centroids, counts, x, far_dist):
    """Re-seed empty centroids from the points farthest from their centroid."""
    k = centroids.shape[0]
    empty = counts < 0.5                                         # [K] bool
    # Rank points by distance-to-own-centroid; the j-th empty cluster takes
    # the j-th farthest point. rank[j] in [0, K): each empty centroid gets a
    # distinct donor.
    order = jnp.cumsum(empty.astype(jnp.int32)) - 1              # [K]
    _, far_idx = jax.lax.top_k(far_dist, k)                      # [K] point ids
    donors = x[far_idx[jnp.clip(order, 0, k - 1)]]               # [K, D]
    return jnp.where(empty[:, None], donors, centroids)


@partial(jax.jit, static_argnames=("k", "iters", "chunk"))
def _lloyd(x, init_centroids, k, iters, chunk):
    def body(c, _):
        assign, dist = kmeans_assign(x, c, chunk=chunk)
        sums, counts = _update(x, assign, k)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        new_c = _repair_empty(new_c, counts, x, dist)
        return new_c, jnp.mean(dist)

    c, objs = jax.lax.scan(body, init_centroids, None, length=iters)
    assign, dist = kmeans_assign(x, c, chunk=chunk)
    return c, assign, jnp.mean(dist)


def _init_random(key, x, k):
    n = x.shape[0]
    idx = jax.random.permutation(key, n)[:k]
    return x[idx]


def _init_kmeanspp(key, x, k):
    """k-means++ seeding (sequential over k; use for small k)."""
    n = x.shape[0]
    key, sub = jax.random.split(key)
    first = x[jax.random.randint(sub, (), 0, n)]

    def body(carry, key_i):
        cents, d2 = carry
        i, key_i = key_i
        p = d2 / jnp.maximum(jnp.sum(d2), 1e-30)
        nxt = x[jax.random.choice(key_i, n, p=p)]
        cents = jax.lax.dynamic_update_index_in_dim(cents, nxt, i, 0)
        d2 = jnp.minimum(d2, jnp.sum(jnp.square(x - nxt[None, :]), axis=-1))
        return (cents, d2), None

    cents = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(first)
    d2 = jnp.sum(jnp.square(x - first[None, :]), axis=-1)
    keys = jax.random.split(key, k - 1)
    (cents, _), _ = jax.lax.scan(
        body, (cents, d2), (jnp.arange(1, k), keys))
    return cents


def kmeans(key: jax.Array, x: jax.Array, k: int, *, iters: int = 25,
           init: str = "random", chunk: int | None = 262144) -> KMeansResult:
    """Full k-means: seed + `iters` Lloyd steps + final assignment.

    x: [N, D] float. Deterministic given `key` (the reference seeds its
    RNG for reproducible tests, vlindex/src/util/random.h SetPRNGSeed).
    """
    x = jnp.asarray(x, jnp.float32)
    if init == "random":
        c0 = _init_random(key, x, k)
    elif init == "kmeans++":
        c0 = _init_kmeanspp(key, x, k)
    else:
        raise ValueError(f"unknown init: {init!r}")
    c, assign, obj = _lloyd(x, c0, k, iters, chunk)
    return KMeansResult(c, assign, obj)


# --------------------------------------------------------------------------
# Hierarchical (two-level) k-means — the batched replacement for FLANN's
# hierarchical k-means tree (visual_index.h:624-665, branching=256): a
# coarse level of k1 centroids, then an independent k2-means inside every
# coarse cell. Total vocabulary k1*k2 words; training cost is O(N*k1 +
# N*k2) matmul flops instead of the flat O(N*k1*k2), which is what makes
# a 65,536-1M word vocabulary trainable at all (the flat assignment
# matmul alone would be 128 GB of distances per 1M-descriptor pass).
# --------------------------------------------------------------------------

class HierKMeansResult(NamedTuple):
    coarse: jax.Array     # [K1, D]
    fine: jax.Array       # [K1, K2, D] per-cell codebooks
    objective: jax.Array  # scalar: mean squared distance (training sample)

    @property
    def n_words(self) -> int:
        return self.fine.shape[0] * self.fine.shape[1]

    def flat_words(self) -> jax.Array:
        """[K1*K2, D] flattened vocabulary (word id = cell*K2 + sub)."""
        k1, k2, d = self.fine.shape
        return self.fine.reshape(k1 * k2, d)


@partial(jax.jit, static_argnames=("k", "iters"))
def _masked_lloyd_batch(xs, mask, c0, k, iters):
    """Vmapped masked Lloyd over a batch of cells.

    xs [C, S, D] padded per-cell samples; mask [C, S] validity;
    c0 [C, k, D] initial centroids. Empty clusters are re-seeded from the
    cell's farthest valid point each step (same policy as _repair_empty).
    """

    def one_cell(x, m, c_init):
        big = jnp.float32(3.4e38)

        def body(c, _):
            d = (jnp.sum(jnp.square(x), -1, keepdims=True)
                 - 2.0 * jnp.matmul(x, c.T,
                                    preferred_element_type=jnp.float32)
                 + jnp.sum(jnp.square(c), -1)[None, :])      # [S, k]
            a = jnp.argmin(d, -1).astype(jnp.int32)
            best = jnp.maximum(
                jnp.take_along_axis(d, a[:, None], -1)[:, 0], 0.0)
            onehot = jax.nn.one_hot(a, k, dtype=x.dtype) * m[:, None]
            sums = jnp.matmul(onehot.T, x,
                              preferred_element_type=jnp.float32)
            counts = jnp.sum(onehot, 0)
            new_c = sums / jnp.maximum(counts, 1.0)[:, None]
            far = jnp.where(m > 0.5, best, -big)
            repaired = _repair_empty(new_c, counts, x, far)
            # a cell with no valid points keeps its init centroids
            new_c = jnp.where(jnp.sum(m) > 0.5, repaired, c)
            obj = (jnp.sum(best * m)
                   / jnp.maximum(jnp.sum(m), 1.0))
            return new_c, obj

        c, objs = jax.lax.scan(body, c_init, None, length=iters)
        return c, objs[-1]

    return jax.vmap(one_cell)(xs, mask, c0)


def hierarchical_kmeans(key: jax.Array, x, k1: int = 256, k2: int = 256, *,
                        coarse_iters: int = 15, fine_iters: int = 12,
                        sample_per_cell: int = 4096, cell_chunk: int = 64,
                        chunk: int | None = 262144) -> HierKMeansResult:
    """Two-level vocabulary: coarse k1-means, then k2-means per cell.

    Cells train on up to `sample_per_cell` member points (subsampled
    deterministically), `cell_chunk` cells per device dispatch. Cells
    with fewer than k2 members fill the spare centroids with jittered
    copies of their members (harmless duplicate words).
    """
    import numpy as np

    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    res = kmeans(key, x, k1, iters=coarse_iters, chunk=chunk)
    coarse = res.centroids
    asg = np.asarray(res.assignments)

    rng = np.random.default_rng(np.asarray(
        jax.random.key_data(key)).ravel()[-1])
    order = np.argsort(asg, kind="stable")
    starts = np.searchsorted(asg[order], np.arange(k1 + 1))
    xs_np = np.asarray(x)

    s = max(1, min(sample_per_cell, n))
    fine = np.zeros((k1, k2, d), np.float32)
    objs = []
    for lo in range(0, k1, cell_chunk):
        hi = min(k1, lo + cell_chunk)
        c = hi - lo
        samp = np.zeros((c, s, d), np.float32)
        mask = np.zeros((c, s), np.float32)
        inits = np.zeros((c, k2, d), np.float32)
        for j, cell in enumerate(range(lo, hi)):
            mem = order[starts[cell]:starts[cell + 1]]
            if len(mem) == 0:
                # empty coarse cell: its words sit at the coarse centroid
                inits[j] = np.asarray(coarse[cell])[None, :] + rng.normal(
                    0, 1e-3, size=(k2, d))
                continue
            take = (mem if len(mem) <= s
                    else mem[rng.permutation(len(mem))[:s]])
            samp[j, :len(take)] = xs_np[take]
            mask[j, :len(take)] = 1.0
            seed = take[rng.permutation(len(take))[:k2]]
            inits[j, :len(seed)] = xs_np[seed]
            if len(seed) < k2:  # jittered copies for cells with < k2 pts
                reps = rng.integers(0, len(seed), size=k2 - len(seed))
                inits[j, len(seed):] = (xs_np[seed[reps]]
                                        + rng.normal(0, 1e-3,
                                                     (k2 - len(seed), d)))
        cb, obj = _masked_lloyd_batch(jnp.asarray(samp), jnp.asarray(mask),
                                      jnp.asarray(inits), k2, fine_iters)
        fine[lo:hi] = np.asarray(cb)
        objs.append(np.asarray(obj))
    objective = jnp.asarray(float(np.mean(np.concatenate(objs))))
    return HierKMeansResult(coarse, jnp.asarray(fine), objective)


@partial(jax.jit, static_argnames=("probes",))
def _hier_assign_chunk(xc, coarse, fine, probes):
    """One chunk of hierarchical assignment with multi-probe.

    xc [T, D]; probes coarse cells are searched per point, fine argmin is
    exact within each probed cell; the global (cell, sub) min wins.
    Returns (word ids [T] int32 = cell*K2 + sub, squared distance [T]).
    """
    k1, k2, d = fine.shape
    c_sq = jnp.sum(jnp.square(coarse), -1)
    x_sq = jnp.sum(jnp.square(xc), -1, keepdims=True)
    d1 = (x_sq - 2.0 * jnp.matmul(xc, coarse.T,
                                  preferred_element_type=jnp.float32)
          + c_sq[None, :])                                     # [T, K1]
    _, cells = jax.lax.top_k(-d1, probes)                      # [T, P]

    f_sq = jnp.sum(jnp.square(fine), -1)                       # [K1, K2]

    def probe(carry, p):
        best_d, best_w = carry
        cell = cells[:, p]                                     # [T]
        cb = fine[cell]                                        # [T, K2, D]
        ip = jnp.einsum("td,tkd->tk", xc, cb,
                        preferred_element_type=jnp.float32)
        dd = x_sq - 2.0 * ip + f_sq[cell]                      # [T, K2]
        a = jnp.argmin(dd, -1).astype(jnp.int32)
        db = jnp.take_along_axis(dd, a[:, None], -1)[:, 0]
        w = cell * k2 + a
        upd = db < best_d
        return (jnp.where(upd, db, best_d),
                jnp.where(upd, w, best_w)), None

    big = jnp.full((xc.shape[0],), 3.4e38, jnp.float32)
    (bd, bw), _ = jax.lax.scan(
        probe, (big, jnp.zeros((xc.shape[0],), jnp.int32)),
        jnp.arange(probes))
    return bw, jnp.maximum(bd, 0.0)


def hierarchical_assign(x, coarse, fine, *, probes: int = 4,
                        chunk: int = 16384):
    """Assign [N, D] points to k1*k2 hierarchical words (multi-probe).

    probes=1 is the FLANN tree-descent equivalent; probes>=4 recovers
    >=95% agreement with the exact flat argmin over all k1*k2 words at a
    small constant-factor cost (each probe is one gathered [T, K2, D]
    einsum instead of a [T, K1*K2] matmul).
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    # bound the per-probe gathered [chunk, K2, D] working set to ~1 GB
    # (at K2=1024, D=128 the old fixed 16384 chunk would gather 8.6 GB)
    k1, k2, d = fine.shape
    chunk = max(256, min(chunk, (1 << 28) // max(k2 * d, 1)))
    if n <= chunk:
        return _hier_assign_chunk(x, coarse, fine, probes)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    w, dd = jax.lax.map(
        lambda xc: _hier_assign_chunk(xc, coarse, fine, probes),
        xp.reshape(n_chunks, chunk, x.shape[1]))
    return w.reshape(-1)[:n], dd.reshape(-1)[:n]
