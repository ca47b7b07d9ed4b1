"""Visual-word index with Hamming embedding and TF-IDF scoring.

Reference: retrieval/vlindex/src/retrieval/ — `VisualIndex<uint8_t,128,64>`
(visual_index.h:59-183): FLANN hierarchical-kmeans vocabulary (Build,
:624-665), 64-bit Hamming-embedding projection + per-word thresholds
(inverted_index.h:174-183, inverted_file.h:276-292), `Query` scoring with
exp(-h^2/sigma^2) weights x idf^2 and burstiness /sqrt(votes)
(inverted_file.h:295-353, utils.h:52-83), self-similarity normalization
(inverted_index.h:238-288), and query-time spatial verification:
per-feature Hamming matching -> 1-to-1 match selection (two Fibonacci
heaps, visual_index.h:376-479) -> VoteAndVerify re-ranking (:481-501).
Papers: Schoenberger et al. ACCV'16, Arandjelovic-Zisserman ACCV'14
(cited at visual_index.h:51-58).

Redesign:
  * vocabulary = batched k-means (one matmul per Lloyd step); for
    large vocabularies use a hierarchical two-level quantizer
    (cvt_tpu.ops.kmeans.hierarchical_kmeans) replacing FLANN's tree —
    word assignment is two small matmuls instead of one huge one;
  * the 64-bit signature lives as 2 x uint32 words; Hamming matching is
    XOR + popcount, elementwise;
  * per-word HE thresholds are per-word MEDIANS of the projected
    training descriptors, matching inverted_file.h:276-292;
  * inverted files are PADDED DENSE BUCKETS [W, L] (image id, feature
    id, signature, burstiness weight, 4-f geometry); a query feature's
    word lookup is a static gather and the whole query batch scores in
    one vectorized pass with a scatter-add into the image-score vector.
    Entries beyond a word's bucket capacity go to an OVERFLOW TAIL that
    is scored exactly in a second vectorized pass — nothing is dropped;
  * idf uses the smoothed form log((N+1)/(n_w+0.5)) instead of the
    reference's log(N/n_w) (inverted_file.h:258-268): identical ordering
    and asymptotics, but never exactly 0, so scoring stays alive on tiny
    corpora where every word occurs in every image;
  * query-time verification is fully batched: candidate images are
    verified in one vmapped pass (word-equality + Hamming match ->
    best-match 1-to-1 dedup -> vote_and_verify Hough + affine refit),
    replacing the per-image Fibonacci-heap loop.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.match.vote_verify import vote_and_verify
from cvt_tpu.ops.kmeans import (hierarchical_assign, hierarchical_kmeans,
                                kmeans, kmeans_assign,
                                kmeans_assign_blocked)

HE_BITS = 64
HE_MAX_DIST = 24       # visual_index.h max Hamming distance
HE_SIGMA = 16.0        # utils.h HammingDistWeightFunctor sigma


def _pack_bits(bits: jax.Array) -> jax.Array:
    """bits [..., 64] bool -> [..., 2] uint32."""
    w = jnp.asarray((1 << np.arange(32, dtype=np.uint32)).astype(np.uint32))
    lo = jnp.sum(jnp.where(bits[..., :32], w, jnp.uint32(0)), axis=-1,
                 dtype=jnp.uint32)
    hi = jnp.sum(jnp.where(bits[..., 32:], w, jnp.uint32(0)), axis=-1,
                 dtype=jnp.uint32)
    return jnp.stack([lo, hi], axis=-1)


def _hamming(a: jax.Array, b: jax.Array) -> jax.Array:
    """a [..., 2] u32 vs b [..., 2] u32 (broadcastable) -> popcount."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def _he_weight(h: jax.Array) -> jax.Array:
    """exp(-h^2/sigma^2), zeroed beyond HE_MAX_DIST (utils.h:52-83)."""
    w = jnp.exp(-(h.astype(jnp.float32) ** 2) / (HE_SIGMA ** 2))
    return jnp.where(h <= HE_MAX_DIST, w, 0.0)


def _score_one(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
               buckets_burst, tail_word, tail_img, tail_sig, tail_burst,
               idf, n_images, tail_tc=32768):
    """q_words [Kq]; q_sigs [Kq, 2]; buckets_* [W, L, ...]; tail_* [T, ...].

    Returns unnormalized image scores [n_images]. The tail pass scores
    bucket-overflow entries exactly (word-equality gather replaced by a
    dense [Kq, T] word-equality mask). `tail_tc` bounds the per-step
    [Kq, Tc] tail matrix (smaller when many queries are vmapped over
    this body so [Q, Kq, Tc] stays in memory budget).
    """
    b_img = buckets_img[q_words]                  # [Kq, L]
    b_sig = buckets_sig[q_words]                  # [Kq, L, 2]
    b_burst = buckets_burst[q_words]              # [Kq, L]
    h = _hamming(q_sigs[:, None, :], b_sig)       # [Kq, L]
    w = _he_weight(h)
    w = w * (idf[q_words] ** 2)[:, None] * b_burst
    w = jnp.where((b_img >= 0) & q_valid[:, None], w, 0.0)
    flat_img = jnp.where(b_img >= 0, b_img, 0).reshape(-1)
    scores = jnp.zeros((n_images,), jnp.float32).at[flat_img].add(
        w.reshape(-1))

    # exact overflow-tail pass (empty tail = no-op of static shape
    # [Kq, 1]); chunked over the tail so a large overflow (big corpora /
    # 1M-word skew) never materializes a [Kq, T] matrix bigger than
    # [Kq, 32768] per step
    t = tail_word.shape[0]
    tc = min(t, tail_tc)
    n_tc = -(-t // tc)
    pad = n_tc * tc - t
    if pad:
        tail_word = jnp.pad(tail_word, (0, pad), constant_values=-1)
        tail_img = jnp.pad(tail_img, (0, pad), constant_values=-1)
        tail_sig = jnp.pad(tail_sig, ((0, pad), (0, 0)))
        tail_burst = jnp.pad(tail_burst, (0, pad))
    idf_q2 = (idf[q_words] ** 2)[:, None]

    def tail_chunk(scores, inp):
        tw_w, tw_i, tw_s, tw_b = inp
        th = _hamming(q_sigs[:, None, :], tw_s[None, :, :])   # [Kq, Tc]
        tw = _he_weight(th) * idf_q2 * tw_b[None, :]
        same_word = q_words[:, None] == tw_w[None, :]
        tw = jnp.where(same_word & (tw_i[None, :] >= 0)
                       & q_valid[:, None], tw, 0.0)
        t_img = jnp.where(tw_i >= 0, tw_i, 0)
        return scores.at[jnp.broadcast_to(t_img[None, :], tw.shape)
                         .reshape(-1)].add(tw.reshape(-1)), None

    scores, _ = jax.lax.scan(
        tail_chunk, scores,
        (tail_word.reshape(n_tc, tc), tail_img.reshape(n_tc, tc),
         tail_sig.reshape(n_tc, tc, 2), tail_burst.reshape(n_tc, tc)))
    return scores


@partial(jax.jit, static_argnames=("n_images",))
def _score_query(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
                 buckets_burst, tail_word, tail_img, tail_sig, tail_burst,
                 idf, n_images):
    return _score_one(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
                      buckets_burst, tail_word, tail_img, tail_sig,
                      tail_burst, idf, n_images)


@partial(jax.jit, static_argnames=("n_images", "tail_tc"))
def _score_query_many(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
                      buckets_burst, tail_word, tail_img, tail_sig,
                      tail_burst, idf, n_images, tail_tc):
    """Batched scoring: q_words [Q, Kq], q_sigs [Q, Kq, 2], q_valid
    [Q, Kq] -> [Q, n_images]. One compiled program scores the whole
    query batch; bucket gathers and the tail pass batch over Q (the
    reference loops exe/vocab_tree.cc:155-181 one image at a time)."""
    return jax.vmap(
        lambda w, s, v: _score_one(
            w, s, v, buckets_img, buckets_sig, buckets_burst, tail_word,
            tail_img, tail_sig, tail_burst, idf, n_images,
            tail_tc=tail_tc))(q_words, q_sigs, q_valid)


@jax.jit
def _self_similarity(words, sigs, valid, idf):
    """Direct per-image self-scores [B]: for every same-word entry pair
    (i, j) within one image, w_he(hamming) * idf^2 * burst_j with
    burst_j = 1/sqrt(#same-word entries) — exactly what _score_query
    would credit the image querying itself."""

    def one(w, s, v):
        same = (w[:, None] == w[None, :]) & v[:, None] & v[None, :]
        h = _hamming(s[:, None, :], s[None, :, :])
        wt = _he_weight(h) * (idf[w] ** 2)[:, None]
        votes = jnp.sum(same, axis=0).astype(jnp.float32)
        burst_j = jax.lax.rsqrt(jnp.maximum(votes, 1.0))
        return jnp.sum(jnp.where(same, wt * burst_j[None, :], 0.0))

    return jax.vmap(one)(words, sigs, valid)


@partial(jax.jit, static_argnames=("image_extent",))
def _verify_candidates(q_words, q_sigs, q_valid, q_geom,
                       c_words, c_sigs, c_valid, c_geom, idf,
                       image_extent):
    """Spatially verify a query against C candidate images.

    q_* : [Kq, ...] query features; c_* : [C, Ki, ...] candidate entries
    (padded). Implements visual_index.h:260-501 semantics batched:
    word-equality + Hamming<=24 matching, weight = exp(-h^2/s^2)*idf^2,
    1-to-1 selection by best-match dedup (the batched stand-in for the
    two-Fibonacci-heap greedy), then vote_and_verify. Returns [C]
    verification scores (effective inlier counts)."""

    def one(cw, cs, cv, cg):
        same = q_words[:, None] == cw[None, :]                 # [Kq, Ki]
        h = _hamming(q_sigs[:, None, :], cs[None, :, :])
        wm = _he_weight(h) * (idf[q_words] ** 2)[:, None]
        wm = jnp.where(same & q_valid[:, None] & cv[None, :], wm, 0.0)
        # 1-to-1: each query feature picks its best db feature ...
        best_j = jnp.argmax(wm, axis=1)                        # [Kq]
        best_w = jnp.max(wm, axis=1)                           # [Kq]
        # ... and each db feature keeps only the best query claiming it
        claim = jnp.zeros((cw.shape[0],), jnp.float32).at[best_j].max(
            best_w)
        keep = (best_w > 0.0) & (best_w >= claim[best_j])
        # break residual ties (two queries with equal weight): keep the
        # first by index
        qi = jnp.arange(q_words.shape[0], dtype=jnp.int32)
        first = jnp.full((cw.shape[0],), 2 ** 30, jnp.int32).at[
            best_j].min(jnp.where(keep, qi, jnp.int32(2 ** 30)))
        keep = keep & (first[best_j] == qi)
        g2 = cg[best_j]                                        # [Kq, 4]
        res = vote_and_verify(q_geom, g2, keep,
                              image_extent=image_extent)
        return res.score

    return jax.vmap(one)(c_words, c_sigs, c_valid, c_geom)


class VocabHEIndex:
    """Visual-word + Hamming-embedding image retrieval index."""

    def __init__(self, n_words: int = 4096, dim: int = 128,
                 bucket_cap: int | None = None,
                 hierarchical: bool | None = None, probes: int = 8):
        """hierarchical: two-level vocabulary (FLANN-tree replacement,
        visual_index.h:624-665); None = auto (on for n_words >= 16384,
        where the flat assignment matmul stops being practical). The
        reference operating point — 1M words — requires it. probes:
        coarse cells searched per descriptor at assignment; probes=0
        selects EXACT blocked assignment over the flat vocabulary
        (kmeans_assign_blocked: running-min over word blocks, pure matmuls —
        ~256 TFLOP for 1M descriptors x 1M words, a few seconds on chip,
        where the reference had to settle for FLANN's approximate
        tree descent)."""
        self.n_words = n_words
        self.dim = dim
        self.bucket_cap = bucket_cap
        self.hierarchical = (n_words >= 16384 if hierarchical is None
                             else hierarchical)
        self.probes = probes
        self.words: jax.Array | None = None       # [W, D]
        self.coarse: jax.Array | None = None      # [K1, D] (hierarchical)
        self.fine: jax.Array | None = None        # [K1, K2, D]
        self.he_proj: jax.Array | None = None     # [D, 64]
        self.he_thresh: jax.Array | None = None   # [W, 64]
        self._entries: list = []        # staged (img, words, sigs, geom)
        self._names: list = []
        self._prepared = False

    @staticmethod
    def _factor(n_words: int) -> tuple[int, int]:
        """Balanced k1*k2 = n_words factorization (k1 <= k2)."""
        k1 = int(n_words ** 0.5)
        while k1 > 1 and n_words % k1:
            k1 -= 1
        return k1, n_words // k1

    @property
    def n_images(self) -> int:
        return len(self._names)

    # ---------------------------------------------------------------- train
    def train(self, key, descriptors, *, iters: int = 20) -> None:
        """Build the vocabulary + HE projection/thresholds from a training
        descriptor sample [N, D]."""
        x = jnp.asarray(descriptors, jnp.float32)
        if self.hierarchical:
            k1, k2 = self._factor(self.n_words)
            hres = hierarchical_kmeans(key, x, k1, k2,
                                       coarse_iters=iters,
                                       fine_iters=max(iters // 2, 6))
            self.coarse, self.fine = hres.coarse, hres.fine
            self.words = hres.flat_words()
            if self.probes == 0:
                assignments, _ = kmeans_assign_blocked(x, self.words)
            else:
                assignments, _ = hierarchical_assign(
                    x, self.coarse, self.fine, probes=self.probes)
        else:
            res = kmeans(key, x, self.n_words, iters=iters, chunk=65536)
            self.words = res.centroids
            assignments = res.assignments
        # random orthogonal projection to 64 dims (QR of a Gaussian,
        # inverted_index.h:174-183). For dim < 64 the reference's single
        # QR cannot supply 64 orthogonal directions; concatenate
        # independent orthogonal blocks until 64 columns exist (each
        # block is orthogonal, bits stay balanced).
        blocks = []
        nb = -(-HE_BITS // self.dim)
        for bi in range(nb):
            g = jax.random.normal(jax.random.fold_in(key, 1 + bi),
                                  (self.dim, self.dim))
            qmat, _ = jnp.linalg.qr(g)
            blocks.append(qmat)
        self.he_proj = jnp.concatenate(blocks, axis=1)[:, :HE_BITS]
        proj = np.asarray(jnp.matmul(
            x, self.he_proj, preferred_element_type=jnp.float32))  # [N, 64]
        # per-word MEDIAN threshold (inverted_file.h:276-292), fully
        # vectorized over words: one lexsort per projection column keyed
        # by (word, value) makes every word's column values contiguous
        # AND sorted, so the two middle elements index directly — O(D)
        # sorts total instead of the round-2 O(n_words) host loop that
        # could not reach the 65,536-word operating point
        asg = np.asarray(assignments)
        counts = np.bincount(asg, minlength=self.n_words)
        starts = np.zeros(self.n_words + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        lo = starts[:-1]
        i1 = lo + np.maximum(counts - 1, 0) // 2
        i2 = lo + np.maximum(counts, 1) // 2
        last = max(len(proj) - 1, 0)
        i1 = np.minimum(i1, last)
        i2 = np.minimum(i2, last)
        thr = np.empty((self.n_words, HE_BITS), np.float32)
        for c in range(HE_BITS):
            order_c = np.lexsort((proj[:, c], asg))
            col = proj[order_c, c]
            thr[:, c] = 0.5 * (col[i1] + col[i2])
        global_med = (np.median(proj, axis=0) if len(proj)
                      else np.zeros(HE_BITS, np.float32))
        thr[counts == 0] = global_med
        self.he_thresh = jnp.asarray(thr)

    # ------------------------------------------------------------------ add
    def _encode(self, descriptors):
        x = jnp.asarray(descriptors, jnp.float32)
        if self.hierarchical and self.probes == 0:
            words, _ = kmeans_assign_blocked(x, self.words)
        elif self.hierarchical:
            words, _ = hierarchical_assign(x, self.coarse, self.fine,
                                           probes=self.probes)
        else:
            words, _ = kmeans_assign(x, self.words)
        proj = jnp.matmul(x, self.he_proj,
                          preferred_element_type=jnp.float32)
        sigs = _pack_bits(proj > self.he_thresh[words])
        return words, sigs

    def add_image(self, descriptors, name: str | None = None,
                  geometries=None) -> int:
        """Stage one image's descriptors [K, D] (call prepare() after).

        geometries: optional [K, 4] (x, y, scale, orientation) keypoint
        frames enabling query-time spatial verification
        (inverted_file_entry.h:47-109 stores the same 16-byte geometry).
        """
        if self._names and not self._entries:
            # a load()ed index keeps only its BAKED bucket layout; new
            # stagings would orphan every loaded entry on re-prepare
            # (prepare rebuilds from staged entries alone). Rebuild the
            # index from descriptors to extend it.
            raise ValueError(
                "cannot add_image to a loaded VocabHEIndex: its entries "
                "are baked into the prepared layout; rebuild the index "
                "from descriptors to extend it")
        img_id = self.n_images
        words, sigs = self._encode(descriptors)
        k = len(np.asarray(words))
        geom = (np.zeros((k, 4), np.float32) if geometries is None
                else np.asarray(geometries, np.float32).reshape(k, 4))
        self._entries.append((img_id, np.asarray(words), np.asarray(sigs),
                              geom))
        self._names.append(name or f"img_{img_id}")
        self._prepared = False
        return img_id

    # -------------------------------------------------------------- prepare
    def prepare(self) -> None:
        """Lay out padded per-word buckets (+ exact overflow tail), idf,
        burstiness weights, and per-image self-similarity norms
        (visual_index.h:505-508) in one batched scoring pass."""
        if self._prepared and not self._entries:
            return                  # loaded index: layout already baked
        w_all = np.concatenate([w for _, w, _, _ in self._entries])
        s_all = np.concatenate([s for _, _, s, _ in self._entries])
        g_all = np.concatenate([g for _, _, _, g in self._entries])
        i_all = np.concatenate([np.full(len(w), i, np.int32)
                                for i, w, _, _ in self._entries])
        f_all = np.concatenate([np.arange(len(w), dtype=np.int32)
                                for _, w, _, _ in self._entries])
        counts = np.bincount(w_all, minlength=self.n_words)
        cap = self.bucket_cap
        if cap is None:
            cap = int(min(max(counts.max(), 1),
                          max(8, 8 * max(1, len(w_all) // self.n_words))))
            # grow cap until the overflow tail holds <= 1/8 of all
            # entries (bursty words at W=1M would otherwise push most of
            # the corpus into the dense-scanned tail)
            while cap < counts.max():
                tail_sz = int(np.clip(counts - cap, 0, None).sum())
                if tail_sz <= max(1024, len(w_all) // 8):
                    break
                cap *= 2
        cap = -(-cap // 8) * 8

        # smoothed idf (see module docstring)
        pairs = np.unique(np.stack([w_all, i_all], 1), axis=0)
        n_img_with_word = np.bincount(pairs[:, 0], minlength=self.n_words)
        idf = np.log((self.n_images + 1.0) / (n_img_with_word + 0.5))
        idf = np.maximum(idf, 0.0).astype(np.float32)

        # burstiness: weight 1/sqrt(#entries of this image in this word)
        order = np.lexsort((i_all, w_all))
        ws, is_ = w_all[order], i_all[order]
        grp = np.concatenate([[True], (ws[1:] != ws[:-1])
                              | (is_[1:] != is_[:-1])])
        gid = np.cumsum(grp) - 1
        gsize = np.bincount(gid)
        burst = (1.0 / np.sqrt(gsize[gid])).astype(np.float32)

        starts = np.zeros(self.n_words + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(len(ws)) - starts[ws]
        keep = rank < cap
        over = ~keep

        b_img = np.full((self.n_words, cap), -1, np.int32)
        b_sig = np.zeros((self.n_words, cap, 2), np.uint32)
        b_burst = np.zeros((self.n_words, cap), np.float32)
        b_img[ws[keep], rank[keep]] = is_[keep]
        b_sig[ws[keep], rank[keep]] = s_all[order][keep]
        b_burst[ws[keep], rank[keep]] = burst[keep]

        # exact overflow tail (padded to a multiple of 8, min 1 slot so
        # the scoring pass keeps a static shape)
        t_n = int(over.sum())
        t_cap = max(8, -(-t_n // 8) * 8) if t_n else 1
        t_word = np.full((t_cap,), -1, np.int32)
        t_img = np.full((t_cap,), -1, np.int32)
        t_sig = np.zeros((t_cap, 2), np.uint32)
        t_burst = np.zeros((t_cap,), np.float32)
        if t_n:
            t_word[:t_n] = ws[over]
            t_img[:t_n] = is_[over]
            t_sig[:t_n] = s_all[order][over]
            t_burst[:t_n] = burst[over]

        self._b_img = jnp.asarray(b_img)
        self._b_sig = jnp.asarray(b_sig)
        self._b_burst = jnp.asarray(b_burst)
        self._t_word = jnp.asarray(t_word)
        self._t_img = jnp.asarray(t_img)
        self._t_sig = jnp.asarray(t_sig)
        self._t_burst = jnp.asarray(t_burst)
        self._idf = jnp.asarray(idf)
        self.n_overflow = t_n

        # padded per-image entry tables for verification + batched
        # self-similarity
        kmax = max(len(w) for _, w, _, _ in self._entries)
        kmax = -(-kmax // 8) * 8
        n = self.n_images
        e_words = np.full((n, kmax), -1, np.int32)
        e_sigs = np.zeros((n, kmax, 2), np.uint32)
        e_geom = np.zeros((n, kmax, 4), np.float32)
        e_valid = np.zeros((n, kmax), bool)
        for img_id, w, s, g in self._entries:
            k = len(w)
            e_words[img_id, :k] = w
            e_sigs[img_id, :k] = s
            e_geom[img_id, :k] = g
            e_valid[img_id, :k] = True
        self._e_words = jnp.asarray(e_words)
        self._e_sigs = jnp.asarray(e_sigs)
        self._e_geom = jnp.asarray(e_geom)
        self._e_valid = jnp.asarray(e_valid)

        # self-similarity DIRECTLY from each image's own entries
        # (inverted_index.h:238-288: the score an image attains querying
        # itself). Equivalent to scoring against the full index but
        # O(n * kmax^2) and independent of corpus/vocabulary size — the
        # round-2 pass re-scored every image against ALL buckets + tail,
        # collapsing to one image per dispatch at large kmax*cap.
        selfs_parts = []
        chunk = max(1, min(n, (1 << 24) // max(kmax * kmax, 1)))
        sw = jnp.where(self._e_valid, self._e_words, 0)
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            sc = _self_similarity(sw[lo:hi], self._e_sigs[lo:hi],
                                  self._e_valid[lo:hi], self._idf)
            selfs_parts.append(np.asarray(sc))
        selfs = np.concatenate(selfs_parts) if selfs_parts else \
            np.zeros(0, np.float32)
        self._self_norm = jnp.asarray(np.sqrt(np.maximum(selfs, 1e-12)))
        self._prepared = True

    # --------------------------------------------------------------- query
    def query(self, descriptors, *, topk: int = 10, valid=None,
              geometries=None, verify: int = 0, key=None,
              image_extent: float = 1024.0):
        """descriptors [Kq, D] -> (names, normalized scores).

        verify > 0 re-ranks the top-`verify` candidates by spatial
        verification (visual_index.h Query with
        num_images_after_verification): requires `geometries` [Kq, 4]
        (x, y, scale, orientation) and geometry-carrying add_image calls.
        The vote-and-verify score is added to the tf-idf score before
        the final sort (visual_index.h:481-501)."""
        if not self._prepared:
            self.prepare()
        words, sigs = self._encode(descriptors)
        kq = words.shape[0]
        if valid is None:
            valid = jnp.ones((kq,), bool)
        valid = jnp.asarray(valid)
        scores = _score_query(words, sigs, valid, self._b_img,
                              self._b_sig, self._b_burst, self._t_word,
                              self._t_img, self._t_sig, self._t_burst,
                              self._idf, self.n_images)
        q_self = jnp.sqrt(jnp.maximum(jnp.sum(
            (self._idf[words] ** 2) * valid, dtype=jnp.float32), 1e-12))
        norm = scores / (self._self_norm * q_self)

        if verify > 0:
            if geometries is None:
                raise ValueError("verify>0 requires query `geometries`")
            c = min(verify, self.n_images)
            _, cand = jax.lax.top_k(norm, c)
            q_geom = jnp.asarray(geometries, jnp.float32).reshape(kq, 4)
            vv = _verify_candidates(
                words, sigs, valid, q_geom,
                self._e_words[cand], self._e_sigs[cand],
                self._e_valid[cand], self._e_geom[cand], self._idf,
                image_extent)
            norm = norm.at[cand].add(vv)

        k = min(topk, self.n_images)
        v, i = jax.lax.top_k(norm, k)
        i = np.asarray(i)
        return [self._names[j] for j in i], np.asarray(v)

    def query_batch(self, descriptors, *, topk: int = 10, valid=None,
                    geometries=None, verify: int = 0,
                    image_extent: float = 1024.0,
                    verify_chunk: int = 8):
        """Batched multi-image query: descriptors [Q, Kq, D] (padded),
        valid [Q, Kq] -> (ids [Q, topk], scores [Q, topk], names).

        One descriptor->word assignment pass covers every query image
        (the dominant cost at large vocabularies — the reference's
        retriever, exe/vocab_tree.cc:155-181, pays it per image), and
        one compiled program scores the whole batch. verify > 0
        re-ranks each query's top-`verify` candidates spatially
        (requires `geometries` [Q, Kq, 4]), chunked over queries to
        bound the [chunk, C, Kq, Ki] match tensors.
        """
        if not self._prepared:
            self.prepare()
        x = jnp.asarray(descriptors, jnp.float32)
        q, kq, d = x.shape
        words, sigs = self._encode(x.reshape(q * kq, d))
        words = words.reshape(q, kq)
        sigs = sigs.reshape(q, kq, 2)
        if valid is None:
            valid = jnp.ones((q, kq), bool)
        valid = jnp.asarray(valid)
        # bound the vmapped tail pass at ~32M scored pairs per step
        tail_tc = max(1024, min(32768, (1 << 25) // max(q * kq, 1)))
        scores = _score_query_many(
            words, sigs, valid, self._b_img, self._b_sig, self._b_burst,
            self._t_word, self._t_img, self._t_sig, self._t_burst,
            self._idf, self.n_images, tail_tc)
        q_self = jnp.sqrt(jnp.maximum(jnp.sum(
            (self._idf[words] ** 2) * valid, axis=1,
            dtype=jnp.float32), 1e-12))
        norm = scores / (self._self_norm[None, :] * q_self[:, None])

        if verify > 0:
            if geometries is None:
                raise ValueError("verify>0 requires query `geometries`")
            c = min(verify, self.n_images)
            _, cand = jax.lax.top_k(norm, c)                   # [Q, C]
            g = jnp.asarray(geometries, jnp.float32).reshape(q, kq, 4)
            vv_fn = jax.jit(jax.vmap(
                lambda w, s, v, gg, cw, cs, cv, cg: _verify_candidates(
                    w, s, v, gg, cw, cs, cv, cg, self._idf,
                    image_extent)))
            parts = []
            for lo in range(0, q, verify_chunk):
                hi = min(lo + verify_chunk, q)
                ci = cand[lo:hi]
                parts.append(vv_fn(
                    words[lo:hi], sigs[lo:hi], valid[lo:hi], g[lo:hi],
                    self._e_words[ci], self._e_sigs[ci],
                    self._e_valid[ci], self._e_geom[ci]))
            vv = jnp.concatenate(parts, axis=0)                # [Q, C]
            norm = jax.vmap(lambda n, ci, s: n.at[ci].add(s))(
                norm, cand, vv)

        k = min(topk, self.n_images)
        v, i = jax.lax.top_k(norm, k)
        return np.asarray(i), np.asarray(v), self._names

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        if not self._prepared:
            self.prepare()
        hier = self.hierarchical and self.coarse is not None
        np.savez(path, words=np.asarray(self.words),
                 coarse=(np.asarray(self.coarse) if hier
                         else np.zeros((0, self.dim), np.float32)),
                 fine=(np.asarray(self.fine) if hier
                       else np.zeros((0, 0, self.dim), np.float32)),
                 he_proj=np.asarray(self.he_proj),
                 he_thresh=np.asarray(self.he_thresh),
                 b_img=np.asarray(self._b_img),
                 b_sig=np.asarray(self._b_sig),
                 b_burst=np.asarray(self._b_burst),
                 t_word=np.asarray(self._t_word),
                 t_img=np.asarray(self._t_img),
                 t_sig=np.asarray(self._t_sig),
                 t_burst=np.asarray(self._t_burst),
                 e_words=np.asarray(self._e_words),
                 e_sigs=np.asarray(self._e_sigs),
                 e_geom=np.asarray(self._e_geom),
                 e_valid=np.asarray(self._e_valid),
                 idf=np.asarray(self._idf),
                 self_norm=np.asarray(self._self_norm),
                 names=np.array(self._names))

    @classmethod
    def load(cls, path: str) -> "VocabHEIndex":
        z = np.load(path, allow_pickle=False)
        hier = "coarse" in z.files and z["coarse"].shape[0] > 0
        idx = cls(n_words=z["words"].shape[0], dim=z["words"].shape[1],
                  hierarchical=hier)
        idx.words = jnp.asarray(z["words"])
        if hier:
            idx.coarse = jnp.asarray(z["coarse"])
            idx.fine = jnp.asarray(z["fine"])
        idx.he_proj = jnp.asarray(z["he_proj"])
        idx.he_thresh = jnp.asarray(z["he_thresh"])
        idx._b_img = jnp.asarray(z["b_img"])
        idx._b_sig = jnp.asarray(z["b_sig"])
        idx._b_burst = jnp.asarray(z["b_burst"])
        idx._t_word = jnp.asarray(z["t_word"])
        idx._t_img = jnp.asarray(z["t_img"])
        idx._t_sig = jnp.asarray(z["t_sig"])
        idx._t_burst = jnp.asarray(z["t_burst"])
        idx._e_words = jnp.asarray(z["e_words"])
        idx._e_sigs = jnp.asarray(z["e_sigs"])
        idx._e_geom = jnp.asarray(z["e_geom"])
        idx._e_valid = jnp.asarray(z["e_valid"])
        idx._idf = jnp.asarray(z["idf"])
        idx._self_norm = jnp.asarray(z["self_norm"])
        idx._names = [str(s) for s in z["names"]]
        idx.n_overflow = int(np.sum(np.asarray(z["t_img"]) >= 0))
        idx._prepared = True
        return idx
