"""IVF-ADC: coarse inverted lists + residual PQ codes, probed ADC search.

Reference: opq/src/IVFOPQ.cpp — coarse k-means assignment (:113-129),
residual PQ encode (:141-163), nearest-nprobe selection (:237-260),
per-probe LUT build (:279-291) and inverted-list LUT-sum scan (:300-309).
Operating point there: d=128, coarseK=8192, m=16, k=256 (IVFOPQ.cpp:56-63).

Inverted lists are PADDED DENSE BUCKETS [Kc, L, M] u8 so a probe is a
static-shape gather, not pointer chasing.

    dist(q, n) = ||q - c_a(n) - d(code_n)||^2
               = sum_m LUT_r[b, p, m, code_n[m]]       (residual LUT)

with LUT_r built for r = q - centroid_p as one batched einsum over all
(query, probe) pairs at once. Lists longer than the bucket capacity spill
into a flat TAIL scanned for every query (entries of cells the query
did not probe masked out) with the exact algebraic
expansion  ||q||^2 + ||c_a + d||^2 - 2<q, c_a> - 2<q, d(code)>  — the
coarse inner products <q, c> are reused from probe selection, and
<q, d(code)> is the same decode-first scan as FlatADCIndex. Results
from buckets and tail merge in one top-k.

Design note: BASELINE.json replaces IVF probing with the flat scan for
the north-star benchmark (list probing wastes the matrix units at high
recall); this index exists for capability parity with the reference and
for the large-N / low-latency regime where scanning 1/64 of the database
wins.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops import backend
from cvt_tpu.ops.kmeans import kmeans
from cvt_tpu.ops.pallas.ivf_scan import build_page_layout, ivf_union_search
from cvt_tpu.ops.topk import merge_topk
from cvt_tpu.quant.pq import ProductQuantizer


def _probed_scores(q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
                   nprobe, probe_chunk=None):
    """Shared probe + residual-LUT + bucket-scoring stage.

    Returns (flat_scores [B, P*L], flat_ids [B, P*L], coarse_ip [B, Kc],
    q_sq [B], probes [B, P]). probe_chunk bounds the [B, Pc, L, M]
    gather working set for the reference operating point (coarseK=8192,
    m=16 — IVFOPQ.cpp:56-63) by looping probe chunks instead of
    materializing all P.
    """
    b, d = q.shape
    m, kk, ds = codebooks.shape
    L = buckets.shape[1]

    # ---- probe selection: full coarse IP scan (one matmul) --------------
    coarse_ip = jnp.matmul(q, centroids.T,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)    # [B, Kc]
    q_sq = jnp.sum(jnp.square(q), axis=-1)                        # [B]
    c_sq = jnp.sum(jnp.square(centroids), axis=-1)                # [Kc]
    coarse_dist = q_sq[:, None] - 2.0 * coarse_ip + c_sq[None, :]
    _, probes = jax.lax.top_k(-coarse_dist, nprobe)               # [B, P]

    pc = probe_chunk or nprobe
    pc = min(pc, nprobe)
    parts_s, parts_i = [], []
    for s in range(0, nprobe, pc):
        pr = probes[:, s:s + pc]                                  # [B, Pc]
        npc = pr.shape[1]
        # residual LUTs for this probe chunk
        probe_cent = centroids[pr]                                # [B,Pc,D]
        r = q[:, None, :] - probe_cent
        r_sub = r.reshape(b, npc, m, ds)
        ip_lut = jnp.einsum("bpms,mks->bpmk", r_sub, codebooks,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        r_sq_sub = jnp.sum(jnp.square(r_sub), axis=-1)            # [B,Pc,M]
        lut = (r_sq_sub[..., None] - 2.0 * ip_lut
               + cw_sqnorm[None, None, :, :])                     # [B,Pc,M,K]
        pcodes = buckets[pr].astype(jnp.int32)                    # [B,Pc,L,M]
        pids = bucket_ids[pr]                                     # [B,Pc,L]
        # scores[b,p,l] = sum_m lut[b,p,m,pcodes[b,p,l,m]]
        g = jnp.take_along_axis(
            lut, pcodes.transpose(0, 1, 3, 2), axis=3)            # [B,Pc,M,L]
        scores = jnp.sum(g, axis=2)                               # [B,Pc,L]
        scores = jnp.where(pids >= 0, scores, jnp.inf)
        parts_s.append(scores.reshape(b, npc * L))
        parts_i.append(pids.reshape(b, npc * L))
    flat_scores = jnp.concatenate(parts_s, axis=1) if len(parts_s) > 1 \
        else parts_s[0]
    flat_ids = jnp.concatenate(parts_i, axis=1) if len(parts_i) > 1 \
        else parts_i[0]
    return flat_scores, flat_ids, coarse_ip, q_sq, probes


@partial(jax.jit, static_argnames=("nprobe", "k", "probe_chunk"))
def _ivf_query(q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
               bucket_dsq, tail_codes, tail_coarse, tail_dsq, tail_ids,
               nprobe, k, probe_chunk=None):
    """Batched IVF-ADC query.

    q [B, D]; centroids [Kc, D]; cw_sqnorm [M, K]; codebooks [M, K, ds];
    buckets [Kc, L, M] u8; bucket_ids [Kc, L] i32 (-1 = pad);
    bucket_dsq [Kc, L] f32 (= ||c_a + d(code)||^2 per entry);
    tail_* : overflow entries ([T, M] u8, [T] i32 coarse id, [T] f32, [T] i32).
    """
    b, d = q.shape
    m, kk, ds = codebooks.shape
    L = buckets.shape[1]
    flat_scores, flat_ids, coarse_ip, q_sq, probes = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
        nprobe, probe_chunk)
    kb = min(k, nprobe * L)
    best_d, j = jax.lax.top_k(-flat_scores, kb)
    best_d = -best_d
    best_i = jnp.take_along_axis(flat_ids, j, axis=-1)

    # ---- tail: flat decode-first scan with coarse-IP correction ---------
    t = tail_codes.shape[0]
    if t > 0:
        tdist = _tail_dists(q, q_sq, coarse_ip, probes, codebooks,
                            tail_codes, tail_coarse, tail_dsq, tail_ids)
        kt = min(k, t)
        td, tj = jax.lax.top_k(-tdist, kt)
        ti = jnp.take_along_axis(
            jnp.broadcast_to(tail_ids[None, :], (b, t)), tj, axis=-1)
        cat_d = jnp.concatenate([best_d, -td], axis=-1)
        cat_i = jnp.concatenate([best_i, ti], axis=-1)
        best_d, best_i = merge_topk(cat_d, cat_i, min(k, kb + kt))
    return best_d, best_i


def _tail_dists(q, q_sq, coarse_ip, probes, codebooks, tail_codes,
                tail_coarse, tail_dsq, tail_ids):
    """Overflow-tail distances [B, T] (decode-first scan with the
    coarse inner products reused from probe selection). inf on padding
    and on entries of cells the query did not probe, so the tail keeps
    nprobe semantics. float32 throughout, like the bucket LUTs: the tail
    and the buckets compete in one top-k."""
    b, d = q.shape
    m = codebooks.shape[0]
    t = tail_codes.shape[0]
    dec = codebooks[jnp.arange(m)[None, :],
                    tail_codes.astype(jnp.int32)].reshape(t, d)   # [T, D]
    ip_d = jnp.matmul(q, dec.T, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)         # [B, T]
    cip = jnp.take_along_axis(
        coarse_ip, jnp.broadcast_to(tail_coarse[None, :], (b, t)),
        axis=1)                                                   # [B, T]
    tdist = q_sq[:, None] + tail_dsq[None, :] - 2.0 * cip - 2.0 * ip_d
    rows = jnp.arange(b)[:, None]
    probed = jnp.zeros(coarse_ip.shape, bool).at[rows, probes].set(True)
    hit = jnp.take_along_axis(
        probed, jnp.broadcast_to(tail_coarse[None, :], (b, t)), axis=1)
    return jnp.where((tail_ids[None, :] >= 0) & hit, tdist, jnp.inf)


@partial(jax.jit, static_argnames=("nprobe", "max_results", "probe_chunk"))
def _ivf_query_threshold(q, centroids, cw_sqnorm, codebooks, buckets,
                         bucket_ids, tail_codes, tail_coarse, tail_dsq,
                         tail_ids, radius, nprobe, max_results,
                         probe_chunk=None):
    """Radius query — the QueryThrehold analogue (IVFOPQ.cpp:213-320):
    every probed entry with dist <= radius, reported as up to max_results
    (nearest-first) plus the TRUE total count under the radius.

    Returns (dists [B, R], ids [B, R], valid [B, R] bool, count [B] i32).
    """
    flat_scores, flat_ids, coarse_ip, q_sq, probes = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
        nprobe, probe_chunk)
    t = tail_codes.shape[0]
    if t > 0:
        tdist = _tail_dists(q, q_sq, coarse_ip, probes, codebooks,
                            tail_codes, tail_coarse, tail_dsq, tail_ids)
        flat_scores = jnp.concatenate([flat_scores, tdist], axis=1)
        flat_ids = jnp.concatenate(
            [flat_ids, jnp.broadcast_to(tail_ids[None, :],
                                        tdist.shape)], axis=1)
    r = min(max_results, flat_scores.shape[1])
    neg, j = jax.lax.top_k(-flat_scores, r)
    dists = -neg
    ids = jnp.take_along_axis(flat_ids, j, axis=-1)
    valid = (dists <= radius) & (ids >= 0)
    count = jnp.sum((flat_scores <= radius) & (flat_ids >= 0),
                    axis=-1).astype(jnp.int32)
    return dists, ids, valid, count


@partial(jax.jit, static_argnames=("nprobe", "k", "n_groups", "probe_chunk"))
def _ivf_query_grouped(q, centroids, cw_sqnorm, codebooks, buckets,
                       bucket_ids, tail_codes, tail_coarse, tail_dsq,
                       tail_ids, vec_groups, nprobe, k, n_groups,
                       probe_chunk=None):
    """Per-group min-aggregated query — the per-video min-reduce the
    reference fuses into its inverted-list scan (IVFOPQ.cpp:300-309,
    IVFelem.videoId). Scores every probed entry, min-reduces into its
    group (video), and returns the top-k groups.

    vec_groups [N] i32 maps vector id -> group id in [0, n_groups).
    Returns (group_dists [B, kg], group_ids [B, kg], member_ids [B, kg])
    where member_ids is the arg-min vector inside each winning group.
    """
    b = q.shape[0]
    flat_scores, flat_ids, coarse_ip, q_sq, probes = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
        nprobe, probe_chunk)
    t = tail_codes.shape[0]
    if t > 0:
        tdist = _tail_dists(q, q_sq, coarse_ip, probes, codebooks,
                            tail_codes, tail_coarse, tail_dsq, tail_ids)
        flat_scores = jnp.concatenate([flat_scores, tdist], axis=1)
        flat_ids = jnp.concatenate(
            [flat_ids, jnp.broadcast_to(tail_ids[None, :],
                                        tdist.shape)], axis=1)
    # group id per candidate (pad/invalid -> sentinel group n_groups)
    safe_ids = jnp.clip(flat_ids, 0, vec_groups.shape[0] - 1)
    gid = jnp.where(flat_ids >= 0, vec_groups[safe_ids], n_groups)
    rows = jax.lax.broadcasted_iota(jnp.int32, gid.shape, 0)
    per_group = jnp.full((b, n_groups + 1), jnp.inf, jnp.float32)
    per_group = per_group.at[rows, gid].min(flat_scores)
    pg = per_group[:, :n_groups]                                  # [B, G]
    kg = min(k, n_groups)
    neg, gsel = jax.lax.top_k(-pg, kg)
    gdist = -neg
    # arg-min member per group: scatter-min the candidate id among
    # entries matching their group's min score
    gmin_per_cand = jnp.take_along_axis(per_group, gid, axis=1)
    is_min = flat_scores <= gmin_per_cand
    cand = jnp.where(is_min & (flat_ids >= 0), flat_ids, jnp.iinfo(jnp.int32).max)
    member = jnp.full((b, n_groups + 1), jnp.iinfo(jnp.int32).max,
                      jnp.int32)
    member = member.at[rows, gid].min(cand)
    member_sel = jnp.take_along_axis(member[:, :n_groups], gsel, axis=1)
    member_sel = jnp.where(jnp.isfinite(gdist), member_sel, -1)
    return gdist, gsel, member_sel


class IVFADCIndex:
    """Inverted-file index with residual PQ codes and batched ADC probes."""

    def __init__(self, coarse_k: int = 1024, m: int = 8, k: int = 256,
                 bucket_cap: int | None = None):
        self.coarse_k = coarse_k
        self.m = m
        self.k = k
        self.bucket_cap = bucket_cap
        self.centroids: jax.Array | None = None      # [Kc, D]
        self.pq: ProductQuantizer | None = None
        self._built = False

    # ---------------------------------------------------------------- train
    def train(self, key, x, *, coarse_iters: int = 20, pq_iters: int = 25,
              sample: int | None = 262144) -> None:
        """Coarse k-means + residual PQ, mirroring TrainPQ::{CoarseQuan,
        ProdQuan} (train_PQ_codebook.cpp:150-244)."""
        x = jnp.asarray(x, jnp.float32)
        if sample is not None and x.shape[0] > sample:
            idx = jax.random.permutation(key, x.shape[0])[:sample]
            x = x[idx]
        res = kmeans(key, x, self.coarse_k, iters=coarse_iters)
        self.centroids = res.centroids
        residuals = x - self.centroids[res.assignments]
        self.pq = ProductQuantizer.train(key, residuals, self.m, self.k,
                                         iters=pq_iters)

    # ---------------------------------------------------------------- build
    def build(self, x, group_ids=None) -> None:
        """Assign, encode residuals, and lay out padded buckets (host-side
        layout; math on device).

        group_ids: optional [N] int array mapping each vector to a group
        (the reference's IVFelem.videoId, IVFOPQ.h:24-29) — enables
        search_grouped()."""
        if self.centroids is None:
            raise RuntimeError("train() first")
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        a_parts, c_parts, d_parts = [], [], []
        for s in range(0, n, 131_072):
            a_c, codes_c, dsq_c = self.encode_chunk(x[s:s + 131_072])
            a_parts.append(np.asarray(a_c))
            c_parts.append(np.asarray(codes_c))
            d_parts.append(np.asarray(dsq_c))
        self.build_from_codes(np.concatenate(a_parts),
                              np.concatenate(c_parts),
                              np.concatenate(d_parts),
                              group_ids=group_ids)

    def encode_chunk(self, xc):
        """(assign, residual codes, reconstruction sqnorm) for one chunk
        — device math, chunked because the one-hot PQ decode
        materializes [M, chunk, K] (8 GB at the reference operating
        point m=16, k=256 for a whole-1M dispatch)."""
        from cvt_tpu.ops.kmeans import kmeans_assign
        xc = jnp.asarray(xc, jnp.float32)
        a_c, _ = kmeans_assign(xc, self.centroids, chunk=xc.shape[0])
        residuals = xc - self.centroids[a_c]
        codes_c = self.pq.encode(residuals)
        rec = self.pq.decode(codes_c) + self.centroids[a_c]
        return a_c, codes_c, jnp.sum(jnp.square(rec), axis=-1)

    def build_from_codes(self, assign_np, codes_np, dsq_np,
                         group_ids=None) -> None:
        """Lay out buckets/tail/pages from precomputed per-vector
        (coarse assignment, residual codes, reconstruction sqnorms) —
        lets large-N callers encode device-side in chunks and never
        materialize the float database on the host."""
        assign_np = np.asarray(assign_np)
        codes_np = np.asarray(codes_np, np.uint8)
        dsq_np = np.asarray(dsq_np, np.float32)
        n = assign_np.shape[0]
        counts = np.bincount(assign_np, minlength=self.coarse_k)
        cap = self.bucket_cap
        if cap is None:
            cap = int(min(counts.max(),
                          max(8, 4 * max(1, n // self.coarse_k))))
            cap = -(-cap // 8) * 8
        order = np.argsort(assign_np, kind="stable")
        sorted_assign = assign_np[order]
        # Rank of each point within its list.
        starts = np.zeros(self.coarse_k + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(n, dtype=np.int64) - starts[sorted_assign]

        in_bucket = rank < cap
        buckets = np.zeros((self.coarse_k, cap, self.m), np.uint8)
        bucket_ids = np.full((self.coarse_k, cap), -1, np.int32)
        bucket_dsq = np.zeros((self.coarse_k, cap), np.float32)
        bi = sorted_assign[in_bucket]
        br = rank[in_bucket].astype(np.int64)
        src = order[in_bucket]
        buckets[bi, br] = codes_np[src]
        bucket_ids[bi, br] = src.astype(np.int32)
        bucket_dsq[bi, br] = dsq_np[src]

        # union-probe page layout for search_fast (ops/pallas/ivf_scan.py):
        # cell-sorted segment-pure decoded int8 cache
        pg = build_page_layout(codes_np, assign_np, dsq_np,
                               self.pq.codebooks)
        self._pg_dec8 = jnp.asarray(pg["dec8"])
        self._pg_dec16 = jnp.asarray(pg["dec16"])
        self._pg_srow16 = jnp.asarray(pg["srow16"])
        self._pg_nrm = jnp.asarray(pg["nrm_col"])
        self._pg_seg_cell = jnp.asarray(pg["seg_cell"])
        self._pg_rowids = jnp.asarray(pg["rowids"])
        self._pg_srow = jnp.asarray(pg["srow"])
        self._pg_dsq_min = pg["dsq_min"]
        self._pg_lp, self._pg_seg = pg["lp"], pg["seg"]

        tail_src = order[~in_bucket]
        self._buckets = jnp.asarray(buckets)
        self._bucket_ids = jnp.asarray(bucket_ids)
        self._bucket_dsq = jnp.asarray(bucket_dsq)
        # Pad tail to a multiple of 128 for clean tiling.
        tlen = len(tail_src)
        tpad = (-(-max(tlen, 1) // 128) * 128) if tlen else 0
        tail_codes = np.zeros((tpad, self.m), np.uint8)
        tail_coarse = np.zeros((tpad,), np.int32)
        tail_dsq = np.zeros((tpad,), np.float32)
        tail_ids = np.full((tpad,), -1, np.int32)
        if tlen:
            tail_codes[:tlen] = codes_np[tail_src]
            tail_coarse[:tlen] = assign_np[tail_src]
            tail_dsq[:tlen] = dsq_np[tail_src]
            tail_ids[:tlen] = tail_src.astype(np.int32)
        self._tail_codes = jnp.asarray(tail_codes)
        self._tail_coarse = jnp.asarray(tail_coarse)
        self._tail_dsq = jnp.asarray(tail_dsq)
        self._tail_ids = jnp.asarray(tail_ids)
        if group_ids is not None:
            g = np.asarray(group_ids, np.int32)
            assert g.shape == (n,)
            self._vec_groups = jnp.asarray(g)
            self.n_groups = int(g.max()) + 1 if n else 0
        else:
            self._vec_groups = None
            self.n_groups = 0
        self._ntotal = n
        self._built = True

    @property
    def ntotal(self) -> int:
        return getattr(self, "_ntotal", 0)

    # --------------------------------------------------------------- search
    def search(self, q, k: int, *, nprobe: int = 16,
               probe_chunk: int | None = None):
        if not self._built:
            raise RuntimeError("build() first")
        q = jnp.asarray(q, jnp.float32)
        return _ivf_query(
            q, self.centroids, self.pq.codeword_sqnorms(),
            self.pq.codebooks, self._buckets, self._bucket_ids,
            self._bucket_dsq, self._tail_codes, self._tail_coarse,
            self._tail_dsq, self._tail_ids,
            min(nprobe, self.coarse_k), k, probe_chunk)

    def search_fast(self, q, k: int, *, nprobe: int = 16,
                    max_pages: int | None = None,
                    exact_probe: bool = True, impl: str = "auto"):
        """Union-probe packed scan (the production query path): same
        nprobe semantics as search() but scored decode-free — see
        ops/pallas/ivf_scan.py. impl goes to cvt_tpu.ops.backend
        .scan_route. Returns (dists [B, k], ids [B, k], n_dropped_pages)."""
        if not self._built:
            raise RuntimeError("build() first")
        if not hasattr(self, "_pg_dec8"):
            raise RuntimeError("no page layout (index saved by an older "
                               "version) — rebuild with build()")
        route = backend.scan_route(impl=impl)
        q = jnp.asarray(q, jnp.float32)
        b = q.shape[0]
        nprobe = min(nprobe, self.coarse_k)
        n_pages = self._pg_dec8.shape[0] // self._pg_lp
        if max_pages is None:
            # union bound: every (query, probe) pair could own up to two
            # distinct pages (a cell list straddling a page boundary)
            max_pages = min(n_pages, 2 * b * nprobe)
        max_pages = max(8, min(max_pages, n_pages))
        return ivf_union_search(
            q, self.centroids, self._pg_dec8, self._pg_dec16,
            self._pg_srow16, self._pg_nrm, self._pg_seg_cell,
            self._pg_rowids, self._pg_srow, self._pg_dsq_min, nprobe,
            k, max_pages, lp=self._pg_lp,
            seg=self._pg_seg, exact_probe=exact_probe, route=route)

    def search_threshold(self, q, radius: float, *, nprobe: int = 16,
                         max_results: int = 128,
                         probe_chunk: int | None = None):
        """All probed neighbors within `radius` (squared L2) — the
        QueryThrehold analogue (opq/src/IVFOPQ.cpp:213-320). Returns
        (dists [B, R], ids [B, R], valid [B, R], count [B])."""
        if not self._built:
            raise RuntimeError("build() first")
        q = jnp.asarray(q, jnp.float32)
        return _ivf_query_threshold(
            q, self.centroids, self.pq.codeword_sqnorms(),
            self.pq.codebooks, self._buckets, self._bucket_ids,
            self._tail_codes, self._tail_coarse, self._tail_dsq,
            self._tail_ids, jnp.float32(radius),
            min(nprobe, self.coarse_k), max_results, probe_chunk)

    def search_grouped(self, q, k: int, *, nprobe: int = 16,
                       probe_chunk: int | None = None):
        """Top-k GROUPS by min member distance — the reference's
        per-video min-aggregation (IVFOPQ.cpp:300-309). Requires
        build(x, group_ids=...). Returns (group_dists [B, kg],
        group_ids [B, kg], member_ids [B, kg])."""
        if not self._built:
            raise RuntimeError("build() first")
        if self._vec_groups is None:
            raise RuntimeError("build(x, group_ids=...) first")
        q = jnp.asarray(q, jnp.float32)
        return _ivf_query_grouped(
            q, self.centroids, self.pq.codeword_sqnorms(),
            self.pq.codebooks, self._buckets, self._bucket_ids,
            self._tail_codes, self._tail_coarse, self._tail_dsq,
            self._tail_ids, self._vec_groups,
            min(nprobe, self.coarse_k), k, self.n_groups, probe_chunk)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        if not hasattr(self, "_pg_dec8"):
            raise RuntimeError(
                "this index was loaded from a pre-page-layout file and "
                "cannot be re-saved losslessly — rebuild with build()")
        np.savez(path,
                 centroids=np.asarray(self.centroids),
                 codebooks=np.asarray(self.pq.codebooks),
                 buckets=np.asarray(self._buckets),
                 bucket_ids=np.asarray(self._bucket_ids),
                 bucket_dsq=np.asarray(self._bucket_dsq),
                 tail_codes=np.asarray(self._tail_codes),
                 tail_coarse=np.asarray(self._tail_coarse),
                 tail_dsq=np.asarray(self._tail_dsq),
                 tail_ids=np.asarray(self._tail_ids),
                 vec_groups=(np.asarray(self._vec_groups)
                             if self._vec_groups is not None
                             else np.zeros(0, np.int32)),
                 pg_dec8=np.asarray(self._pg_dec8),
                 pg_dec16=np.asarray(self._pg_dec16),
                 pg_srow16=np.asarray(self._pg_srow16),
                 pg_nrm=np.asarray(self._pg_nrm),
                 pg_seg_cell=np.asarray(self._pg_seg_cell),
                 pg_rowids=np.asarray(self._pg_rowids),
                 pg_srow=np.asarray(self._pg_srow),
                 pg_meta=np.asarray([self._pg_dsq_min,
                                     self._pg_lp, self._pg_seg],
                                    np.float64),
                 ntotal=self._ntotal)

    @classmethod
    def load(cls, path: str) -> "IVFADCIndex":
        z = np.load(path, allow_pickle=False)
        cb = jnp.asarray(z["codebooks"])
        idx = cls(coarse_k=z["centroids"].shape[0], m=cb.shape[0],
                  k=cb.shape[1])
        idx.centroids = jnp.asarray(z["centroids"])
        idx.pq = ProductQuantizer(cb)
        idx._buckets = jnp.asarray(z["buckets"])
        idx._bucket_ids = jnp.asarray(z["bucket_ids"])
        idx._bucket_dsq = jnp.asarray(z["bucket_dsq"])
        idx._tail_codes = jnp.asarray(z["tail_codes"])
        idx._tail_coarse = jnp.asarray(z["tail_coarse"])
        idx._tail_dsq = jnp.asarray(z["tail_dsq"])
        idx._tail_ids = jnp.asarray(z["tail_ids"])
        vg = z["vec_groups"] if "vec_groups" in z.files else np.zeros(
            0, np.int32)
        idx._vec_groups = jnp.asarray(vg) if vg.size else None
        idx.n_groups = int(vg.max()) + 1 if vg.size else 0
        if "pg_dec8" in z.files:       # row-major page layout
            idx._pg_dec8 = jnp.asarray(z["pg_dec8"])
            idx._pg_dec16 = jnp.asarray(z["pg_dec16"])
            idx._pg_srow16 = jnp.asarray(z["pg_srow16"])
            idx._pg_nrm = jnp.asarray(z["pg_nrm"])
            idx._pg_seg_cell = jnp.asarray(z["pg_seg_cell"])
            idx._pg_rowids = jnp.asarray(z["pg_rowids"])
            idx._pg_srow = jnp.asarray(z["pg_srow"])
            meta = np.asarray(z["pg_meta"])
            idx._pg_dsq_min = float(meta[0])
            idx._pg_lp, idx._pg_seg = int(meta[1]), int(meta[2])
        idx._ntotal = int(z["ntotal"])
        idx._built = True
        return idx
