"""Flat ADC and IVF-ADC engines: exactness vs decoded scan + recall."""

import jax
import numpy as np
import pytest

from cvt_tpu.index import FlatADCIndex, FlatIndex, IVFADCIndex
from cvt_tpu.quant import OPQ, ProductQuantizer
from cvt_tpu.utils import recall_at_k


def _gt(base, queries, k=10):
    exact = FlatIndex(base.shape[1], "l2", chunk=4096)
    exact.add(base)
    return exact.search(queries, k)


def test_flat_adc_matches_decoded_exact(sift_like):
    base, queries = sift_like
    pq = ProductQuantizer.train(jax.random.key(0), base, m=8, k=64, iters=10)
    idx = FlatADCIndex(pq, impl="xla")
    idx.add(base)
    d, i = idx.search(queries, 10, exact=True)

    dec = np.asarray(pq.decode(pq.encode(base)))
    de, ie = _gt(dec, queries, 10)
    # ADC scan (float32 re-score of the packed scan's best segments) ==
    # exact scan over the decoded database
    np.testing.assert_allclose(np.asarray(d), np.asarray(de),
                               rtol=5e-2, atol=0.5)
    # ids may differ only between rows of identical codes (exact ties)
    codes = np.asarray(pq.encode(base))
    top1 = codes[np.asarray(i)[:, 0]] == codes[np.asarray(ie)[:, 0]]
    assert top1.all(1).mean() > 0.9


def test_flat_adc_recall_vs_float(sift_like):
    base, queries = sift_like
    _, gt = _gt(base, queries, 1)
    pq = ProductQuantizer.train(jax.random.key(0), base, m=16, k=256,
                                iters=10)
    idx = FlatADCIndex(pq, impl="xla")
    idx.add(base)
    # exact top-10 (float32 re-score): the fast path returns one row per
    # 128-row segment, and this database has only 32 segments
    _, ids = idx.search(queries, 10, exact=True)
    r10 = recall_at_k(np.asarray(ids), np.asarray(gt)[:, 0], k=10)
    assert r10 > 0.9, r10


def test_flat_adc_with_opq(sift_like):
    base, queries = sift_like
    _, gt = _gt(base, queries, 1)
    opq = OPQ.train(jax.random.key(1), base, m=8, k=64, opq_iters=3,
                    kmeans_iters=5, final_kmeans_iters=8)
    idx = FlatADCIndex(opq, chunk=1024, impl="xla")
    idx.add(base)
    _, ids = idx.search(queries, 10)
    r10 = recall_at_k(np.asarray(ids), np.asarray(gt)[:, 0], k=10)
    assert r10 > 0.7, r10


def test_flat_adc_save_load(tmp_path, sift_like):
    base, queries = sift_like
    pq = ProductQuantizer.train(jax.random.key(2), base[:1024], m=8, k=32,
                                iters=5)
    idx = FlatADCIndex(pq, chunk=1024, impl="xla")
    idx.add(base[:2048])
    p = str(tmp_path / "adc.npz")
    idx.save(p)
    idx2 = FlatADCIndex.load(p)
    idx2.impl = "xla"
    d1, i1 = idx.search(queries[:4], 5)
    d2, i2 = idx2.search(queries[:4], 5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_ivf_adc_recall_and_exactness(sift_like):
    base, queries = sift_like
    _, gt = _gt(base, queries, 1)
    idx = IVFADCIndex(coarse_k=64, m=8, k=64)
    idx.train(jax.random.key(0), base[:2048], coarse_iters=6, pq_iters=6)
    idx.build(base)
    assert idx.ntotal == base.shape[0]
    # full probe = scan everything -> should match flat ADC recall closely
    _, ids_full = idx.search(queries, 10, nprobe=64)
    r_full = recall_at_k(np.asarray(ids_full), np.asarray(gt)[:, 0], k=10)
    assert r_full > 0.8, r_full
    # partial probe loses little on clustered data
    _, ids_8 = idx.search(queries, 10, nprobe=8)
    r8 = recall_at_k(np.asarray(ids_8), np.asarray(gt)[:, 0], k=10)
    assert r8 > 0.55, r8
    # no duplicate ids per query among valid entries
    ids = np.asarray(ids_8)
    for row in ids:
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v)


def test_ivf_adc_bucket_overflow_tail(sift_like):
    base, _ = sift_like
    # tiny capacity forces most points into the tail; results must still be
    # complete at full probe
    idx = IVFADCIndex(coarse_k=16, m=8, k=32, bucket_cap=8)
    idx.train(jax.random.key(1), base[:2048], coarse_iters=5, pq_iters=5)
    idx.build(base[:2048])
    q = base[:8]
    _, ids = idx.search(q, 5, nprobe=16)
    # querying with database points: self should be in top-5 nearly always
    hits = (np.asarray(ids) == np.arange(8)[:, None]).any(axis=1).mean()
    assert hits > 0.8, hits


def test_ivf_adc_save_load(tmp_path, sift_like):
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=32, m=8, k=32)
    idx.train(jax.random.key(2), base[:2048], coarse_iters=5, pq_iters=5)
    idx.build(base[:2048])
    p = str(tmp_path / "ivf.npz")
    idx.save(p)
    idx2 = IVFADCIndex.load(p)
    d1, i1 = idx.search(queries[:4], 5, nprobe=8)
    d2, i2 = idx2.search(queries[:4], 5, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_ivf_threshold_query(sift_like):
    """QueryThrehold analogue: radius results match a full search filter."""
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=32, m=8, k=32)
    key = jax.random.key(0)
    idx.train(key, base, coarse_iters=8, pq_iters=8)
    idx.build(base)
    q = queries[:8]
    d_all, i_all = idx.search(q, 32, nprobe=32)
    radius = float(np.median(np.asarray(d_all)[:, 5]))
    d, i, valid, count = idx.search_threshold(q, radius, nprobe=32,
                                              max_results=64)
    d, i, valid, count = map(np.asarray, (d, i, valid, count))
    for b in range(8):
        want = set(np.asarray(i_all)[b][np.asarray(d_all)[b] <= radius])
        got = set(i[b][valid[b]])
        # all within-radius hits from the ordinary search are reported
        assert want <= got, (b, want - got)
        assert count[b] >= len(want)
        # dists are <= radius and sorted ascending
        dv = d[b][valid[b]]
        assert (dv <= radius + 1e-5).all()
        assert (np.diff(dv) >= -1e-5).all()


def test_ivf_grouped_query(sift_like):
    """Per-group (video) min-aggregation: grouped top-k == min-reduce of
    the flat per-vector distances (IVFOPQ.cpp:300-309 semantics)."""
    base, queries = sift_like
    n = base.shape[0]
    n_groups = 50
    rng = np.random.default_rng(1)
    groups = rng.integers(0, n_groups, size=n).astype(np.int32)
    idx = IVFADCIndex(coarse_k=16, m=8, k=32)
    idx.train(jax.random.key(0), base, coarse_iters=8, pq_iters=8)
    idx.build(base, group_ids=groups)
    q = queries[:4]
    # reference: exhaustive probe (= exact ADC), reduce per group on host
    d_all, i_all = idx.search(q, 256, nprobe=16)
    gd, gi, mi = idx.search_grouped(q, 5, nprobe=16)
    gd, gi, mi = map(np.asarray, (gd, gi, mi))
    d_all, i_all = np.asarray(d_all), np.asarray(i_all)
    for b in range(4):
        per_group = {}
        for dist, vid in zip(d_all[b], i_all[b]):
            if vid < 0:
                continue
            g = int(groups[vid])
            if dist < per_group.get(g, (np.inf, -1))[0]:
                per_group[g] = (dist, int(vid))
        ranked = sorted(per_group.items(), key=lambda kv: kv[1][0])[:5]
        # Tie-tolerant ranking check: groups whose min distances are
        # byte-identical (code-identical PQ cells in different groups)
        # may legally order either way between the host sort and the
        # device top_k — so assert the sorted SCORE lists match exactly,
        # and that each returned group's score equals that group's true
        # min (not merely some score in the list).
        want_dists = [dist for _, (dist, _) in ranked]
        np.testing.assert_allclose(np.sort(gd[b]), np.sort(want_dists),
                                   rtol=1e-4, atol=1e-3)
        for slot in range(5):
            g = int(gi[b, slot])
            assert g in per_group, (b, slot, g)
            np.testing.assert_allclose(gd[b, slot], per_group[g][0],
                                       rtol=1e-4, atol=1e-3)
            # member id points at a vector in the winning group whose
            # distance achieves the group min
            assert groups[mi[b, slot]] == g


def test_ivf_probe_chunking_equivalent(sift_like):
    """probe_chunk bounds memory without changing results (the reference
    operating-point path: coarseK=8192 nprobe large)."""
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=32, m=8, k=32)
    idx.train(jax.random.key(0), base, coarse_iters=6, pq_iters=6)
    idx.build(base)
    q = queries[:4]
    d1, i1 = idx.search(q, 10, nprobe=16)
    d2, i2 = idx.search(q, 10, nprobe=16, probe_chunk=4)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_ivf_search_fast_union_probe(sift_like, impl):
    """Union-probe packed scan (search_fast: plain XLA twin under 'auto'
    on the CPU, the paged kernel interpreted under 'pallas') vs the XLA
    probed engine:
    same nprobe semantics, near-identical distance profiles (phase-2
    rescores in f32 from the int16 cache), equivalent recall."""
    base, queries = sift_like
    _, gt = _gt(base, queries, 1)
    idx = IVFADCIndex(coarse_k=64, m=8, k=64)
    idx.train(jax.random.key(0), base[:2048], coarse_iters=6, pq_iters=6)
    idx.build(base)
    d_ref, i_ref = idx.search(queries, 10, nprobe=8)
    d_f, i_f, dropped = idx.search_fast(queries, 10, nprobe=8, impl=impl)
    assert int(dropped) == 0
    d_ref, d_f = np.asarray(d_ref), np.asarray(d_f)
    rel = np.abs(d_f - d_ref) / np.maximum(d_ref, 1.0)
    assert rel.max() < 0.03, rel.max()
    r_ref = recall_at_k(np.asarray(i_ref), np.asarray(gt)[:, 0], k=10)
    r_f = recall_at_k(np.asarray(i_f), np.asarray(gt)[:, 0], k=10)
    assert abs(r_ref - r_f) <= 0.05, (r_ref, r_f)
    # no duplicate ids per query
    for row in np.asarray(i_f):
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v)
    # batch-union mode scans a superset of every query's lists
    _, i_u, _ = idx.search_fast(queries, 10, nprobe=8, exact_probe=False,
                                impl=impl)
    r_u = recall_at_k(np.asarray(i_u), np.asarray(gt)[:, 0], k=10)
    assert r_u >= r_f - 0.02, (r_u, r_f)


def test_ivf_search_fast_save_load(tmp_path, sift_like):
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=32, m=8, k=32)
    idx.train(jax.random.key(2), base[:2048], coarse_iters=5, pq_iters=5)
    idx.build(base[:2048])
    p = str(tmp_path / "ivf.npz")
    idx.save(p)
    idx2 = IVFADCIndex.load(p)
    d1, i1, _ = idx.search_fast(queries[:8], 5, nprobe=8)
    d2, i2, _ = idx2.search_fast(queries[:8], 5, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_ivf_tail_respects_nprobe(sift_like):
    """Entries that overflow their bucket into the tail are returned only
    for queries that probe their cell, like bucketed entries."""
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=32, m=8, k=32, bucket_cap=16)
    idx.train(jax.random.key(3), base[:2048], coarse_iters=5, pq_iters=5)
    idx.build(base)                       # most rows spill into the tail
    assert int((np.asarray(idx._tail_ids) >= 0).sum()) > base.shape[0] // 2
    q = queries[:16]
    _, ids = idx.search(q, 10, nprobe=2)
    ids = np.asarray(ids)
    assign = np.asarray(idx.encode_chunk(base)[0])
    c = np.asarray(idx.centroids)
    probes = np.argsort(((q[:, None, :] - c[None]) ** 2).sum(-1), 1)[:, :2]
    for row, p in zip(ids, probes):
        row = row[row >= 0]
        assert len(row) and np.isin(assign[row], p).all()
    _, ids_fast, _ = idx.search_fast(q, 10, nprobe=2)
    for a, b in zip(ids, np.asarray(ids_fast)):
        assert len(set(a[a >= 0]) ^ set(b[b >= 0])) <= 2
