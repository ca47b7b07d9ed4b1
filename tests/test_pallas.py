"""Packed segment scan (cvt_tpu.ops.pallas.adc_scan): the Pallas kernel in
interpret mode against its plain XLA twin (bit-identical keys) and the
whole search against the bf16 decode engine and float32 ADC ground truth
(the reference's interpreter-vs-fast pattern, SURVEY.md §4). The kernel's
GPU route is checked here by lowering it for CUDA; the `gpu` tests run it
compiled on a card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu.index import FlatADCIndex, FlatIndex
from cvt_tpu.index.flat_adc import _adc_scan
from cvt_tpu.ops.pallas import adc_scan as A
from cvt_tpu.quant import ProductQuantizer


@pytest.fixture(scope="module")
def small_pq(sift_like):
    base, queries = sift_like
    pq = ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=64,
                                iters=8)
    return pq, base, queries


def _prep(pq, base, row_align=1024):
    """(dec, norm, srow, codes, dsq) for the scan over pq.encode(base)."""
    codes = pq.encode(base)
    n = codes.shape[0]
    npad = -(-n // row_align) * row_align
    padded = jnp.pad(codes, ((0, npad - n), (0, 0)))
    cb_q, srow = A.quantize_codebooks(pq.codebooks)
    cb_q, srow = jnp.asarray(cb_q), jnp.asarray(srow)
    dec = A.decode_int8(padded, cb_q, A.padded_dim(pq.dim))
    norm = A.int8_row_norms(padded, cb_q, srow)
    cbn = pq.codeword_sqnorms()
    dsq = jnp.sum(jax.vmap(lambda t, c: t[c], in_axes=(0, 1))(
        cbn, codes.astype(jnp.int32)), axis=0)
    return dec, norm, srow, codes, dsq


def _search(pq, prep, q, k, n, *, exact=False, route="interpret"):
    dec, norm, srow, codes, dsq = prep
    return A.adc_search(jnp.asarray(q, jnp.float32), dec, norm, srow, k, n,
                        route=route, exact=exact, codes=codes, dec_sq=dsq,
                        codebooks=pq.codebooks)


def _bf16_engine(pq, codes, q, k):
    """The bf16 decode engine (flat_adc._adc_scan, exact top-k over its
    bf16 decode): an independent reference for the packed scan."""
    q = jnp.asarray(q, jnp.float32)
    dsq = jnp.sum(jax.vmap(lambda t, c: t[c], in_axes=(0, 1))(
        pq.codeword_sqnorms(), codes.astype(jnp.int32)), axis=0)
    return _adc_scan(q, jnp.sum(jnp.square(q), axis=-1), codes, dsq,
                     pq.codebooks, k, 1024, codes.shape[0])


def test_fast_path_matches_xla_engine(small_pq):
    pq, base, queries = small_pq
    n = base.shape[0]
    d_pl, i_pl = _search(pq, _prep(pq, base), queries[:32], 10, n)

    d_x, i_x = _bf16_engine(pq, pq.encode(base), queries[:32], 10)
    # tie-aware top-1 check: the int8 scan may reorder NEAR-TIED
    # candidates (clustered synthetic data decodes many points to nearly
    # identical vectors), so assert the scan's top-1 achieves a true
    # f32 ADC distance within int8 tolerance of the true minimum instead
    # of raw id equality
    dist = _f32_adc_dist(pq, pq.encode(base), queries[:32])
    got = dist[np.arange(32), np.asarray(i_pl)[:, 0]]
    best = dist.min(axis=1)
    np.testing.assert_array_less(got, best * 1.02 + 1.0)
    # REPORTED values from the fast path are int8-scored (query + decode
    # quantization): ~accurate to ~10% worst-case — rankings above are
    # what the scan guarantees; exact=True reports f32 values
    np.testing.assert_allclose(np.asarray(d_pl)[:, 0],
                               np.asarray(d_x)[:, 0], rtol=0.15, atol=1.0)


def test_exact_path_full_topk(small_pq):
    """exact=True must reproduce the exact top-k over the decoded db."""
    pq, base, queries = small_pq
    n = base.shape[0]
    d, i = _search(pq, _prep(pq, base), queries[:16], 5, n, exact=True)
    dec = np.asarray(pq.decode(pq.encode(base)))
    exact = FlatIndex(128, "l2", chunk=1024)
    exact.add(dec)
    de, ie = exact.search(queries[:16], 5)
    # f32 rescoring: tight distance agreement on the common prefix
    np.testing.assert_allclose(np.sort(np.asarray(d), -1),
                               np.sort(np.asarray(de), -1),
                               rtol=1e-2, atol=0.5)
    # tie-aware: decoded near-duplicates differ by less than f32
    # round-off (observed gaps ~1e-6 relative), so compare achieved
    # distance, not id identity
    np.testing.assert_allclose(np.asarray(d)[:, 0],
                               np.asarray(de)[:, 0], rtol=1e-4, atol=0.5)


def test_n_not_multiple_of_tile(small_pq):
    """Padding rows must never appear in results."""
    pq, base, queries = small_pq
    n_valid = 3000   # not a multiple of the 1024-row operand padding
    prep = _prep(pq, base[:n_valid])
    for exact in (False, True):
        d, i = _search(pq, prep, queries[:8], 10, n_valid, exact=exact)
        assert np.asarray(i).max() < n_valid, exact
        assert np.asarray(i).min() >= 0, exact
        assert np.all(np.isfinite(np.asarray(d))), exact


def _f32_adc_dist(pq, codes, q):
    """True full-precision ADC distance matrix [B, N] (numpy): the
    reference semantics both engines approximate (XLA engine: bf16
    decode; packed scan: int8 decode)."""
    cb = np.asarray(pq.codebooks)
    m, _, ds = cb.shape
    codes = np.asarray(codes)
    q = np.asarray(q, np.float32)
    b = q.shape[0]
    qs = q.reshape(b, m, ds)
    ip = np.einsum("bms,mks->bmk", qs, cb)
    cbn = (cb ** 2).sum(-1)                                   # [M, K]
    dsq = cbn[np.arange(m)[None, :], codes].sum(-1)           # [N]
    cross = ip[np.arange(b)[:, None, None], np.arange(m)[None, None, :],
               codes[None, :, :]].sum(-1)                     # [B, N]
    return (q ** 2).sum(-1)[:, None] + dsq[None, :] - 2.0 * cross


def test_flat_adc_index_pallas_impl(small_pq):
    """FlatADCIndex(impl='pallas') drives the kernel through the index
    API (the switch interprets it on the CPU). Both the fast int8 path
    and the exact f32-rescore path are checked against TRUE f32 ADC
    ground truth (not against the bf16 decode engine, which is itself an
    approximation)."""
    pq, base, queries = small_pq
    dist = _f32_adc_dist(pq, pq.encode(base), queries[:16])
    best = dist.min(axis=1)
    idx = FlatADCIndex(pq, impl="pallas")
    idx.add(base)
    d, i = idx.search(queries[:16], 10)
    # tie-aware (see test_fast_path_matches_xla_engine): int8 tolerance
    got = dist[np.arange(16), np.asarray(i)[:, 0]]
    np.testing.assert_array_less(got, best * 1.02 + 1.0)
    d_e, i_e = idx.search(queries[:16], 10, exact=True)
    # f32 rescore: achieved distance matches the true min to round-off
    got_e = dist[np.arange(16), np.asarray(i_e)[:, 0]]
    np.testing.assert_allclose(got_e, best, rtol=1e-4, atol=0.5)


def test_fast_path_exact_for_top1(small_pq):
    """Segment lemma: fast path top-1 must equal exact path top-1."""
    pq, base, queries = small_pq
    n = base.shape[0]
    prep = _prep(pq, base)
    _, i_fast = _search(pq, prep, queries[:32], 1, n)
    _, i_ex = _search(pq, prep, queries[:32], 1, n, exact=True)
    np.testing.assert_array_equal(np.asarray(i_fast), np.asarray(i_ex))


def test_decoded_cache_parity(small_pq):
    """An explicit build_decoded_cache() gives the operand search()
    builds on first use, and add() invalidates it."""
    pq, base, queries = small_pq
    idx = FlatADCIndex(pq, impl="pallas")
    idx.add(base[:2048])
    d0, i0 = idx.search(queries[:16], 10)
    assert idx._dec8_n == 2048
    idx.build_decoded_cache()
    d1, i1 = idx.search(queries[:16], 10)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    idx.add(base[2048:])
    _, i2 = idx.search(queries[:16], 10)
    assert idx._dec8_n == idx.ntotal == base.shape[0]
    assert np.asarray(i2).max() < base.shape[0]


# ---------------------------------------------------- kernel vs plain twin
def _random_operands(rng, b, n, d, seg, n_valid=None):
    dec = jnp.asarray(rng.integers(-127, 128, (n, A.padded_dim(d))),
                      jnp.int8)
    norm = jnp.asarray(rng.uniform(0, 5e4, n), jnp.float32)
    srow = jnp.asarray(rng.uniform(0.1, 1.0, d), jnp.float32)
    q = jnp.asarray(rng.normal(size=(b, d)) * 30, jnp.float32)
    vcap, ibase = A._pack_caps(seg, d)
    q2s, qs = A._fold_queries(q, srow, A.padded_dim(d), None, vcap)
    base = A._base_column(norm, qs, n if n_valid is None else n_valid,
                          seg, vcap, ibase)
    return q2s, dec, base


@pytest.mark.parametrize("b,n,d,seg", [(8, 1024, 128, 128),
                                       (40, 2048, 64, 64),
                                       (130, 1024, 32, 32),
                                       (16, 512, 96, 16)])
def test_kernel_matches_plain_twin_bitwise(rng, b, n, d, seg):
    """Interpret-mode kernel and the plain XLA twin: identical packed
    segment minima (integer arithmetic end to end)."""
    q2s, dec, base = _random_operands(rng, b, n, d, seg, n_valid=n - 77)
    k_out = A.segmin(q2s, dec, base, seg=seg, route="interpret")
    x_out = A.segmin(q2s, dec, base, seg=seg, route="xla")
    assert k_out.shape == (q2s.shape[0], n // seg)
    np.testing.assert_array_equal(np.asarray(k_out), np.asarray(x_out))
    # and both equal the definition: min over each segment of the key
    ip = np.asarray(q2s, np.int64) @ np.asarray(dec, np.int64).T
    bq = q2s.shape[0] // base.shape[0]            # one base row per block
    keys = ip * seg + np.repeat(np.asarray(base), bq, axis=0)
    np.testing.assert_array_equal(
        np.asarray(x_out), keys.reshape(-1, n // seg, seg).min(axis=2))


@pytest.mark.parametrize("seg,lp", [(32, 512), (64, 256)])
def test_paged_scan_matches_twin(rng, seg, lp):
    """Each program reads its own page id: same minima as gathering the
    pages first, in page-list order."""
    n_pages = 6
    q2s, dec, base = _random_operands(rng, 24, n_pages * lp, 128, seg)
    pages = jnp.asarray([4, 0, 5, 2], jnp.int32)
    k_out = A.segmin(q2s, dec, base, seg=seg, route="interpret",
                     pages=pages, lp=lp)
    x_out = A.segmin(q2s, dec, base, seg=seg, route="xla", pages=pages,
                     lp=lp)
    np.testing.assert_array_equal(np.asarray(k_out), np.asarray(x_out))
    rows = (np.asarray(pages)[:, None] * lp + np.arange(lp)).reshape(-1)
    flat = A.segmin(q2s, dec[rows], base[:, rows], seg=seg, route="xla")
    np.testing.assert_array_equal(np.asarray(k_out), np.asarray(flat))


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_lowers_for_gpu(rng, paged):
    """The Triton route lowers for CUDA (kernel IR built without a card:
    catches unsupported primitives and block shapes before a chip run)."""
    q2s, dec, base = _random_operands(rng, 256, 2048, 128, 32)
    fn = functools.partial(A._segmin_pallas, seg=32, lp=512 if paged else None)
    args = (q2s, dec, base) + ((jnp.asarray([3, 1], jnp.int32),)
                               if paged else ())
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text and "adc_segmin" in text


def test_row_block_and_padding_choice():
    """Tile and padding rules of the wrapper."""
    assert A._row_block(128, None, 1 << 20) == 256
    assert A._row_block(32, 512, 512) == 128
    assert A._row_block(32, 64, 64) == 64
    assert A._row_block(32, None, 96) == 32
    assert A._row_block(512, None, 4096) == 512
    with pytest.raises(ValueError):
        A._row_block(128, None, 200)
    assert [A._query_block(b) for b in (1, 16, 40, 64, 100, 8192)] == \
        [16, 16, 64, 64, 128, 128]
    assert [A.padded_dim(d) for d in (8, 32, 64, 96, 128)] == \
        [32, 32, 64, 128, 128]
    q2s, qs = A._fold_queries(jnp.ones((130, 96)), jnp.ones(96), 128)
    assert q2s.shape == (256, 128) and q2s.dtype == jnp.int8
    assert qs.shape == (2,)                       # one scale per block
    assert int(jnp.abs(q2s[130:]).max()) == 0
    assert int(jnp.abs(q2s[:, 96:]).max()) == 0
    with pytest.raises(ValueError):
        A.adc_search(jnp.ones((2, 8)), None, None, None, 200, 1,
                     route="xla")


@pytest.mark.parametrize("route", ["xla", "interpret"])
def test_query_blocks_scale_independently(small_pq, route):
    """Each block of 128 queries gets its own int8 scale: a block's
    results do not change when a block of much larger queries joins the
    batch, so a large batch quantizes no query more coarsely."""
    pq, base, queries = small_pq
    prep = _prep(pq, base)
    n = base.shape[0]
    q = np.concatenate([queries] * 2)                       # 128 queries
    d1, i1 = _search(pq, prep, q, 10, n, route=route)
    d2, i2 = _search(pq, prep, np.concatenate([q, 50.0 * q]), 10, n,
                     route=route)
    np.testing.assert_array_equal(np.asarray(d2)[:128], np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(i2)[:128], np.asarray(i1))


@pytest.mark.parametrize("seg,d", [(128, 128), (32, 32), (8, 32),
                                   (16, 512)])
def test_rank_keys_exact_order(rng, seg, d):
    """The float32 ranking view keeps every distinct packed key distinct
    and in order over the whole key range, invalid keys clamped last."""
    vcap, ibase = A._pack_caps(seg, d)
    ipb = 127 * 127 * d
    lo, inv = -ipb * seg, (ibase - ipb) * seg
    keys = np.concatenate([
        [lo, lo + 1, -1, 0, 1, inv - 2, inv - 1, inv, inv + 5,
         (ibase + ipb) * seg + seg - 1],
        rng.integers(lo, inv, 2000)]).astype(np.int32)
    r = np.asarray(A._rank_keys(jnp.asarray(keys), inv, seg, d))
    assert np.isfinite(r).all() and (r > 0).all()
    assert (r >= np.finfo(np.float32).tiny).all()        # no denormals
    valid = keys < inv
    order = np.argsort(keys[valid], kind="stable")
    assert (np.diff(r[valid][order]) > 0).sum() == \
        (np.diff(keys[valid][order]) > 0).sum()
    assert (r[~valid] == r[~valid].max()).all()
    assert r[~valid].max() > r[valid].max()


@pytest.mark.gpu
def test_compiled_kernel_matches_twin_on_gpu(gpu):
    """On a card: the compiled Triton kernel gives the twin's keys."""
    rng = np.random.default_rng(0)
    q2s, dec, base = _random_operands(rng, 256, 1 << 16, 128, 128)
    k_out = A.segmin(q2s, dec, base, seg=128, route="pallas")
    x_out = A.segmin(q2s, dec, base, seg=128, route="xla")
    np.testing.assert_array_equal(np.asarray(k_out), np.asarray(x_out))
