"""int8 scalar quantizer: golden semantics vs the reference codec, and the
FlatSQ asymmetric scan vs exact search (the reference's cross-check
pattern, SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu.index import FlatIndex, FlatSQIndex
from cvt_tpu.ops import l2_normalize
from cvt_tpu.quant import ScalarQuantizer
from cvt_tpu.utils import recall_at_k


def _ref_encode(x, vmin, vdiff):
    """Literal transcription of cvt Int8Encode semantics
    (int8_quan.cc:72-94): xi=(x-vmin)/vdiff guarded, clip [0,1],
    bytes = int(255*xi) (truncation)."""
    xi = np.where(vdiff != 0, (x - vmin) / np.where(vdiff == 0, 1, vdiff), 0)
    xi = np.clip(xi, 0.0, 1.0)
    return (255 * xi).astype(np.int32).astype(np.uint8)


def _ref_decode(codes, vmin, vdiff):
    """cvt Int8Decode (int8_quan.cc:117-132): vmin + vdiff*(b+0.5)/255."""
    return vmin + vdiff * (codes.astype(np.float64) + 0.5) / 255.0


def test_train_minmax(rng):
    x = rng.normal(size=(500, 32)).astype(np.float32)
    sq = ScalarQuantizer.train(x, l2norm=False)
    np.testing.assert_allclose(np.asarray(sq.vmin), x.min(0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sq.vmin) + np.asarray(sq.vdiff),
                               x.max(0), rtol=1e-6)


def test_encode_matches_reference_truncation(rng):
    x = rng.normal(size=(200, 64)).astype(np.float32)
    xn = np.asarray(l2_normalize(x))
    sq = ScalarQuantizer.train(x, l2norm=True)
    got = np.asarray(sq.encode(xn))
    expect = _ref_encode(xn, np.asarray(sq.vmin), np.asarray(sq.vdiff))
    # float32 division rounding at the exact truncation boundary may flip a
    # code by 1; demand > 99.9% exact and never off by more than 1.
    diff = np.abs(got.astype(int) - expect.astype(int))
    assert (diff == 0).mean() > 0.998
    assert diff.max() <= 1


def test_decode_matches_reference(rng):
    codes = rng.integers(0, 256, size=(50, 64)).astype(np.uint8)
    x = rng.normal(size=(500, 64)).astype(np.float32)
    sq = ScalarQuantizer.train(x, l2norm=True)
    got = np.asarray(sq.decode(codes))
    expect = _ref_decode(codes, np.asarray(sq.vmin), np.asarray(sq.vdiff))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_roundtrip_loss_small(sift_like):
    base, _ = sift_like
    sq = ScalarQuantizer.train(base, l2norm=True)
    l2, ip = sq.reconstruction_loss(base)
    # L2-normalized inputs: reconstruction should be close to the unit vector
    assert float(l2) < 0.05
    assert float(ip) > 0.995


def test_affine_decode_form(rng):
    x = rng.normal(size=(100, 16)).astype(np.float32)
    sq = ScalarQuantizer.train(x, l2norm=False)
    codes = sq.encode(x)
    via_affine = np.asarray(sq.bias) + np.asarray(sq.scale) * np.asarray(
        codes).astype(np.float32)
    np.testing.assert_allclose(via_affine, np.asarray(sq.decode(codes)),
                               rtol=1e-5, atol=1e-6)


def test_sq_scan_matches_decoded_exact(sift_like):
    """FlatSQ bf16 scan must equal exact L2 search over decoded vectors."""
    base, queries = sift_like
    basen = np.asarray(l2_normalize(base))
    qn = np.asarray(l2_normalize(queries))
    sq = ScalarQuantizer.train(base, l2norm=True)
    idx = FlatSQIndex(sq, mode="bf16", chunk=1024)
    idx.add(basen)

    dec = np.asarray(sq.decode(sq.encode(basen)))
    exact = FlatIndex(128, "l2", chunk=1024)
    exact.add(dec)
    dq, iq = idx.search(qn, 10)
    de, ie = exact.search(qn, 10)
    # distances agree to bf16 matmul tolerance (atol covers a device
    # bf16 accumulation path); top-1 ids essentially always
    np.testing.assert_allclose(np.asarray(dq), np.asarray(de),
                               rtol=5e-2, atol=5e-3)
    assert (np.asarray(iq)[:, 0] == np.asarray(ie)[:, 0]).mean() > 0.95


def test_sq_recall_vs_float_exact(sift_like):
    base, queries = sift_like
    basen = np.asarray(l2_normalize(base))
    qn = np.asarray(l2_normalize(queries))
    exact = FlatIndex(128, "l2", chunk=4096)
    exact.add(basen)
    _, gt = exact.search(qn, 1)
    sq = ScalarQuantizer.train(base, l2norm=True)
    for mode in ("bf16", "int8"):
        idx = FlatSQIndex(sq, mode=mode, chunk=1024)
        idx.add(basen)
        _, ids = idx.search(qn, 10)
        r = recall_at_k(np.asarray(ids), np.asarray(gt)[:, 0], k=10)
        assert r > 0.95, (mode, r)


def test_sq_save_load(tmp_path, sift_like):
    base, queries = sift_like
    sq = ScalarQuantizer.train(base)
    idx = FlatSQIndex(sq, chunk=1024)
    idx.add(np.asarray(l2_normalize(base)))
    p = str(tmp_path / "sq.npz")
    idx.save(p)
    idx2 = FlatSQIndex.load(p)
    qn = np.asarray(l2_normalize(queries))[:4]
    d1, i1 = idx.search(qn, 5)
    d2, i2 = idx2.search(qn, 5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_flat_sq_search_fast_parity(rng, impl):
    """search_fast (plain XLA twin under 'auto' on the CPU, the kernel
    interpreted under 'pallas') agrees with the bf16 exact-rank scan:
    same top-1 and near-identical distance profiles."""
    import jax
    from cvt_tpu.index.flat_sq import FlatSQIndex
    from cvt_tpu.ops.linalg import l2_normalize
    from cvt_tpu.quant.sq import ScalarQuantizer
    import jax.numpy as jnp
    base = np.asarray(l2_normalize(jnp.asarray(
        rng.normal(size=(6000, 64)).astype(np.float32))))
    q = np.asarray(l2_normalize(jnp.asarray(
        rng.normal(size=(64, 64)).astype(np.float32))))
    sq = ScalarQuantizer.train(base, l2norm=False)
    idx = FlatSQIndex(sq, chunk=2048)
    idx.add(base)
    d_ref, i_ref = idx.search(q, 10)
    d_f, i_f = idx.search_fast(q, 10, impl=impl)
    d_ref, d_f = np.asarray(d_ref), np.asarray(d_f)
    top1 = (np.asarray(i_ref)[:, 0] == np.asarray(i_f)[:, 0]).mean()
    assert top1 >= 0.95, top1
    rel = np.abs(np.sort(d_f, 1) - np.sort(d_ref, 1)) / np.maximum(
        np.sort(d_ref, 1), 1e-3)
    assert np.median(rel) < 0.05, np.median(rel)
