"""Feature pipeline: pyramid invariants, detection on synthetic blobs,
descriptor invariance properties."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cvt_tpu.features import build_pyramid, extract_sift, root_sift


def _blob_image(h=128, w=128, blobs=((64, 64, 6.0),), seed=0):
    """White Gaussian blobs on black background."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for (cy, cx, s) in blobs:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(img, 0, 1)


def test_pyramid_shapes_and_blur_energy():
    img = np.random.default_rng(0).random((2, 64, 64)).astype(np.float32)
    pyr = build_pyramid(img, first_octave=0, n_scales=3)
    assert pyr[0].gauss.shape == (2, 6, 64, 64)
    assert pyr[0].dog.shape == (2, 5, 64, 64)
    assert pyr[1].gauss.shape[-1] == 32
    # increasing blur reduces high-frequency energy monotonically
    g = np.asarray(pyr[0].gauss)
    hf = [np.abs(np.diff(g[0, s], axis=-1)).mean() for s in range(6)]
    assert all(hf[i] >= hf[i + 1] - 1e-6 for i in range(5))


def test_pyramid_first_octave_minus_one_doubles():
    img = np.zeros((1, 64, 64), np.float32)
    pyr = build_pyramid(img, first_octave=-1)
    assert pyr[0].gauss.shape[-1] == 128
    assert pyr[0].step == 0.5


def test_detect_single_blob():
    img = _blob_image(blobs=((64, 64, 5.0),))[None]
    feats = extract_sift(img, max_features=32, first_octave=0)
    v = np.asarray(feats.valid[0])
    assert v.any(), "no keypoints on a clear blob"
    fr = np.asarray(feats.frames[0])[v]
    # strongest keypoint near the blob center
    d = np.sqrt((fr[:, 0] - 64) ** 2 + (fr[:, 1] - 64) ** 2)
    assert d.min() < 3.0, d.min()


def test_detect_scale_ordering():
    """A bigger blob must fire at a larger sigma than a smaller one."""
    img_small = _blob_image(blobs=((64, 64, 3.0),))[None]
    img_big = _blob_image(blobs=((64, 64, 9.0),))[None]
    f_s = extract_sift(img_small, max_features=8, first_octave=0)
    f_b = extract_sift(img_big, max_features=8, first_octave=0)

    def top_sigma(f):
        v = np.asarray(f.valid[0])
        fr = np.asarray(f.frames[0])[v]
        re = np.abs(np.asarray(f.response[0])[v])
        return fr[re.argmax(), 2]

    assert top_sigma(f_b) > 1.5 * top_sigma(f_s)


def test_descriptor_rotation_invariance():
    """Descriptors of a textured image and its exact 90-degree rotation
    must match at corresponding keypoints (with angles offset by 90)."""
    from cvt_tpu.features.scale_space import _blur

    rng = np.random.default_rng(5)
    tex = rng.random((1, 96, 96)).astype(np.float32)
    tex = np.asarray(_blur(jnp.asarray(tex), 2.0))
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    rot = np.rot90(tex[0]).copy()[None]
    f1 = extract_sift(tex, max_features=16, first_octave=0)
    f2 = extract_sift(rot, max_features=16, first_octave=0)
    v1 = np.asarray(f1.valid[0])
    v2 = np.asarray(f2.valid[0])
    fr1 = np.asarray(f1.frames[0])[v1]
    fr2 = np.asarray(f2.frames[0])[v2]
    d1 = np.asarray(f1.descriptors[0])[v1]
    d2 = np.asarray(f2.descriptors[0])[v2]
    # rot90 maps (x, y) -> (y, H-1-x)
    mapped = np.stack([fr1[:, 1], (96 - 1) - fr1[:, 0]], 1)
    checked = 0
    for i in range(len(fr1)):
        dd = np.linalg.norm(fr2[:, :2] - mapped[i], axis=1)
        j = dd.argmin()
        if dd[j] < 2.0:
            assert d1[i] @ d2[j] > 0.9, (i, j, d1[i] @ d2[j])
            da = np.degrees(fr1[i, 3] - fr2[j, 3]) % 360
            assert abs(da - 90.0) < 15.0 or abs(da - 270.0) < 15.0, da
            checked += 1
    assert checked >= 4, checked


def test_descriptor_norms_and_rootsift():
    img = _blob_image(blobs=((40, 40, 3.0), (90, 80, 5.0)))[None]
    feats = extract_sift(img, max_features=16, first_octave=0)
    v = np.asarray(feats.valid[0])
    d = np.asarray(feats.descriptors[0])[v]
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-3)
    # VLFeat semantics: clamp at 0.2 then renormalize, so entries may
    # exceed 0.2 (bounded by 0.2/||clamped||); 0.35 is a safe envelope
    assert d.min() >= 0.0 and d.max() <= 0.35
    r = np.asarray(root_sift(jnp.asarray(d)))
    np.testing.assert_allclose(np.linalg.norm(r, axis=-1), 1.0, atol=1e-3)


def test_batched_extraction_matches_single():
    imgs = np.stack([_blob_image(blobs=((40, 40, 4.0),)),
                     _blob_image(blobs=((80, 90, 6.0),))])
    fb = extract_sift(imgs, max_features=8, first_octave=0)
    f0 = extract_sift(imgs[0][None], max_features=8, first_octave=0)
    v = np.asarray(fb.valid[0]) & np.asarray(f0.valid[0])
    # compare x, y, scale only: a radially symmetric blob has no dominant
    # gradient orientation, so the orientation column is numerically
    # degenerate (either peak of the flat histogram may win per backend)
    np.testing.assert_allclose(np.asarray(fb.frames[0])[v][:, :3],
                               np.asarray(f0.frames[0])[v][:, :3],
                               atol=1e-3)


def test_orientation_duplication():
    """n_orientations>1 duplicates keypoints at secondary histogram
    peaks (vl_covdet.hpp:174-186): an X-shaped crossing has two strong
    gradient orientations, so duplicated extraction yields more valid
    keypoint slots at the same locations."""
    import numpy as np
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # two crossing ridges at +-45 degrees. Width matters: with /8.0 the
    # crossing blob's characteristic scale (~1.4 px) sits BELOW octave
    # 0's base scale (1.6), so DoG magnitude decreases monotonically
    # along scale and no 3-D extremum exists at first_octave=0 (correct
    # rejection, not a detector bug). /50.0 puts the blob mid-octave.
    img = (np.exp(-((xx - yy) ** 2) / 50.0)
           + np.exp(-((xx + yy - w) ** 2) / 50.0)).astype(np.float32)
    img = img / img.max()
    f1 = extract_sift(img[None], max_features=16, first_octave=0,
                      n_orientations=1)
    f4 = extract_sift(img[None], max_features=64, first_octave=0,
                      n_orientations=4)
    n1 = int(np.asarray(f1.n_valid)[0])
    n4 = int(np.asarray(f4.n_valid)[0])
    assert n1 > 0
    assert n4 > n1  # secondary orientation peaks produced duplicates
    # duplicates share locations but carry distinct angles
    fr = np.asarray(f4.frames)[0][np.asarray(f4.valid)[0]]
    locs, angles = fr[:, :2], fr[:, 3]
    dup_found = False
    for i in range(len(fr)):
        same = (np.abs(locs - locs[i]).max(axis=1) < 0.5)
        if same.sum() >= 2:
            a = np.sort(angles[same])
            if np.ptp(a) > 0.5:
                dup_found = True
                break
    assert dup_found


def test_dsp_sift_descriptors():
    """DSP-SIFT (sift.h:97-100): pooled descriptors stay unit-norm and
    match across a scale change better than or comparably to plain SIFT."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, size=(96, 96)).astype(np.float32)
    f = extract_sift(img[None], max_features=16, first_octave=0,
                     dsp_num_scales=5)
    valid = np.asarray(f.valid)[0]
    assert valid.any()
    d = np.asarray(f.descriptors)[0][valid]
    norms = np.linalg.norm(d, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_hessian_detector_blobs():
    """The Hessian detector (reference covdet default, vl_covdet.hpp:73-88)
    finds the same blob structures as DoG with comparable counts and
    localization."""
    img = _blob_image(blobs=((40, 40, 4.0), (90, 80, 6.0), (30, 100, 5.0)))
    f_dog = extract_sift(img[None], max_features=32, first_octave=0)
    f_hes = extract_sift(img[None], max_features=32, first_octave=0,
                         detector="hessian")
    n_dog = int(np.asarray(f_dog.n_valid)[0])
    n_hes = int(np.asarray(f_hes.n_valid)[0])
    assert n_hes > 0
    # counts within a factor of 2 of each other on structured images
    assert 0.5 * n_dog <= n_hes <= 2.0 * max(n_dog, 1), (n_dog, n_hes)
    # the strongest Hessian keypoint localizes a blob center
    fr = np.asarray(f_hes.frames[0])[np.asarray(f_hes.valid[0])]
    centers = np.array([[40, 40], [80, 90], [100, 30]], np.float32)
    d = np.sqrt(((fr[:, None, :2] - centers[None]) ** 2).sum(-1)).min(1)
    assert d.min() < 3.0


def test_affine_shape_recovers_anisotropy():
    """An elliptical Gaussian blob with 2:1 axes must yield an affine
    shape whose singular-value ratio ~2 (vl_covdet_extract_affine_shape
    behavior)."""
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sx, sy = 10.0, 5.0
    img = np.exp(-(((xx - 64) / sx) ** 2 + ((yy - 64) / sy) ** 2) / 2.0)
    f = extract_sift(img[None].astype(np.float32), max_features=8,
                     first_octave=0, affine_shape=True)
    v = np.asarray(f.valid[0])
    assert v.any()
    fr = np.asarray(f.frames[0])[v]
    re = np.abs(np.asarray(f.response[0])[v])
    aff = np.asarray(f.affine[0])[v]
    # pick the strongest central detection
    cd = np.sqrt((fr[:, 0] - 64) ** 2 + (fr[:, 1] - 64) ** 2)
    cand = np.where(cd < 6.0)[0]
    assert len(cand) > 0
    i = cand[re[cand].argmax()]
    svals, vecs = np.linalg.svd(aff[i])[1], np.linalg.svd(aff[i])[0]
    ratio = svals[0] / svals[1]
    # expectation: the SMM sees the blob CONVOLVED with the detection
    # level's isotropic blur (sigma_lvl ~ 3.2 octave px vs blob axes
    # 5/2.5), so the equilibrium ratio is sqrt((sx^2+s^2)/(sy^2+s^2))
    # ~ 1.46, not the unblurred 2.0 (same attenuation as VLFeat's
    # scale-space patches)
    assert 1.25 < ratio < 2.2, ratio
    # elongation along x: the dominant singular vector is x-axis-aligned
    assert abs(vecs[0, 0]) > 0.9, vecs
    np.testing.assert_allclose(abs(np.linalg.det(aff[i])), 1.0, rtol=1e-3)


def test_affine_descriptor_sampling_property():
    """Exact property of the affine sampling path: the descriptor of
    img1 at (c, sigma, A=I) equals the descriptor of the x-squeezed
    image img2(x,y)=img1(2x,y) at (c_x/2, c_y, sigma, A=diag(0.5,1)) —
    sample positions map to identical content and the A^T gradient
    pull-back cancels the chain-rule factor. Without the affine
    correction the descriptors differ."""
    from cvt_tpu.features.scale_space import _blur, _gradients
    from cvt_tpu.features.descriptor import sift_descriptors
    rng = np.random.default_rng(7)
    img1 = np.asarray(_blur(jnp.asarray(
        rng.random((1, 128, 256)).astype(np.float32)), 3.0))
    img2 = img1[:, :, ::2]                       # img2(x,y) = img1(2x,y)
    dx1, dy1 = _gradients(jnp.asarray(img1)[:, None])
    dx2, dy2 = _gradients(jnp.asarray(img2)[:, None])
    x1 = jnp.asarray([[128.0]]); y1 = jnp.asarray([[64.0]])
    x2 = jnp.asarray([[64.0]]); y2 = jnp.asarray([[64.0]])
    sig = jnp.asarray([[6.0]])
    lev = jnp.zeros((1, 1), jnp.int32)
    ang = jnp.zeros((1, 1))
    ok = jnp.ones((1, 1), bool)
    eye = jnp.broadcast_to(jnp.eye(2), (1, 1, 2, 2))
    sq = jnp.broadcast_to(jnp.asarray([[0.5, 0.0], [0.0, 1.0]]),
                          (1, 1, 2, 2))
    d1 = np.asarray(sift_descriptors(dx1, dy1, x1, y1, sig, lev, ang, ok,
                                     affine=eye))[0, 0]
    d2 = np.asarray(sift_descriptors(dx2, dy2, x2, y2, sig, lev, ang, ok,
                                     affine=sq))[0, 0]
    d2_plain = np.asarray(sift_descriptors(dx2, dy2, x2, y2, sig, lev,
                                           ang, ok, affine=eye))[0, 0]
    cos_aff = float(d1 @ d2)
    cos_plain = float(d1 @ d2_plain)
    assert cos_aff > 0.95, cos_aff
    assert cos_aff > cos_plain + 0.05, (cos_aff, cos_plain)


@pytest.mark.slow
def test_extract_operating_point_vmem():
    """The vlindex operating point compiles and runs at full scale:
    first_octave=-1, K=2048, 640x480, two orientations, RootSIFT
    (sift.h:44-113). On the CPU it proves the shapes trace; chip_smoke.py
    runs extraction at K=8192 on a GPU."""
    from cvt_tpu.io.datasets import procedural_images
    imgs = procedural_images(2, 480, 640, seed=11)
    out = extract_sift(imgs, max_features=2048, first_octave=-1,
                       n_orientations=2, rootsift=True)
    d = np.asarray(out.descriptors)
    v = np.asarray(out.valid)
    assert d.shape == (2, 2048, 128)
    assert (v.sum(axis=1) > 500).all(), v.sum(axis=1)
    norms = np.linalg.norm(d[0][v[0]], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    fr = np.asarray(out.frames)
    assert (fr[v][:, 0] >= 0).all() and (fr[v][:, 0] < 640).all()
    assert (fr[v][:, 1] >= 0).all() and (fr[v][:, 1] < 480).all()
