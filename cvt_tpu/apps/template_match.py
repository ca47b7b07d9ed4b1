"""Template matching in frames/images: GHT-style verification.

Reference:
  * video_object_match/src/GHT.cpp — per-frame SIFT + FLANN 2-NN ratio
    match (demo.cpp distRatio=0.9, numThrehold=10), SVF spatial
    validation (:6-156), OCTAVE-difference histogram validation
    (`OctaveDiff`/`OctaveValidate`, :157-180: matches must agree on a
    dominant scale ratio), optional cv::findHomography RANSAC (:238-255).
  * detection_and_tracking/logo_detection — SIFT templates packed into a
    model (make_model.cc), per-image 1-NN threshold match
    (logo.cc:104-105, sift_near_thresh), SVF validation (logo.cc:237).
  * ffmpeg_read_memory / the FFDecoder path: video decode stays host-side
    here (any [T, H, W] gray frame array source: imageio, cv2, ...) —
    the device consumes batched frame tensors.

Batched design: frames are processed as a BATCH — one extract_sift call for
all frames, vmapped matching/verification. No per-frame Python loops on
the device path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.features.covdet import SiftFeatures, extract_sift
from cvt_tpu.match.nn import match_descriptors
from cvt_tpu.match.ransac import ransac
from cvt_tpu.match.svf import svf_inliers


def octave_validate(sigma1, sigma2, valid, *, n_bins: int = 11,
                    min_frac: float = 0.5):
    """Scale-ratio (octave-difference) histogram validation
    (GHT.cpp:157-180): inlier matches must agree on a dominant
    log2(sigma2/sigma1) bin. Returns mask of matches in the dominant bin
    (all False when no bin reaches `min_frac` of the votes)."""
    ds = jnp.log2((sigma2 + 1e-6) / (sigma1 + 1e-6))
    bins = jnp.clip(jnp.round(ds).astype(jnp.int32) + n_bins // 2,
                    0, n_bins - 1)
    hist = jnp.zeros((n_bins,), jnp.float32).at[bins].add(
        valid.astype(jnp.float32))
    total = jnp.maximum(jnp.sum(hist), 1.0)
    best = jnp.argmax(hist)
    ok = hist[best] / total >= min_frac
    return valid & (bins == best) & ok


def hog_descriptor(img, *, cell: int = 8, n_bins: int = 9):
    """Batched HOG: [..., H, W] gray -> [..., nH*nW*n_bins] f32,
    L2-normalized. The logo detector's SECONDARY decision signal
    (logo_detection/src/logo.cc:360-394 computes a HOG distance between
    the template and its matched subwindow). Unsigned orientation
    (mod pi), hard cell binning — batched, no per-pixel loops."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[-2], img.shape[-1]
    hc, wc = (h // cell) * cell, (w // cell) * cell
    g = img[..., :hc, :wc]
    gx = 0.5 * (jnp.roll(g, -1, -1) - jnp.roll(g, 1, -1))
    gy = 0.5 * (jnp.roll(g, -1, -2) - jnp.roll(g, 1, -2))
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx) % jnp.pi                 # unsigned [0, pi)
    b = jnp.clip((ang / jnp.pi * n_bins).astype(jnp.int32), 0, n_bins - 1)
    onehot = jax.nn.one_hot(b, n_bins) * mag[..., None]
    cells = onehot.reshape(img.shape[:-2]
                           + (hc // cell, cell, wc // cell, cell, n_bins))
    hist = jnp.sum(cells, axis=(-2, -4))
    d = hist.reshape(img.shape[:-2] + (-1,))
    return d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True)
                             + 1e-12)


def _warp_affine_patch(frame, model, out_h: int, out_w: int):
    """Sample `frame` [H, W] at model([2,3] template->frame) applied to
    the template pixel grid -> [out_h, out_w] warped patch."""
    from cvt_tpu.features.descriptor import bilinear_sample
    ys, xs = jnp.mgrid[0:out_h, 0:out_w]
    xs = xs.astype(jnp.float32)
    ys = ys.astype(jnp.float32)
    fx = model[0, 0] * xs + model[0, 1] * ys + model[0, 2]
    fy = model[1, 0] * xs + model[1, 1] * ys + model[1, 2]
    return bilinear_sample(frame, fx, fy)


@dataclass
class TemplateMatch:
    """Per-frame result: hit flag, #verified inliers, affine model."""
    hits: np.ndarray        # [T] bool
    n_inliers: np.ndarray   # [T] int32
    models: np.ndarray      # [T, 2, 3] affine template->frame
    hog_dist: np.ndarray | None = None   # [T] f32 (match_frames only)


class TemplateMatcher:
    """Find a template object inside a batch of frames/images."""

    def __init__(self, template_image=None, *, features=None,
                 template_shape=None, template_hog=None,
                 max_features: int = 256,
                 ratio: float = 0.9, min_matches: int = 10,
                 hog_threshold: float | None = None,
                 use_octave_check: bool = True,
                 use_ransac: bool = True, ransac_threshold: float = 10.0):
        """template_image [H, W] gray in [0, 1]; or precomputed
        `features` (SiftFeatures) + `template_shape` (+ optional
        `template_hog`) from a saved model pack (make_model.cc analogue).

        hog_threshold enables the reference's secondary HOG decision
        (logo.cc:387-394): a frame also matches when the HOG distance
        between the template and its affine-matched subwindow is <= the
        threshold — and with BOTH thresholds active the reference
        accepts on EITHER signal."""
        if template_image is not None:
            t = jnp.asarray(template_image, jnp.float32)[None]
            self.tmpl = extract_sift(t, max_features=max_features,
                                     rootsift=True)
            self.template_shape = tuple(np.asarray(t).shape[1:])
            self.template_hog = hog_descriptor(t[0])
        else:
            if features is None or template_shape is None:
                raise ValueError("need template_image or features"
                                 " + template_shape")
            self.tmpl = features
            self.template_shape = tuple(template_shape)
            self.template_hog = template_hog
        self.ratio = ratio
        self.min_matches = min_matches
        self.hog_threshold = hog_threshold
        self.use_octave_check = use_octave_check
        self.use_ransac = use_ransac
        self.ransac_threshold = ransac_threshold
        self.max_features = max_features

    def match_features(self, feats: SiftFeatures, key=None) -> TemplateMatch:
        """Verify the template against pre-extracted frame features."""
        if key is None:
            key = jax.random.key(0)
        td = self.tmpl.descriptors[0]
        tf = self.tmpl.frames[0]
        tv = self.tmpl.valid[0]
        n_frames = feats.descriptors.shape[0]

        def per_frame(fd, ff, fv, k_):
            m = match_descriptors(td, fd, valid1=tv, valid2=fv,
                                  ratio=self.ratio)
            p1 = tf[:, :2]
            f2 = ff[m.idx2]
            inl = svf_inliers(p1, tf[:, 3], f2[:, :2], f2[:, 3], m.valid)
            if self.use_octave_check:
                inl = octave_validate(tf[:, 2], f2[:, 2], inl)
            if self.use_ransac:
                res = ransac(k_, p1, f2[:, :2], inl, model="affine",
                             threshold=self.ransac_threshold,
                             n_hypotheses=128,
                             min_inliers=self.min_matches)
                return res.n_inliers, res.model
            return jnp.sum(inl).astype(jnp.int32), jnp.zeros((2, 3))

        keys = jax.random.split(key, n_frames)
        n_inl, models = jax.vmap(per_frame)(
            feats.descriptors, feats.frames, feats.valid, keys)
        n_inl = np.asarray(n_inl)
        return TemplateMatch(hits=n_inl >= self.min_matches,
                             n_inliers=n_inl, models=np.asarray(models))

    def match_frames(self, frames, key=None) -> TemplateMatch:
        """frames [T, H, W] gray in [0, 1] -> per-frame verification.

        With hog_threshold set, also computes the HOG distance between
        the template and each frame's affine-matched subwindow and
        accepts frames on EITHER the SIFT-inlier or the HOG signal
        (logo.cc:387-394 decision table; -1/None disables a signal)."""
        frames = jnp.asarray(frames, jnp.float32)
        feats = extract_sift(frames, max_features=self.max_features,
                             rootsift=True)
        res = self.match_features(feats, key=key)
        if self.hog_threshold is None or self.template_hog is None:
            return res
        th, tw = self.template_shape

        def one(frame, model):
            patch = _warp_affine_patch(frame, model, th, tw)
            hd = hog_descriptor(patch)
            return jnp.linalg.norm(hd - self.template_hog)

        hog_d = np.asarray(jax.vmap(one)(frames,
                                         jnp.asarray(res.models)))
        hits = res.hits | (hog_d <= self.hog_threshold)
        return TemplateMatch(hits=hits, n_inliers=res.n_inliers,
                             models=res.models, hog_dist=hog_d)


class LogoDetector:
    """Multi-template detector (logo_detection equivalent): each logo is
    a set of template images; an image is flagged when any template
    verifies with enough inliers (logo.cc decision rules :387-394,
    without the HOG secondary check)."""

    def __init__(self, templates: dict | None = None, **matcher_kwargs):
        """templates: {logo_name: [template_image, ...]}; or build from
        a saved pack with LogoDetector.load()."""
        self.matchers = {} if templates is None else {
            name: [TemplateMatcher(img, **matcher_kwargs) for img in imgs]
            for name, imgs in templates.items()}

    # -- template model pack (the make_model.cc .dat analogue) ----------
    def save(self, path: str) -> None:
        """Pack every template's precomputed features + HOG + thresholds
        into one npz — the batched equivalent of logo_detection's
        binary .dat model (make_model.cc:149-277 packs per-template
        name, SIFT features, thresholds, and the template image; here
        the image is replaced by its extracted features + HOG, which is
        all detection needs)."""
        arrays: dict = {}
        names = []
        for name, ms in self.matchers.items():
            for m in ms:
                i = len(names)
                names.append(name)
                t = m.tmpl
                arrays[f"t{i}_frames"] = np.asarray(t.frames[0])
                arrays[f"t{i}_desc"] = np.asarray(t.descriptors[0])
                arrays[f"t{i}_resp"] = np.asarray(t.response[0])
                arrays[f"t{i}_valid"] = np.asarray(t.valid[0])
                arrays[f"t{i}_hog"] = (np.asarray(m.template_hog)
                                       if m.template_hog is not None
                                       else np.zeros(0, np.float32))
                arrays[f"t{i}_shape"] = np.asarray(m.template_shape,
                                                   np.int32)
                arrays[f"t{i}_thr"] = np.asarray(
                    [m.min_matches,
                     -1.0 if m.hog_threshold is None else m.hog_threshold,
                     m.ratio, m.ransac_threshold], np.float32)
        arrays["names"] = np.asarray(names)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, **matcher_kwargs) -> "LogoDetector":
        """Rebuild a detector from a pack written by save() — no
        template images or re-extraction needed (the factory API of
        logo.h:16-24 Logo/LogoFactory)."""
        z = np.load(path, allow_pickle=False)
        det = cls(None)
        names = [str(s) for s in z["names"]]
        for i, name in enumerate(names):
            feats = SiftFeatures(
                frames=jnp.asarray(z[f"t{i}_frames"])[None],
                descriptors=jnp.asarray(z[f"t{i}_desc"])[None],
                response=jnp.asarray(z[f"t{i}_resp"])[None],
                valid=jnp.asarray(z[f"t{i}_valid"])[None])
            thr = z[f"t{i}_thr"]
            hog = z[f"t{i}_hog"]
            kw = dict(min_matches=int(thr[0]),
                      hog_threshold=None if thr[1] < 0 else float(thr[1]),
                      ratio=float(thr[2]), ransac_threshold=float(thr[3]))
            kw.update(matcher_kwargs)
            m = TemplateMatcher(
                features=feats, template_shape=tuple(z[f"t{i}_shape"]),
                template_hog=(jnp.asarray(hog) if hog.size else None),
                **kw)
            det.matchers.setdefault(name, []).append(m)
        return det

    def detect(self, images, key=None):
        """images [B, H, W] -> list of {logo_name: n_inliers} per image."""
        if key is None:
            key = jax.random.key(0)
        feats = extract_sift(jnp.asarray(images, jnp.float32),
                             rootsift=True)
        out = [dict() for _ in range(images.shape[0])]
        for name, matchers in self.matchers.items():
            for m in matchers:
                res = m.match_features(feats, key=key)
                for i in range(images.shape[0]):
                    if res.hits[i]:
                        out[i][name] = max(out[i].get(name, 0),
                                           int(res.n_inliers[i]))
        return out
