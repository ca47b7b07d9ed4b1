"""Image-level retrieval over local descriptors: vote + rerank.

Reference: the hnsw_sifts_retrieval app — makeIdx.cpp indexes every
RootSIFT descriptor of every image into one HNSW graph with a geometry
sidecar (:299-399), makeSearch.cpp queries per descriptor, filters by
distance < 0.1 and keypoint-angle difference < 10 degrees, counts votes
per image (:52-62), then SVF-reranks the top images (:66-107).

Batched design: the per-descriptor kNN runs on any cvt_tpu index (exact flat
by default — BASELINE.json config 4 replaces the HNSW walk with the flat
scan; pass a FlatADCIndex for the compressed path). Votes aggregate with
one scatter-add over image ids; reranking batches SVF or RANSAC over the
top candidates with fixed-size match slots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.features.covdet import SiftFeatures
from cvt_tpu.index.flat import FlatIndex
from cvt_tpu.match.ransac import ransac
from cvt_tpu.match.svf import svf_inliers


@dataclass
class ImageRetrievalIndex:
    """Flat store of all images' descriptors + keypoint geometry."""

    dim: int = 128
    metric: str = "l2"
    index: object = None            # any cvt_tpu index with add/search
    _img_ids: list = field(default_factory=list)
    _frames: list = field(default_factory=list)
    _names: list = field(default_factory=list)

    def __post_init__(self):
        if self.index is None:
            self.index = FlatIndex(self.dim, self.metric)

    @property
    def n_images(self) -> int:
        return len(self._names)

    def add_image(self, feats: SiftFeatures, name: str | None = None,
                  batch_index: int = 0) -> int:
        """Add one image's features (one batch row of extract_sift)."""
        v = np.asarray(feats.valid[batch_index])
        desc = np.asarray(feats.descriptors[batch_index])[v]
        frames = np.asarray(feats.frames[batch_index])[v]
        img_id = self.n_images
        if desc.shape[0]:
            self.index.add(desc)
            self._img_ids.append(np.full(desc.shape[0], img_id, np.int32))
            self._frames.append(frames.astype(np.float32))
        else:
            self._img_ids.append(np.zeros(0, np.int32))
            self._frames.append(np.zeros((0, 4), np.float32))
        self._names.append(name if name is not None else f"img_{img_id}")
        self._finalized = False
        return img_id

    def _finalize(self):
        if getattr(self, "_finalized", False):
            return
        self._all_ids = jnp.asarray(np.concatenate(self._img_ids))
        self._all_frames = jnp.asarray(np.concatenate(self._frames))
        self._finalized = True

    def search(self, feats: SiftFeatures, *, topk: int = 10,
               k_per_desc: int = 5, max_dist: float = 0.1,
               angle_thresh_deg: float = 10.0, batch_index: int = 0,
               rerank: str | None = "svf", rerank_depth: int = 10,
               rerank_matches: int = 64, key=None):
        """Query with one image's features.

        Returns (names, scores): candidate image names ranked by vote
        count (and rerank inlier count when rerank is 'svf'/'ransac').
        max_dist follows makeSearch.cpp:55 (squared-distance 0.1 on
        RootSIFT); angle filter mirrors the |da| < 10 degree check.
        """
        self._finalize()
        v = np.asarray(feats.valid[batch_index])
        qdesc = jnp.asarray(np.asarray(feats.descriptors[batch_index])[v])
        qframes = jnp.asarray(np.asarray(feats.frames[batch_index])[v])
        if qdesc.shape[0] == 0:
            return [], np.zeros(0, np.float32)

        d, nn = self.index.search(qdesc, k_per_desc)     # [Kq, kpd]
        nn_img = self._all_ids[nn]                       # [Kq, kpd]
        nn_frames = self._all_frames[nn]                 # [Kq, kpd, 4]
        da = jnp.degrees(jnp.abs(qframes[:, None, 3] - nn_frames[..., 3]))
        da = jnp.minimum(da % 360.0, 360.0 - da % 360.0)
        good = (d < max_dist) & (da < angle_thresh_deg)

        votes = jnp.zeros((self.n_images,), jnp.float32).at[
            nn_img.reshape(-1)].add(good.reshape(-1).astype(jnp.float32))
        nshow = min(topk if rerank is None else max(topk, rerank_depth),
                    self.n_images)
        vote_scores, cand = jax.lax.top_k(votes, nshow)

        if rerank is None:
            names = [self._names[i] for i in np.asarray(cand)[:topk]]
            return names, np.asarray(vote_scores)[:topk]

        # ---- rerank: fixed-slot match sets per candidate image ---------
        r = rerank_matches
        kq = qdesc.shape[0]

        def gather_matches(img):
            m = good & (nn_img == img)                   # [Kq, kpd]
            # best db hit per query descriptor for this image
            dm = jnp.where(m, d, jnp.inf)
            best = jnp.argmin(dm, axis=1)                # [Kq]
            bd = jnp.take_along_axis(dm, best[:, None], 1)[:, 0]
            ok = jnp.isfinite(bd)
            sel_frames = jnp.take_along_axis(
                nn_frames, best[:, None, None], 1)[:, 0]  # [Kq, 4]
            score = jnp.where(ok, -bd, -jnp.inf)
            _, pick = jax.lax.top_k(score, min(r, kq))   # [R]
            return (qframes[pick], sel_frames[pick],
                    ok[pick])

        f1, f2, mval = jax.vmap(gather_matches)(cand)    # [C, R, 4] x2

        if rerank == "svf":
            inl = jax.vmap(lambda a, b, m: svf_inliers(
                a[:, :2], a[:, 3], b[:, :2], b[:, 3], m))(f1, f2, mval)
            rr_scores = jnp.sum(inl, axis=1).astype(jnp.float32)
        elif rerank == "ransac":
            if key is None:
                key = jax.random.key(0)
            keys = jax.random.split(key, f1.shape[0])
            res = jax.vmap(lambda k_, a, b, m: ransac(
                k_, a[:, :2], b[:, :2], m, model="affine",
                threshold=8.0, n_hypotheses=64))(keys, f1, f2, mval)
            rr_scores = res.n_inliers.astype(jnp.float32)
        else:
            raise ValueError(f"unknown rerank {rerank!r}")

        # stable re-sort: inlier count first, votes as tiebreak
        combined = rr_scores * 1e4 + vote_scores
        order = jnp.argsort(-combined)[:topk]
        cand_np = np.asarray(cand)[np.asarray(order)]
        return ([self._names[i] for i in cand_np],
                np.asarray(rr_scores)[np.asarray(order)])
