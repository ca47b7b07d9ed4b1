"""Motion-area / picture-in-picture region detection.

Reference: detection_and_tracking/pip_detection —
`MotionAreaDetecion::{findMaxBBox,findTopKBBox}`
(include/motion_area_detection.h:37-55, src/motion_area_detection.cc
:22-288): frame-difference motion masks accumulated over a clip, edges +
Hough-style line accumulation to find the inner-video rectangle.

Batched design: the whole clip is one [T, H, W] tensor; difference masks,
box blur, and the row/column projection profiles are batched reductions.
Rectangle finding uses axis projections of the accumulated motion mask
(rows/cols whose motion energy exceeds a fraction of the peak), which is
the separable equivalent of the reference's line accumulation — returns
the dominant motion bounding box plus a coverage score.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class MotionBox(NamedTuple):
    box: jax.Array       # [4] (x1, y1, x2, y2) pixel coords
    coverage: jax.Array  # fraction of motion energy inside the box
    motion_mask: jax.Array  # [H, W] accumulated motion energy


def _box_blur(x: jax.Array, r: int = 2) -> jax.Array:
    """[H, W] separable box blur via cumulative sums."""
    k = 2 * r + 1
    pad = jnp.pad(x, ((r + 1, r), (0, 0)))
    c = jnp.cumsum(pad, axis=0)
    x = (c[k:] - c[:-k]) / k
    pad = jnp.pad(x, ((0, 0), (r + 1, r)))
    c = jnp.cumsum(pad, axis=1)
    return (c[:, k:] - c[:, :-k]) / k


@partial(jax.jit, static_argnames=("diff_threshold", "profile_frac"))
def detect_motion_area(frames: jax.Array, *, diff_threshold: float = 0.06,
                       profile_frac: float = 0.25) -> MotionBox:
    """frames [T, H, W] gray in [0, 1] -> dominant motion bounding box.

    Mirrors the pip_detection pipeline: per-frame absolute differences ->
    threshold -> temporal accumulation -> smoothed mask -> axis-projection
    rectangle fit.
    """
    x = jnp.asarray(frames, jnp.float32)
    diff = jnp.abs(x[1:] - x[:-1])                       # [T-1, H, W]
    mask = (diff > diff_threshold).astype(jnp.float32)
    acc = jnp.mean(mask, axis=0)                         # [H, W]
    acc = _box_blur(acc, 2)

    rows = jnp.sum(acc, axis=1)                          # [H]
    cols = jnp.sum(acc, axis=0)                          # [W]
    r_th = profile_frac * jnp.max(rows)
    c_th = profile_frac * jnp.max(cols)
    h = rows.shape[0]
    w = cols.shape[0]
    ridx = jax.lax.broadcasted_iota(jnp.int32, (h,), 0)
    cidx = jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
    r_on = rows > r_th
    c_on = cols > c_th
    y1 = jnp.min(jnp.where(r_on, ridx, h))
    y2 = jnp.max(jnp.where(r_on, ridx, -1)) + 1
    x1 = jnp.min(jnp.where(c_on, cidx, w))
    x2 = jnp.max(jnp.where(c_on, cidx, -1)) + 1

    inside = ((ridx[:, None] >= y1) & (ridx[:, None] < y2)
              & (cidx[None, :] >= x1) & (cidx[None, :] < x2))
    total = jnp.maximum(jnp.sum(acc), 1e-9)
    coverage = jnp.sum(jnp.where(inside, acc, 0.0)) / total
    return MotionBox(box=jnp.stack([x1, y1, x2, y2]).astype(jnp.int32),
                     coverage=coverage, motion_mask=acc)


def find_topk_boxes(frames: jax.Array, k: int = 3, **kwargs):
    """Iteratively extract up to k motion boxes (findTopKBBox equivalent):
    detect, zero the winning region, repeat (host loop; k is tiny)."""
    x = jnp.asarray(frames, jnp.float32)
    boxes, coverages = [], []
    res = detect_motion_area(x, **kwargs)
    mask = res.motion_mask
    for _ in range(k):
        rows = jnp.sum(mask, axis=1)
        cols = jnp.sum(mask, axis=0)
        if float(jnp.max(rows)) <= 0:
            break
        # reuse the projection fit on the remaining mask
        r_th = 0.25 * jnp.max(rows)
        c_th = 0.25 * jnp.max(cols)
        h, w = mask.shape
        ridx = jnp.arange(h)
        cidx = jnp.arange(w)
        r_on = rows > r_th
        c_on = cols > c_th
        y1 = int(jnp.min(jnp.where(r_on, ridx, h)))
        y2 = int(jnp.max(jnp.where(r_on, ridx, -1))) + 1
        x1 = int(jnp.min(jnp.where(c_on, cidx, w)))
        x2 = int(jnp.max(jnp.where(c_on, cidx, -1))) + 1
        total = float(jnp.sum(res.motion_mask))
        cov = float(jnp.sum(mask[y1:y2, x1:x2])) / max(total, 1e-9)
        boxes.append((x1, y1, x2, y2))
        coverages.append(cov)
        mask = mask.at[y1:y2, x1:x2].set(0.0)
    return boxes, coverages
