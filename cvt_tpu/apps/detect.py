"""Anchor-free detection post-processing: box decode + batched NMS.

Reference: detection_and_tracking/fastest_det — FastestDet ONNX head
decoded in C++ (examples/fastest_det_demo.cc:63-142: sigmoid objectness x
class score, softmax-free box offsets, then OpenCV NMSBoxes) and Python
(python/main.py). The network itself is an external artifact there
(ONNX); the framework capability is the DECODE + NMS pipeline, which
here runs batched on device: decode is elementwise over the [B, H, W, C]
head output, NMS is a fixed-iteration masked suppression loop (no
dynamic-length boxes — static shapes with validity masks).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Detections(NamedTuple):
    boxes: jax.Array    # [B, K, 4] (x1, y1, x2, y2) normalized
    scores: jax.Array   # [B, K]
    classes: jax.Array  # [B, K] int32
    valid: jax.Array    # [B, K] bool


@partial(jax.jit, static_argnames=("max_dets",))
def decode_fastestdet(head: jax.Array, *, max_dets: int = 64,
                      score_threshold: float = 0.65) -> Detections:
    """Decode a FastestDet-style head [B, H, W, 5 + n_classes]:
    channels = (obj, cx_off, cy_off, w, h, class logits...). Matches the
    reference decode (fastest_det_demo.cc:63-120): score =
    sqrt(obj * max_class_prob); offsets pass tanh/sigmoid squashing;
    boxes normalized to [0, 1].
    """
    b, h, w, c = head.shape
    obj = jax.nn.sigmoid(head[..., 0])
    off = jnp.tanh(head[..., 1:3])
    wh = jax.nn.sigmoid(head[..., 3:5])
    cls_prob = jax.nn.softmax(head[..., 5:], axis=-1)
    best_cls = jnp.argmax(cls_prob, axis=-1)
    best_p = jnp.max(cls_prob, axis=-1)
    score = jnp.sqrt(jnp.maximum(obj * best_p, 0.0))             # [B, H, W]

    gx = (jax.lax.broadcasted_iota(jnp.float32, (b, h, w), 2)
          + 0.5 + off[..., 0]) / w
    gy = (jax.lax.broadcasted_iota(jnp.float32, (b, h, w), 1)
          + 0.5 + off[..., 1]) / h
    bw, bh = wh[..., 0], wh[..., 1]
    boxes = jnp.stack([gx - bw / 2, gy - bh / 2,
                       gx + bw / 2, gy + bh / 2], axis=-1)       # [B,H,W,4]

    flat_s = score.reshape(b, -1)
    topv, topi = jax.lax.top_k(flat_s, min(max_dets, h * w))
    take = lambda a: jnp.take_along_axis(
        a.reshape(b, h * w, -1), topi[..., None], axis=1)
    sel_boxes = take(boxes)[..., :4]
    sel_cls = jnp.take_along_axis(best_cls.reshape(b, -1), topi, axis=1)
    return Detections(boxes=sel_boxes, scores=topv,
                      classes=sel_cls.astype(jnp.int32),
                      valid=topv > score_threshold)


def _iou(a, b):
    """a [K, 4], b [K, 4] -> [K, K] IoU."""
    x1 = jnp.maximum(a[:, None, 0], b[None, :, 0])
    y1 = jnp.maximum(a[:, None, 1], b[None, :, 1])
    x2 = jnp.minimum(a[:, None, 2], b[None, :, 2])
    y2 = jnp.minimum(a[:, None, 3], b[None, :, 3])
    inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
    area = lambda z: jnp.maximum(z[:, 2] - z[:, 0], 0) * jnp.maximum(
        z[:, 3] - z[:, 1], 0)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / jnp.maximum(union, 1e-9)


@partial(jax.jit, static_argnames=("iou_threshold", "class_aware"))
def nms(dets: Detections, *, iou_threshold: float = 0.35,
        class_aware: bool = True) -> Detections:
    """Masked greedy NMS over fixed-size detection slots (the static-shape
    replacement for cv::dnn::NMSBoxes). Boxes must be sorted by score
    (decode_fastestdet emits them sorted)."""

    def per_image(boxes, scores, classes, valid):
        iou = _iou(boxes, boxes)
        same_cls = (classes[:, None] == classes[None, :]) if class_aware \
            else jnp.ones_like(iou, bool)
        k = boxes.shape[0]

        def body(i, keep):
            # suppress any lower-scored box overlapping box i (if kept)
            sup = (iou[i] > iou_threshold) & same_cls[i] & keep[i]
            idx = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)
            return keep & ~(sup & (idx > i))

        keep = jax.lax.fori_loop(0, k, body, valid)
        return keep

    keep = jax.vmap(per_image)(dets.boxes, dets.scores, dets.classes,
                               dets.valid)
    return dets._replace(valid=dets.valid & keep)
