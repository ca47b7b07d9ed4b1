"""Global image embeddings: pluggable JAX encoders + pipeline helpers.

Reference components #18-22 (tf_extract_feat, libtorch_extract_feat,
opencv_dnn_feature, opencv_caffe_sim, caffe_feature) are five C++
wrappers around frozen CNN graphs exposing the same surface:
`initModel(model) / computeFeat(image) / computeFeatsBatch(images)` with
L2 normalization (e.g. tf_extract_feat/include/tfExtractFeature.hpp:36-63).
Here that surface collapses to "any JAX callable [B,H,W,C] -> [B,D]"
jitted once; this module provides the harness (preprocessing, batching,
L2 norm, PCA/SQ compression chaining) plus a self-contained convolutional
encoder for pipelines that need a deterministic built-in model (no
pretrained weights are bundled — plug in flax/transformers models via
`fn`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops.linalg import l2_normalize

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(images, *, size: int = 224, mean=IMAGENET_MEAN,
               std=IMAGENET_STD) -> jax.Array:
    """uint8/float [B, H, W, 3] -> normalized float32 [B, size, size, 3]
    (the mean-subtract + resize path of caffe_feature/test.cpp:37-81)."""
    x = jnp.asarray(images)
    if x.dtype == jnp.uint8:
        x = x.astype(jnp.float32) / 255.0
    x = jax.image.resize(x, (x.shape[0], size, size, x.shape[-1]),
                         method="linear")
    return (x - jnp.asarray(mean)) / jnp.asarray(std)


def _conv(x, w, stride=1):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _init_simple_cnn(key, dim: int, channels=(32, 64, 128, 256)):
    """Deterministic small conv encoder (He-init). Not pretrained — a
    structural stand-in so embedding pipelines run end-to-end; swap in a
    real model via EmbeddingExtractor(fn=...)."""
    params = []
    cin = 3
    for i, cout in enumerate(channels):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (3, 3, cin, cout)) * jnp.sqrt(
            2.0 / (9 * cin))
        params.append(w)
        cin = cout
    key, sub = jax.random.split(key)
    head = jax.random.normal(sub, (cin, dim)) * jnp.sqrt(1.0 / cin)
    return params, head


def _simple_cnn_forward(params, head, x):
    for w in params:
        x = _conv(x, w, stride=2)
        x = jax.nn.relu(x)
    x = jnp.mean(x, axis=(1, 2))                    # global average pool
    return jnp.matmul(x, head, preferred_element_type=jnp.float32)


@dataclass
class EmbeddingExtractor:
    """Batched image -> embedding with L2 norm; the batched replacement for
    the reference's five CNN wrapper classes."""

    fn: object                   # callable [B, H, W, C] -> [B, D]
    dim: int
    input_size: int = 224

    @classmethod
    def simple_cnn(cls, dim: int = 128, seed: int = 0,
                   input_size: int = 224) -> "EmbeddingExtractor":
        params, head = _init_simple_cnn(jax.random.key(seed), dim)

        @jax.jit
        def fn(x):
            return _simple_cnn_forward(params, head, x)

        return cls(fn=fn, dim=dim, input_size=input_size)

    def compute(self, images, *, l2norm: bool = True,
                batch_size: int = 64) -> jax.Array:
        """images [B, H, W, 3] (uint8 or float) -> [B, dim] float32."""
        x = preprocess(images, size=self.input_size)
        outs = []
        for s in range(0, x.shape[0], batch_size):
            e = self.fn(x[s:s + batch_size])
            outs.append(l2_normalize(e) if l2norm else e)
        return jnp.concatenate(outs, axis=0)


class TextEmbedding:
    """Word-vector lookup + L2 norm (fasttext_embedding equivalent,
    fasttext_model.cc:5-37): a host-side vocab dict + a device embedding
    table; OOV words return zeros."""

    def __init__(self, vocab: dict, vectors):
        """vocab: {word: row}; vectors [V, D] float."""
        self.vocab = dict(vocab)
        self.table = jnp.asarray(vectors, jnp.float32)

    @classmethod
    def from_txt(cls, path: str) -> "TextEmbedding":
        """Load fasttext .vec text format (word v1 v2 ... per line)."""
        vocab, rows = {}, []
        with open(path) as f:
            first = f.readline().split()
            if len(first) != 2:     # no header: rewind via reopen
                f.seek(0)
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 3:
                    continue
                vocab[parts[0]] = len(rows)
                rows.append(np.asarray(parts[1:], np.float32))
        return cls(vocab, np.stack(rows))

    def embed(self, words, *, l2norm: bool = True) -> jax.Array:
        ids = np.asarray([self.vocab.get(w, -1) for w in words], np.int32)
        emb = jnp.where(
            (ids >= 0)[:, None],
            self.table[np.maximum(ids, 0)],
            0.0)
        return l2_normalize(emb) if l2norm else emb
