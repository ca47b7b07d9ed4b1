"""Text embeddings: fastText-style word + subword n-gram lookup.

Reference: fasttext_embedding/fasttext_model.cc:5-37 —
cvtk::nlp::FasttextModel wraps a trained fastText model: Init(model),
GetEmbedd(word) = word/subword vector lookup, L2Norm. The model itself
is an external artifact there; the framework capability is embedding
lookup + normalization as a search front-end.

Batched design: the embedding table is a device array; a batch of token-id
rows becomes ONE gather + mean + L2-normalize under jit. Out-of-vocab
handling follows fastText: unknown words average hashed character
n-gram bucket vectors (FNV-1a hash into `n_buckets`, the fastText
hashing scheme), so any string maps to a stable embedding.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops import l2_normalize


def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for byte in data:
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def char_ngrams(word: str, n_min: int = 3, n_max: int = 6) -> list[str]:
    """fastText-style boundary-marked character n-grams of '<word>'."""
    w = f"<{word}>"
    out = []
    for n in range(n_min, n_max + 1):
        out.extend(w[i:i + n] for i in range(len(w) - n + 1))
    return out


class TextEmbedder:
    """Word + subword embedding lookup with L2-normalized outputs."""

    def __init__(self, vocab: dict[str, int], vectors,
                 ngram_vectors=None, *, n_min: int = 3, n_max: int = 6):
        """vocab: word -> row in `vectors` [V, D]. ngram_vectors
        [n_buckets, D] enables subword fallback for OOV words."""
        self.vocab = dict(vocab)
        self.vectors = jnp.asarray(vectors, jnp.float32)
        self.dim = int(self.vectors.shape[1])
        self.ngrams = (None if ngram_vectors is None
                       else jnp.asarray(ngram_vectors, jnp.float32))
        self.n_min, self.n_max = n_min, n_max

    @classmethod
    def random(cls, words: list[str], dim: int = 64,
               n_buckets: int = 4096, seed: int = 0) -> "TextEmbedder":
        """Randomly initialized model (tests / training from scratch)."""
        rng = np.random.default_rng(seed)
        vecs = rng.normal(size=(len(words), dim)).astype(np.float32)
        ng = rng.normal(size=(n_buckets, dim)).astype(np.float32)
        return cls({w: i for i, w in enumerate(words)}, vecs, ng)

    # -- host-side tokenization ------------------------------------------
    def _word_vec_rows(self, word: str):
        """(table, rows) for one word: vocab row or hashed n-gram rows."""
        i = self.vocab.get(word)
        if i is not None:
            return "word", [i]
        if self.ngrams is None:
            return "word", []                       # silent OOV -> zero
        nb = int(self.ngrams.shape[0])
        rows = [_fnv1a(g.encode("utf-8")) % nb
                for g in char_ngrams(word, self.n_min, self.n_max)]
        return "ngram", rows

    def embed_words(self, words: list[str]) -> jax.Array:
        """[len(words), D] L2-normalized embeddings (GetEmbedd batch)."""
        out = []
        for w in words:
            kind, rows = self._word_vec_rows(w)
            if not rows:
                out.append(jnp.zeros((self.dim,), jnp.float32))
                continue
            table = self.vectors if kind == "word" else self.ngrams
            v = jnp.mean(table[jnp.asarray(rows)], axis=0)
            out.append(v)
        return l2_normalize(jnp.stack(out))

    def embed_sentences(self, sentences: list[str]) -> jax.Array:
        """Mean-of-words sentence embeddings, L2-normalized [S, D]."""
        embs = [self.embed_words(s.split()) for s in sentences]
        pooled = jnp.stack([jnp.mean(e, axis=0) if e.shape[0] else
                            jnp.zeros((self.dim,)) for e in embs])
        return l2_normalize(pooled)


@partial(jax.jit, static_argnames=())
def embed_ids(table: jax.Array, ids: jax.Array,
              mask: jax.Array) -> jax.Array:
    """Pure-device path: [B, L] token ids + mask -> [B, D] normalized
    mean-pooled embeddings (the jittable core for serving)."""
    v = table[ids]                                           # [B, L, D]
    m = mask[..., None].astype(jnp.float32)
    pooled = jnp.sum(v * m, axis=1) / jnp.maximum(
        jnp.sum(m, axis=1), 1.0)
    return l2_normalize(pooled)
