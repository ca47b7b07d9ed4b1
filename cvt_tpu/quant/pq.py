"""Product quantizer: train / encode / decode / ADC LUTs.

Reference: opq/train_codebook/train_PQ_codebook.cpp — M subquantizers
trained with yael kmeans inside an OpenMP loop over subspaces (:199-244);
encode = nearest codeword per subspace (opq/src/IVFOPQ.cpp:141-163).

Design: the M subspace k-means runs are one `jax.vmap` over the
subspace axis of cvt_tpu.ops.kmeans (every Lloyd step is a batched
matmul across all subspaces at once); encode is a single batched
nearest-codeword assignment. Decode for the ADC scan is a one-hot
matmul (see cvt_tpu.index.flat_adc) rather than a per-point LUT-gather —
the factorization `onehot(codes) @ codebooks @ q^T` contracted decode-first
costs 2*K*D per row instead of the CPU LUT loop's M adds + random gathers,
and rides the systolic array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops.kmeans import _init_random, _lloyd, kmeans_assign


@dataclass
class ProductQuantizer:
    """PQ with M subspaces x K codewords (K <= 256, codes stored uint8)."""

    codebooks: jax.Array   # [M, K, ds] float32

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ds(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.ds

    # ---------------------------------------------------------------- train
    @classmethod
    def train(cls, key, x, m: int, k: int = 256, *, iters: int = 25,
              init_codebooks=None) -> "ProductQuantizer":
        """Train M independent k-means codebooks on x [N, D], D = m*ds.

        `init_codebooks` [M, K, ds] warm-starts Lloyd (used by OPQ's
        alternating optimization).
        """
        x = jnp.asarray(x, jnp.float32)
        n, d = x.shape
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m}")
        xs = x.reshape(n, m, d // m).transpose(1, 0, 2)     # [M, N, ds]
        if init_codebooks is None:
            keys = jax.random.split(key, m)
            c0 = jax.vmap(_init_random, in_axes=(0, 0, None))(keys, xs, k)
        else:
            c0 = jnp.asarray(init_codebooks, jnp.float32)
        c, _, _ = jax.vmap(
            lambda xm, cm: _lloyd(xm, cm, k, iters, None))(xs, c0)
        return cls(codebooks=c)

    # --------------------------------------------------------------- encode
    def encode(self, x) -> jax.Array:
        """x [N, D] -> codes [N, M] uint8 (nearest codeword per subspace)."""
        x = jnp.asarray(x, jnp.float32)
        n = x.shape[0]
        xs = x.reshape(n, self.m, self.ds).transpose(1, 0, 2)   # [M, N, ds]
        assign, _ = jax.vmap(
            lambda xm, cm: kmeans_assign(xm, cm))(xs, self.codebooks)
        return assign.T.astype(jnp.uint8)                       # [N, M]

    def decode(self, codes) -> jax.Array:
        """codes [N, M] uint8 -> reconstruction [N, D]."""
        codes = jnp.asarray(codes).astype(jnp.int32)            # [N, M]
        gathered = jax.vmap(
            lambda cb, cm: cb[cm], in_axes=(0, 1))(self.codebooks, codes)
        return gathered.transpose(1, 0, 2).reshape(codes.shape[0], self.dim)

    # ------------------------------------------------------------------ ADC
    def lut(self, q, metric: str = "l2") -> jax.Array:
        """Per-query ADC tables. q [B, D] -> [B, M, K].

        l2: ||q_m - cb[m,k]||^2 ; ip: -<q_m, cb[m,k]> (smaller = closer).
        Equivalent of the reference's per-probe LUT build
        (opq/src/IVFOPQ.cpp:279-291), batched over queries as one
        [B*M, ds] x [ds, K] contraction via vmap.
        """
        q = jnp.asarray(q, jnp.float32)
        qs = q.reshape(q.shape[0], self.m, self.ds)             # [B, M, ds]
        ip = jnp.einsum("bms,mks->bmk", qs, self.codebooks,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
        if metric == "ip":
            return -ip
        q_sq = jnp.sum(jnp.square(qs), axis=-1)                 # [B, M]
        c_sq = jnp.sum(jnp.square(self.codebooks), axis=-1)     # [M, K]
        return q_sq[:, :, None] - 2.0 * ip + c_sq[None, :, :]

    def adc_scores(self, lut, codes) -> jax.Array:
        """Sum LUT entries for given codes. lut [B, M, K], codes [C, M]
        -> [B, C]. Reference inner loop IVFOPQ.cpp:300-309, via gather."""
        codes = jnp.asarray(codes).astype(jnp.int32)
        # [B, M, C] gather then sum over M.
        g = jnp.take_along_axis(
            lut, codes.T[None, :, :].repeat(lut.shape[0], axis=0), axis=2)
        return jnp.sum(g, axis=1)

    def codeword_sqnorms(self) -> jax.Array:
        """[M, K] squared norms of codewords (for ||decode||^2 terms)."""
        return jnp.sum(jnp.square(self.codebooks), axis=-1)

    def reconstruction_mse(self, x) -> jax.Array:
        x = jnp.asarray(x, jnp.float32)
        rec = self.decode(self.encode(x))
        return jnp.mean(jnp.sum(jnp.square(x - rec), axis=-1))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, codebooks=np.asarray(self.codebooks))

    @classmethod
    def load(cls, path: str) -> "ProductQuantizer":
        z = np.load(path, allow_pickle=False)
        return cls(codebooks=jnp.asarray(z["codebooks"]))
