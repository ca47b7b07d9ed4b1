"""Optimized Product Quantization: learned rotation + PQ codebooks.

The reference approximates OPQ with a learned dimension-reorder
permutation (opq/train_codebook/train_PQ_codebook.cpp:14-23,126-141 loads
and applies `reorder`). This module implements the full OPQ
non-parametric algorithm (Ge et al., CVPR'13) that subsumes it: alternate

    1. Y = X @ R                 (rotate)
    2. fit PQ codebooks on Y     (warm-started Lloyd, vmapped over M)
    3. Yhat = decode(encode(Y))
    4. R <- Procrustes: U, _, Vt = svd(X^T Yhat); R = U @ Vt

A permutation matrix is a special orthogonal R, so the reference's reorder
trick is a point in this search space. All heavy steps are matmuls;
the SVD is a one-off [D, D] host-side solve per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.quant.pq import ProductQuantizer


def _procrustes(x, yhat):
    """argmin_R ||x @ R - yhat||_F over orthogonal R: R = U @ Vt of X^T Yhat."""
    m = jnp.matmul(x.T, yhat, preferred_element_type=jnp.float32)
    u, _, vt = jnp.linalg.svd(m, full_matrices=False)
    return jnp.matmul(u, vt)


@dataclass
class OPQ:
    """Rotation R [D, D] + product quantizer over the rotated space."""

    rotation: jax.Array        # [D, D] orthogonal
    pq: ProductQuantizer

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @classmethod
    def train(cls, key, x, m: int, k: int = 256, *, opq_iters: int = 10,
              kmeans_iters: int = 10, final_kmeans_iters: int = 25,
              init: str = "random") -> "OPQ":
        """Alternating OPQ training on x [N, D].

        init: 'random' (QR of a Gaussian — a random rotation) or
        'identity' (plain PQ as the starting point).
        """
        x = jnp.asarray(x, jnp.float32)
        d = x.shape[1]
        key, kinit, kpq = jax.random.split(key, 3)
        if init == "random":
            g = jax.random.normal(kinit, (d, d))
            r, _ = jnp.linalg.qr(g)
        elif init == "identity":
            r = jnp.eye(d)
        else:
            raise ValueError(f"unknown init {init!r}")

        pq = None
        for it in range(opq_iters):
            y = jnp.matmul(x, r, preferred_element_type=jnp.float32)
            pq = ProductQuantizer.train(
                kpq, y, m, k, iters=kmeans_iters,
                init_codebooks=None if pq is None else pq.codebooks)
            yhat = pq.decode(pq.encode(y))
            r = _procrustes(x, yhat)
        # Final refinement of codebooks at the converged rotation.
        y = jnp.matmul(x, r, preferred_element_type=jnp.float32)
        pq = ProductQuantizer.train(
            kpq, y, m, k, iters=final_kmeans_iters,
            init_codebooks=pq.codebooks if pq is not None else None)
        return cls(rotation=r, pq=pq)

    def rotate(self, x) -> jax.Array:
        return jnp.matmul(jnp.asarray(x, jnp.float32), self.rotation,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def encode(self, x) -> jax.Array:
        """x [N, D] raw space -> codes [N, M] uint8."""
        return self.pq.encode(self.rotate(x))

    def decode(self, codes) -> jax.Array:
        """codes -> reconstruction in the ORIGINAL space (R is orthogonal,
        so decode(c) @ R^T inverts the rotation)."""
        return jnp.matmul(self.pq.decode(codes), self.rotation.T,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def lut(self, q, metric: str = "l2") -> jax.Array:
        """ADC tables for raw-space queries (rotation folded into q —
        L2/IP are rotation-invariant so scores match raw-space distances)."""
        return self.pq.lut(self.rotate(q), metric)

    def reconstruction_mse(self, x) -> jax.Array:
        x = jnp.asarray(x, jnp.float32)
        rec = self.decode(self.encode(x))
        return jnp.mean(jnp.sum(jnp.square(x - rec), axis=-1))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, rotation=np.asarray(self.rotation),
                 codebooks=np.asarray(self.pq.codebooks))

    @classmethod
    def load(cls, path: str) -> "OPQ":
        z = np.load(path, allow_pickle=False)
        return cls(rotation=jnp.asarray(z["rotation"]),
                   pq=ProductQuantizer(jnp.asarray(z["codebooks"])))
