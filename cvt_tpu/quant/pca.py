"""PCA dimensionality reduction (train + project).

Reference: pca_train_project/ — OpenCV `cv::PCA` training on id+CSV
feature lines (train/src/train.cpp:30-63, e.g. 2048->256), a YAML model
{mean, eigenvectors}, online projection `PCAUtils::reduceDim`
(pca_online/pca_utils.h:11-37) and the Python path `cv2.PCAProject` +
L2 norm (py/pca_compute.py:41-45).

Batched design: covariance via one [D, N]x[N, D] matmul, `jnp.linalg.eigh`
for the eigenbasis, projection as a single matmul. Optional whitening goes
beyond the reference (commonly paired with PCA in CBIR pipelines).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops.linalg import l2_normalize


@dataclass
class PCA:
    mean: jax.Array          # [D]
    components: jax.Array    # [out_dim, D] rows = top eigenvectors
    eigenvalues: jax.Array   # [out_dim]
    whiten: bool = False

    @property
    def in_dim(self) -> int:
        return self.components.shape[1]

    @property
    def out_dim(self) -> int:
        return self.components.shape[0]

    @classmethod
    def train(cls, x, out_dim: int, *, whiten: bool = False) -> "PCA":
        """Fit on x [N, D], keeping the top `out_dim` principal axes."""
        x = jnp.asarray(x, jnp.float32)
        mean = jnp.mean(x, axis=0)
        xc = x - mean[None, :]
        cov = jnp.matmul(xc.T, xc, preferred_element_type=jnp.float32)
        cov = cov / jnp.maximum(x.shape[0] - 1, 1)
        evals, evecs = jnp.linalg.eigh(cov)      # ascending order
        order = jnp.argsort(-evals)[:out_dim]
        return cls(mean=mean,
                   components=evecs[:, order].T,
                   eigenvalues=jnp.maximum(evals[order], 0.0),
                   whiten=whiten)

    def project(self, x, *, l2norm: bool = False) -> jax.Array:
        """x [..., D] -> [..., out_dim]; l2norm matches the reference's
        post-projection normalization (py/pca_compute.py:41-45)."""
        x = jnp.asarray(x, jnp.float32)
        y = jnp.matmul(x - self.mean, self.components.T,
                       preferred_element_type=jnp.float32)
        if self.whiten:
            y = y * jax.lax.rsqrt(self.eigenvalues + 1e-12)
        return l2_normalize(y) if l2norm else y

    def reconstruct(self, y) -> jax.Array:
        """Back-project [..., out_dim] -> [..., D]."""
        y = jnp.asarray(y, jnp.float32)
        if self.whiten:
            y = y * jnp.sqrt(self.eigenvalues + 1e-12)
        return jnp.matmul(y, self.components,
                          preferred_element_type=jnp.float32) + self.mean

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, mean=np.asarray(self.mean),
                 components=np.asarray(self.components),
                 eigenvalues=np.asarray(self.eigenvalues),
                 whiten=self.whiten)

    @classmethod
    def load(cls, path: str) -> "PCA":
        z = np.load(path, allow_pickle=False)
        return cls(mean=jnp.asarray(z["mean"]),
                   components=jnp.asarray(z["components"]),
                   eigenvalues=jnp.asarray(z["eigenvalues"]),
                   whiten=bool(z["whiten"]))
