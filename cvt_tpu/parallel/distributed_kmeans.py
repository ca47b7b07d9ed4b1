"""Data-parallel k-means over a device mesh.

The reference trains its K=8192 coarse codebook with 64 OpenMP threads on
one box (opq/train_codebook/train_PQ_codebook.cpp:157-164). Here one
Lloyd step runs data-parallel over the mesh 'dp' axis: every device
assigns its shard of the training set (one matmul), computes partial
one-hot sums/counts, and a psum over 'dp' reduces them — the replacement
for the OpenMP reduction, which XLA lowers to an NCCL all-reduce.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _local_step(x, centroids, *, axis: str):
    """x: local shard [n_local, D]; centroids replicated [K, D].
    Returns (new_centroids [K, D], mean objective) — both replicated."""
    k = centroids.shape[0]
    c_sq = jnp.sum(jnp.square(centroids), axis=-1)
    d = (jnp.sum(jnp.square(x), axis=-1, keepdims=True)
         - 2.0 * jnp.matmul(x, centroids.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
         + c_sq[None, :])
    assign = jnp.argmin(d, axis=-1)
    best = jnp.maximum(
        jnp.take_along_axis(d, assign[:, None], axis=-1)[:, 0], 0.0)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
    sums = jnp.matmul(onehot.T, x, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    counts = jnp.sum(onehot, axis=0)
    # reduce partial sums across the data-parallel axis
    sums = jax.lax.psum(sums, axis)
    counts = jax.lax.psum(counts, axis)
    obj = jax.lax.psum(jnp.sum(best), axis)
    total = jax.lax.psum(jnp.asarray(x.shape[0], jnp.float32), axis)
    new_c = sums / jnp.maximum(counts, 1.0)[:, None]
    # keep empty centroids in place (repair is a host-level concern here)
    new_c = jnp.where((counts < 0.5)[:, None], centroids, new_c)
    return new_c, obj / total


def sharded_kmeans_step(mesh: Mesh, x, centroids, *, axis: str = "dp"):
    """One jitted data-parallel Lloyd step.

    x must be sharded [N, D] along `axis`; centroids replicated.
    Returns (new_centroids, mean_sq_dist), both replicated.
    """
    fn = jax.shard_map(
        partial(_local_step, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)(x, centroids)
