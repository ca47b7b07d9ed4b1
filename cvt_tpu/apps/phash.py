"""64-bit DCT perceptual hash + Hamming matching.

Reference: image_hash/pHash.hpp — 32x32 grayscale DCT, 8x8 low-frequency
block starting at offset `cons` (0 = normal, 15 = high-frequency variant,
pHash.hpp:21-62), bits = coefficient > mean, popcount Hamming distance
(:84-92), plus a "pure image" detector via dominant-gray-histogram ratio
(:95-119).

Batched design: the DCT is two 32x32 matmuls with the DCT-II basis; hashing
is batched over [B, 32, 32] images. The 64-bit hash is stored as TWO
uint32 words [B, 2] (JAX runs with 32-bit integers by default —
a uint64 would silently truncate); Hamming distance is XOR + popcount
summed over both words.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _dct_basis(n: int = 32) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n] (rows = frequencies)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    b = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    b[0] *= 1.0 / np.sqrt(2.0)
    return (b * np.sqrt(2.0 / n)).astype(np.float32)


_BASIS = jnp.asarray(_dct_basis(32))
_BITS32 = jnp.asarray((1 << np.arange(32, dtype=np.uint32)).astype(np.uint32))


@jax.jit
def phash(images: jax.Array, cons: int = 0) -> jax.Array:
    """images [B, 32, 32] float (any gray scale range) -> uint32 [B, 2]
    (lo word = bits 0..31 over the first 32 coefficients in row-major
    order, hi word = bits 32..63).

    cons: extra offset of the 8x8 coefficient block (reference uses 0,
    or 15 for the high-frequency variant). The block starts at
    (1+cons, 1+cons) — row/col 0 (the DC term and first AC row/col) are
    always skipped (pHash.hpp:35-36), which is what makes the hash
    invariant to global brightness shifts.
    """
    x = jnp.asarray(images, jnp.float32)
    coef = jnp.einsum("ij,bjk,lk->bil", _BASIS, x, _BASIS)       # [B,32,32]
    block = jax.lax.dynamic_slice(
        coef, (0, 1 + cons, 1 + cons), (coef.shape[0], 8, 8))    # [B, 8, 8]
    flat = block.reshape(-1, 64)
    mean = jnp.mean(flat, axis=-1, keepdims=True)
    bits = (flat > mean)
    lo = jnp.sum(jnp.where(bits[:, :32], _BITS32[None, :],
                           jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    hi = jnp.sum(jnp.where(bits[:, 32:], _BITS32[None, :],
                           jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    return jnp.stack([lo, hi], axis=-1)                          # [B, 2]


@jax.jit
def hamming_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """a [N, 2] uint32, b [M, 2] uint32 -> [N, M] int32 popcount(XOR)."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def resize_gray_32(images: jax.Array) -> jax.Array:
    """[B, H, W] gray -> [B, 32, 32] by area-style resize (jax.image)."""
    return jax.image.resize(jnp.asarray(images, jnp.float32),
                            (images.shape[0], 32, 32), method="linear")


def is_pure_image(images: jax.Array, ratio: float = 0.95,
                  bins: int = 64) -> jax.Array:
    """Detect near-constant images: True when the dominant gray histogram
    bin holds more than `ratio` of pixels (pHash.hpp:95-119). images
    [B, H, W] with values in [0, 255]."""
    x = jnp.clip(jnp.asarray(images, jnp.float32), 0.0, 255.0)
    b = (x / (256.0 / bins)).astype(jnp.int32)
    b = jnp.clip(b, 0, bins - 1).reshape(x.shape[0], -1)
    onehot = jax.nn.one_hot(b, bins, dtype=jnp.float32)
    hist = jnp.sum(onehot, axis=1)                               # [B, bins]
    return (jnp.max(hist, axis=-1) / b.shape[1]) > ratio
