"""Gaussian scale-space pyramid + DoG, batched over images.

Reference: VLFeat's covdet scale space (covdet/3rd/VLFeat/vl/scalespace.c,
driven by covdet/vl_covdet.hpp:73-140 with doubleImage=first_octave -1)
and vlindex SIFT options (retrieval/vlindex/src/feature/sift.h:59-84:
first_octave=-1, octave_resolution 3, peak 0.02/3, edge 10).

Batched design: every Gaussian level is a separable depthwise convolution on
a [B, H, W] batch (XLA fuses and tiles these); octaves
are a static Python loop over halving shapes so everything under jit has
fixed shapes. Incremental blurs between levels keep kernels small.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class OctavePyramid(NamedTuple):
    """One octave: gauss [B, S+3, H, W], dog [B, S+2, H, W],
    grad_dx/grad_dy [B, S+3, H, W], octave index (int), step (pixel size
    of this octave in input-image pixels, e.g. 0.5 for octave -1)."""
    gauss: jax.Array
    dog: jax.Array
    grad_dx: jax.Array
    grad_dy: jax.Array
    octave: int
    step: float
    sigmas: tuple  # per-level absolute sigma in input-image pixels


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(x: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur on [B, H, W] with edge-replicate padding."""
    if sigma <= 0:
        return x
    k = _gauss_kernel1d(sigma)
    r = (len(k) - 1) // 2
    kh = jnp.asarray(k).reshape(1, 1, 1, -1)
    x4 = x[:, None, :, :]                                        # [B,1,H,W]
    xp = jnp.pad(x4, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    x4 = jax.lax.conv_general_dilated(
        xp, kh, (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    kv = jnp.asarray(k).reshape(1, 1, -1, 1)
    xp = jnp.pad(x4, ((0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    x4 = jax.lax.conv_general_dilated(
        xp, kv, (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return x4[:, 0]


def _upsample2(x: jax.Array) -> jax.Array:
    b, h, w = x.shape
    return jax.image.resize(x, (b, 2 * h, 2 * w), method="linear")


def _downsample2(x: jax.Array) -> jax.Array:
    return x[:, ::2, ::2]


def _gradients(levels: jax.Array):
    """Central-difference gradients of [B, S, H, W] along W (dx) and H (dy)."""
    dx = 0.5 * (jnp.roll(levels, -1, axis=3) - jnp.roll(levels, 1, axis=3))
    dy = 0.5 * (jnp.roll(levels, -1, axis=2) - jnp.roll(levels, 1, axis=2))
    # zero out the wrapped borders
    dx = dx.at[:, :, :, 0].set(0.0).at[:, :, :, -1].set(0.0)
    dy = dy.at[:, :, 0, :].set(0.0).at[:, :, -1, :].set(0.0)
    return dx, dy


@partial(jax.jit, static_argnames=("n_octaves", "n_scales", "first_octave",
                                   "sigma0", "with_gradients"))
def _build(images, n_octaves, n_scales, first_octave, sigma0,
           with_gradients):
    s = n_scales
    base = images
    if first_octave == -1:
        base = _upsample2(base)
    # assumed input blur 0.5 px (VLFeat convention), scaled by upsampling
    cur_sigma = 0.5 * (2.0 if first_octave == -1 else 1.0)
    tgt = sigma0 * (2.0 ** first_octave) / (2.0 ** first_octave)  # level 0
    # bring base to sigma0 in octave units (octave pixel = 1)
    if sigma0 > cur_sigma:
        base = _blur(base, math.sqrt(sigma0 ** 2 - cur_sigma ** 2))
    octaves = []
    for o in range(n_octaves):
        levels = [base]
        sig_prev = sigma0
        for li in range(1, s + 3):
            sig = sigma0 * (2.0 ** (li / s))
            inc = math.sqrt(max(sig ** 2 - sig_prev ** 2, 1e-12))
            levels.append(_blur(levels[-1], inc))
            sig_prev = sig
        gauss = jnp.stack(levels, axis=1)                        # [B,S+3,H,W]
        dog = gauss[:, 1:] - gauss[:, :-1]                       # [B,S+2,H,W]
        if with_gradients:
            dx, dy = _gradients(gauss)
        else:
            dx = dy = gauss[:, :0]
        octaves.append((gauss, dog, dx, dy))
        base = _downsample2(levels[s])      # sigma doubled at level S
    return octaves


def build_pyramid(images: jax.Array, *, n_scales: int = 3,
                  first_octave: int = -1, sigma0: float = 1.6,
                  max_octaves: int = 8,
                  with_gradients: bool = True) -> list[OctavePyramid]:
    """images [B, H, W] float in [0, 1] -> list of OctavePyramid.

    first_octave=-1 doubles the image first (the reference default,
    vl_covdet.hpp:87 doubleImage / sift.h first_octave=-1).
    """
    images = jnp.asarray(images, jnp.float32)
    b, h, w = images.shape
    size = min(h, w) * (2 if first_octave == -1 else 1)
    n_octaves = 0
    while size >= 16 and n_octaves < max_octaves:
        n_octaves += 1
        size //= 2
    raw = _build(images, n_octaves, n_scales, first_octave, sigma0,
                 with_gradients)
    out = []
    for o, (gauss, dog, dx, dy) in enumerate(raw):
        oct_idx = o + first_octave
        step = 2.0 ** oct_idx
        sigmas = tuple(sigma0 * (2.0 ** (oct_idx + li / n_scales))
                       for li in range(n_scales + 3))
        out.append(OctavePyramid(gauss, dog, dx, dy, oct_idx, step, sigmas))
    return out
