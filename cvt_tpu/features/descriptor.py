"""Orientation assignment + SIFT descriptor, batched over keypoints.

Reference: VLFeat's per-feature patch pipeline as driven by
covdet/vl_covdet.hpp:159-247 (extract orientations, then
`vl_sift_calc_raw_descriptor` on polar gradients) and the classic Lowe
parameters (4x4 spatial bins x 8 orientations, Gaussian window,
0.2 clipping, 512 scaling); RootSIFT from
hnsw_sifts_retrieval/makeSIFTs.cpp:79-95 (L1 -> sqrt -> L2).

Batched design: no per-keypoint loops. Every keypoint samples a FIXED PxP
grid (scaled by its sigma, rotated by its orientation) from its pyramid
level's gradient fields via batched bilinear gathers; histogramming is a
soft one-hot matmul-style scatter. Shapes are [B, K, P, P] throughout —
the fixed-size replacement for VLFeat's per-feature C loops.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

N_ORI_BINS = 36
N_SPATIAL = 4     # 4x4 descriptor grid
N_ORI = 8
DESC_DIM = N_SPATIAL * N_SPATIAL * N_ORI  # 128


def bilinear_sample(img: jax.Array, xs: jax.Array, ys: jax.Array):
    """img [H, W]; xs/ys [...] float coords -> sampled values [...].
    Out-of-bounds clamps (callers mask borders via weights)."""
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _sample_level(stack: jax.Array, level: jax.Array, xs, ys):
    """stack [L, H, W]; level [] int; xs/ys [...] -> values [...].

    Bilinear gather through FLAT indices into the whole stack rather
    than slicing the level image out first: under the per-keypoint
    vmap, a dynamic level slice would materialize one full [H, W]
    image per keypoint ([B*K, H, W] in HBM — 80 GB at the reference's
    max_num_features=8192 operating point on 640x480 input); flat
    gathers keep it at 4 scalars per sample.
    """
    l, h, w = stack.shape
    flat = stack.reshape(-1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    base = level * (h * w) + y0 * w + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


@partial(jax.jit, static_argnames=("n_samples", "n_orientations",
                                   "peak_ratio"))
def assign_orientations_multi(dx, dy, x, y, sigma_oct, level, valid, *,
                              n_samples: int = 16,
                              n_orientations: int = 4,
                              peak_ratio: float = 0.8, affine=None):
    """Up to n_orientations gradient-orientation peaks per keypoint.

    The reference DUPLICATES a feature once per orientation-histogram
    peak >= peak_ratio * max (vl_covdet_extract_orientations,
    covdet/vl_covdet.hpp:174-186; classic vl_sift convention 0.8).
    Returns (angles [B, K, O] radians, ok [B, K, O] bool) — ok[...,0] is
    always the dominant peak; extra slots are valid only where a
    secondary local maximum clears the peak-ratio bar.
    """
    p = n_samples
    o = n_orientations
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))    # [P^2, 2]
    win_r = 3.0 * 1.5

    if affine is None:
        eye = jnp.eye(2, dtype=jnp.float32)
        affine = jnp.broadcast_to(eye, x.shape + (2, 2))

    def per_kp(dxs, dys, xi, yi, si, li, am):
        u = si * win_r * grid[:, 0]
        v = si * win_r * grid[:, 1]
        xs = xi + am[0, 0] * u + am[0, 1] * v
        ys = yi + am[1, 0] * u + am[1, 1] * v
        vx = _sample_level(dxs, li, xs, ys)
        vy = _sample_level(dys, li, xs, ys)
        g1 = am[0, 0] * vx + am[1, 0] * vy    # normalized-frame gradients
        g2 = am[0, 1] * vx + am[1, 1] * vy
        mag = jnp.sqrt(g1 * g1 + g2 * g2)
        ang = jnp.arctan2(g2, g1)
        r2 = (grid[:, 0] ** 2 + grid[:, 1] ** 2) * (win_r ** 2)
        wgt = jnp.exp(-r2 / (2.0 * (1.5 * win_r / 2) ** 2))
        binf = (ang + jnp.pi) / (2 * jnp.pi) * N_ORI_BINS
        b0 = jnp.floor(binf).astype(jnp.int32) % N_ORI_BINS
        fb = binf - jnp.floor(binf)
        contrib = mag * wgt
        w_b = (jax.nn.one_hot(b0, N_ORI_BINS) * (1 - fb)[:, None]
               + jax.nn.one_hot((b0 + 1) % N_ORI_BINS, N_ORI_BINS)
               * fb[:, None])
        hist = contrib @ w_b       # soft-one-hot matmul, not scatters
        for _ in range(2):
            hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
        hmax = jnp.max(hist)
        is_peak = ((hist >= jnp.roll(hist, 1))
                   & (hist >= jnp.roll(hist, -1))
                   & (hist >= peak_ratio * hmax) & (hmax > 0))
        score = jnp.where(is_peak, hist, -1.0)
        vals, bins = jax.lax.top_k(score, o)                     # [O]
        hl = hist[(bins - 1) % N_ORI_BINS]
        hc = hist[bins]
        hr = hist[(bins + 1) % N_ORI_BINS]
        denom = hl - 2 * hc + hr
        off = jnp.where(jnp.abs(denom) > 1e-12,
                        0.5 * (hl - hr) / denom, 0.0)
        off = jnp.clip(off, -0.5, 0.5)
        angs = ((bins + off + 0.5) / N_ORI_BINS) * 2 * jnp.pi - jnp.pi
        ok = vals > 0
        # dominant slot always valid (matches single-orientation path)
        ok = ok.at[0].set(hmax > 0)
        return angs, ok

    f = jax.vmap(jax.vmap(per_kp, in_axes=(None, None, 0, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0))
    angs, ok = f(dx, dy, x, y, sigma_oct, level, affine)
    ok = ok & valid[..., None]
    return jnp.where(ok, angs, 0.0), ok


@partial(jax.jit, static_argnames=("n_samples",))
def assign_orientations(dx, dy, x, y, sigma_oct, level, valid, *,
                        n_samples: int = 16, affine=None):
    """Dominant gradient orientation per keypoint.

    dx/dy [B, L, H, W] gradient fields (octave); x/y [B, K] octave
    coords; sigma_oct [B, K] scale in octave pixels; level [B, K] int32.
    Returns angle [B, K] in radians.
    """
    p = n_samples
    # fixed sample grid in units of sigma (window radius 3*1.5*sigma)
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))    # [P^2, 2]
    win_r = 3.0 * 1.5

    if affine is None:
        eye = jnp.eye(2, dtype=jnp.float32)
        affine = jnp.broadcast_to(eye, x.shape + (2, 2))

    def per_kp(dxs, dys, xi, yi, si, li, am):
        u = si * win_r * grid[:, 0]
        v = si * win_r * grid[:, 1]
        xs = xi + am[0, 0] * u + am[0, 1] * v
        ys = yi + am[1, 0] * u + am[1, 1] * v
        vx = _sample_level(dxs, li, xs, ys)
        vy = _sample_level(dys, li, xs, ys)
        g1 = am[0, 0] * vx + am[1, 0] * vy    # normalized-frame gradients
        g2 = am[0, 1] * vx + am[1, 1] * vy
        mag = jnp.sqrt(g1 * g1 + g2 * g2)
        ang = jnp.arctan2(g2, g1)                                # [-pi, pi]
        r2 = (grid[:, 0] ** 2 + grid[:, 1] ** 2) * (win_r ** 2)
        wgt = jnp.exp(-r2 / (2.0 * (1.5 * win_r / 2) ** 2))
        binf = (ang + jnp.pi) / (2 * jnp.pi) * N_ORI_BINS
        b0 = jnp.floor(binf).astype(jnp.int32) % N_ORI_BINS
        fb = binf - jnp.floor(binf)
        contrib = mag * wgt
        w_b = (jax.nn.one_hot(b0, N_ORI_BINS) * (1 - fb)[:, None]
               + jax.nn.one_hot((b0 + 1) % N_ORI_BINS, N_ORI_BINS)
               * fb[:, None])
        hist = contrib @ w_b       # soft-one-hot matmul, not scatters
        # smooth the histogram (VLFeat smooths 6x; 2 passes suffice here)
        for _ in range(2):
            hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
        bmax = jnp.argmax(hist)
        # parabolic peak interpolation
        hl = hist[(bmax - 1) % N_ORI_BINS]
        hc = hist[bmax]
        hr = hist[(bmax + 1) % N_ORI_BINS]
        denom = hl - 2 * hc + hr
        off = jnp.where(jnp.abs(denom) > 1e-12,
                        0.5 * (hl - hr) / denom, 0.0)
        off = jnp.clip(off, -0.5, 0.5)
        return ((bmax + off + 0.5) / N_ORI_BINS) * 2 * jnp.pi - jnp.pi

    f = jax.vmap(jax.vmap(per_kp, in_axes=(None, None, 0, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0))
    ang = f(dx, dy, x, y, sigma_oct, level, affine)
    return jnp.where(valid, ang, 0.0)


@partial(jax.jit, static_argnames=("n_samples", "magnif"))
def sift_descriptors(dx, dy, x, y, sigma_oct, level, angle, valid, *,
                     n_samples: int = 16, magnif: float = 3.0,
                     affine=None):
    """128-d SIFT descriptors for fixed-size keypoint sets.

    Sampling window spans the 4x4 spatial bins, each of width
    magnif*sigma (Lowe/VLFeat convention). `affine` [B, K, 2, 2]
    (optional, unit-det) warps the sampling grid through the keypoint's
    affine shape — the elliptical-patch sampling of
    vl_covdet_extract_affine_shape-normalized features
    (vl_covdet.hpp:159-173); gradients are pulled back through the same
    transform (grad of the warped patch = (R A)^T grad image). Returns
    [B, K, 128] float32, L2-normalized with 0.2 clipping.
    """
    p = n_samples
    half = N_SPATIAL / 2.0                 # bin units
    lin = np.linspace(-half + half / p, half - half / p, p,
                      dtype=np.float32)    # bin-space sample centers
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))    # [P^2, 2]
    # precompute spatial soft-assign weights to the 4x4 bins
    bin_centers = jnp.asarray(
        np.arange(N_SPATIAL, dtype=np.float32) - (N_SPATIAL - 1) / 2.0)
    if affine is None:
        eye = jnp.eye(2, dtype=jnp.float32)
        affine = jnp.broadcast_to(eye, x.shape + (2, 2))

    def per_kp(dxs, dys, xi, yi, si, li, ai, am):
        ca, sa = jnp.cos(ai), jnp.sin(ai)
        bw = magnif * si                   # bin width in octave pixels
        # full patch->image map: R(angle) @ A, scaled by the bin width
        rot = jnp.stack([jnp.stack([ca, -sa]), jnp.stack([sa, ca])])
        full = rot @ am                                          # [2, 2]
        u = grid[:, 0] * bw
        v = grid[:, 1] * bw
        xs = xi + full[0, 0] * u + full[0, 1] * v
        ys = yi + full[1, 0] * u + full[1, 1] * v
        vx = _sample_level(dxs, li, xs, ys)
        vy = _sample_level(dys, li, xs, ys)
        # gradients in patch coordinates: g' = full^T g
        g1 = full[0, 0] * vx + full[1, 0] * vy
        g2 = full[0, 1] * vx + full[1, 1] * vy
        mag = jnp.sqrt(g1 * g1 + g2 * g2)
        ang = jnp.arctan2(g2, g1)
        # Gaussian window over the descriptor support
        r2 = grid[:, 0] ** 2 + grid[:, 1] ** 2
        wgt = jnp.exp(-r2 / (2.0 * (half ** 2)))
        contrib = mag * wgt                                       # [P^2]
        # spatial soft-assignment (hat function per bin axis)
        dxb = jnp.abs(grid[:, 0, None] - bin_centers[None, :])    # [P^2, 4]
        dyb = jnp.abs(grid[:, 1, None] - bin_centers[None, :])
        wxb = jnp.maximum(0.0, 1.0 - dxb)
        wyb = jnp.maximum(0.0, 1.0 - dyb)
        # orientation soft-assignment into 8 bins
        obinf = (ang % (2 * jnp.pi)) / (2 * jnp.pi) * N_ORI
        o0 = jnp.floor(obinf).astype(jnp.int32) % N_ORI
        fo = obinf - jnp.floor(obinf)
        w_o = (jax.nn.one_hot(o0, N_ORI) * (1 - fo)[:, None]
               + jax.nn.one_hot((o0 + 1) % N_ORI, N_ORI) * fo[:, None])
        # accumulate: [P^2] x [P^2,4] x [P^2,4] x [P^2,8] -> [4,4,8]
        d = jnp.einsum("p,py,px,po->yxo", contrib, wyb, wxb, w_o)
        d = d.reshape(-1)
        # normalize -> clip 0.2 -> renormalize (Lowe)
        d = d * jax.lax.rsqrt(jnp.sum(d * d) + 1e-12)
        d = jnp.minimum(d, 0.2)
        d = d * jax.lax.rsqrt(jnp.sum(d * d) + 1e-12)
        return d

    f = jax.vmap(jax.vmap(per_kp, in_axes=(None, None, 0, 0, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0))
    desc = f(dx, dy, x, y, sigma_oct, level, angle, affine)
    return jnp.where(valid[..., None], desc, 0.0)


def _flat_sampler_pair(base_arr, h_arr, w_arr):
    """Paired bilinear sampler over an INTERLEAVED (dx, dy) flat stack
    gf [2*F] with gf[2f] = dx[f], gf[2f+1] = dy[f].

    Each bilinear row is ONE contiguous 4-element gather
    (dx00, dy00, dx01, dy01) instead of four scalar gathers — gather
    are the hottest op of orientation/descriptor sampling, and
    contiguous slices cut their count 4x while moving the same bytes."""
    def sample(gf, oct_i, li, xs, ys):
        hv = h_arr[oct_i]
        wv = w_arr[oct_i]
        x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, wv - 2)
        y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, hv - 2)
        fx = jnp.clip(xs - x0, 0.0, 1.0)
        fy = jnp.clip(ys - y0, 0.0, 1.0)
        base = base_arr[oct_i] + li * (hv * wv) + y0 * wv + x0
        row0 = jax.vmap(
            lambda i: jax.lax.dynamic_slice(gf, (2 * i,), (4,)))(base)
        row1 = jax.vmap(
            lambda i: jax.lax.dynamic_slice(gf, (2 * (i + wv),),
                                            (4,)))(base)
        fx1 = fx[:, None]
        top = (1 - fx1) * row0[:, 0:2] + fx1 * row0[:, 2:4]   # [P^2, 2]
        bot = (1 - fx1) * row1[:, 0:2] + fx1 * row1[:, 2:4]
        v = (1 - fy[:, None]) * top + fy[:, None] * bot
        return v[:, 0], v[:, 1]                               # (vx, vy)
    return sample


def _orientation_peaks(g1, g2, wgt, n_orientations: int,
                       peak_ratio: float):
    """Shared orientation-histogram peak logic: sampled normalized-frame
    gradients [P^2] -> (angles [O], ok [O]).

    The 36-bin accumulation is a soft-one-hot [P^2, 36] matmul rather
    than 2*P^2 scatter-adds — per-keypoint scatters serialize on
    colliding bins (the descriptor accumulation uses the same
    formulation)."""
    o = n_orientations
    mag = jnp.sqrt(g1 * g1 + g2 * g2)
    ang = jnp.arctan2(g2, g1)
    binf = (ang + jnp.pi) / (2 * jnp.pi) * N_ORI_BINS
    b0 = jnp.floor(binf).astype(jnp.int32) % N_ORI_BINS
    fb = binf - jnp.floor(binf)
    contrib = mag * wgt
    w_b = (jax.nn.one_hot(b0, N_ORI_BINS) * (1 - fb)[:, None]
           + jax.nn.one_hot((b0 + 1) % N_ORI_BINS, N_ORI_BINS)
           * fb[:, None])                                  # [P^2, 36]
    hist = contrib @ w_b
    for _ in range(2):
        hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
    hmax = jnp.max(hist)
    is_peak = ((hist >= jnp.roll(hist, 1))
               & (hist >= jnp.roll(hist, -1))
               & (hist >= peak_ratio * hmax) & (hmax > 0))
    score = jnp.where(is_peak, hist, -1.0)
    vals, bins = jax.lax.top_k(score, o)
    hl = hist[(bins - 1) % N_ORI_BINS]
    hc = hist[bins]
    hr = hist[(bins + 1) % N_ORI_BINS]
    denom = hl - 2 * hc + hr
    off = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    off = jnp.clip(off, -0.5, 0.5)
    angs = ((bins + off + 0.5) / N_ORI_BINS) * 2 * jnp.pi - jnp.pi
    ok = vals > 0
    ok = ok.at[0].set(hmax > 0)
    return angs, ok


@partial(jax.jit, static_argnames=("n_samples", "n_orientations",
                                   "peak_ratio"))
def assign_orientations_multi_flat(gf, base_arr, h_arr, w_arr,
                                   oct_i, x, y, sigma_oct, level, valid,
                                   *, n_samples: int = 16,
                                   n_orientations: int = 4,
                                   peak_ratio: float = 0.8, affine=None):
    """assign_orientations_multi over a flat multi-octave stack:
    gf [B, 2F] INTERLEAVED (dx, dy) gradients; oct_i [B, K] int32
    octave ids; x/y/sigma_oct in OCTAVE-LOCAL pixels. Same math as the
    per-octave version."""
    p = n_samples
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))
    win_r = 3.0 * 1.5
    r2 = (grid[:, 0] ** 2 + grid[:, 1] ** 2) * (win_r ** 2)
    wgt = jnp.exp(-r2 / (2.0 * (1.5 * win_r / 2) ** 2))
    sample = _flat_sampler_pair(base_arr, h_arr, w_arr)
    if affine is None:
        eye = jnp.eye(2, dtype=jnp.float32)
        affine = jnp.broadcast_to(eye, x.shape + (2, 2))

    def per_kp(gfs, oi, xi, yi, si, li, am):
        u = si * win_r * grid[:, 0]
        v = si * win_r * grid[:, 1]
        xs = xi + am[0, 0] * u + am[0, 1] * v
        ys = yi + am[1, 0] * u + am[1, 1] * v
        vx, vy = sample(gfs, oi, li, xs, ys)
        g1 = am[0, 0] * vx + am[1, 0] * vy
        g2 = am[0, 1] * vx + am[1, 1] * vy
        return _orientation_peaks(g1, g2, wgt, n_orientations, peak_ratio)

    f = jax.vmap(jax.vmap(per_kp,
                          in_axes=(None, 0, 0, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0))
    angs, ok = f(gf, oct_i, x, y, sigma_oct, level, affine)
    ok = ok & valid[..., None]
    return jnp.where(ok, angs, 0.0), ok


@partial(jax.jit, static_argnames=("n_samples", "magnif"))
def sift_descriptors_flat(gf, base_arr, h_arr, w_arr, oct_i,
                          x, y, sigma_oct, level, angle, valid, *,
                          n_samples: int = 16, magnif: float = 3.0,
                          affine=None):
    """sift_descriptors over a flat multi-octave stack (see
    assign_orientations_multi_flat). The spatial soft-assignment weights
    are STATIC (fixed sample grid), so the [4,4,8] accumulation is one
    [16, P^2] x [P^2, 8] matmul per keypoint."""
    p = n_samples
    half = N_SPATIAL / 2.0
    lin = np.linspace(-half + half / p, half - half / p, p,
                      dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))
    bin_centers = (np.arange(N_SPATIAL, dtype=np.float32)
                   - (N_SPATIAL - 1) / 2.0)
    # static spatial weights [16, P^2]: hat(y-bin) * hat(x-bin)
    gxn = np.stack([gx.ravel()] * N_SPATIAL, 0)
    wxb = np.maximum(0.0, 1.0 - np.abs(gxn - bin_centers[:, None]))
    gyn = np.stack([gy.ravel()] * N_SPATIAL, 0)
    wyb = np.maximum(0.0, 1.0 - np.abs(gyn - bin_centers[:, None]))
    w_spatial = jnp.asarray(
        (wyb[:, None, :] * wxb[None, :, :]).reshape(16, -1))  # [16, P^2]
    r2 = grid[:, 0] ** 2 + grid[:, 1] ** 2
    wgt_gauss = jnp.exp(-r2 / (2.0 * (half ** 2)))
    sample = _flat_sampler_pair(base_arr, h_arr, w_arr)
    if affine is None:
        eye = jnp.eye(2, dtype=jnp.float32)
        affine = jnp.broadcast_to(eye, x.shape + (2, 2))

    def per_kp(gfs, oi, xi, yi, si, li, ai, am):
        ca, sa = jnp.cos(ai), jnp.sin(ai)
        bw = magnif * si
        rot = jnp.stack([jnp.stack([ca, -sa]), jnp.stack([sa, ca])])
        full = rot @ am
        u = grid[:, 0] * bw
        v = grid[:, 1] * bw
        xs = xi + full[0, 0] * u + full[0, 1] * v
        ys = yi + full[1, 0] * u + full[1, 1] * v
        vx, vy = sample(gfs, oi, li, xs, ys)
        g1 = full[0, 0] * vx + full[1, 0] * vy
        g2 = full[0, 1] * vx + full[1, 1] * vy
        mag = jnp.sqrt(g1 * g1 + g2 * g2)
        ang = jnp.arctan2(g2, g1)
        contrib = mag * wgt_gauss
        obinf = (ang % (2 * jnp.pi)) / (2 * jnp.pi) * N_ORI
        o0 = jnp.floor(obinf).astype(jnp.int32) % N_ORI
        fo = obinf - jnp.floor(obinf)
        w_o = (jax.nn.one_hot(o0, N_ORI) * (1 - fo)[:, None]
               + jax.nn.one_hot((o0 + 1) % N_ORI, N_ORI) * fo[:, None])
        t = contrib[:, None] * w_o                    # [P^2, 8]
        d = (w_spatial @ t).reshape(-1)               # [16,P^2]x[P^2,8]
        d = d * jax.lax.rsqrt(jnp.sum(d * d) + 1e-12)
        d = jnp.minimum(d, 0.2)
        d = d * jax.lax.rsqrt(jnp.sum(d * d) + 1e-12)
        return d

    f = jax.vmap(jax.vmap(per_kp,
                          in_axes=(None, 0, 0, 0, 0, 0, 0, 0)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0))
    desc = f(gf, oct_i, x, y, sigma_oct, level, angle, affine)
    return jnp.where(valid[..., None], desc, 0.0)


def root_sift(desc: jax.Array, eps: float = 1e-12) -> jax.Array:
    """RootSIFT: L1-normalize, sqrt, (already unit-L2 afterwards).
    Matches hnsw_sifts_retrieval/makeSIFTs.cpp:79-95."""
    l1 = jnp.sum(jnp.abs(desc), axis=-1, keepdims=True)
    return jnp.sqrt(desc / (l1 + eps))
