"""LSD-style line segment detector, batched.

Reference: the vendored LSD library (retrieval/vlindex/lib/LSD/ — the
von Gioi et al. "LSD: a Line Segment Detector" TPAMI'10 / IPOL'12
algorithm): Gaussian downscale -> level-line field (gradient angle) ->
region growing of aligned pixels -> rectangle approximation -> NFA
(number of false alarms) validation.

Redesign — the reference's sequential region growing (one
seed at a time, pixels visited in gradient-magnitude order) is replaced
by a BATCHED connected-component pass over the whole aligned-pixel
field:

  * level-line angles + magnitudes from 2x2 difference stencils (one
    fused elementwise program, batched over images);
  * aligned-pixel components via iterative min-label propagation with
    pointer jumping (each step: 8-neighbor min over label maps gated by
    pairwise angle alignment, then one label=label[label] gather hop —
    O(log diameter) steps instead of the reference's per-pixel queue);
  * per-component rectangle moments via scatter-add (segment-sum over
    the label map): weighted center, principal axis from the 2x2
    second-moment eigenvector, length/width from axis-projected pixel
    extents — matching the reference's region2rect moments;
  * NFA validation in the log domain (lgamma binomial tail) with the
    same (N*M)^{5/2} trial count and p = tau/pi.

Deviations (documented): pixels join a component when mutually aligned
within tau of EACH OTHER (the reference compares against the running
region angle — unavailable in a parallel pass; for straight segments
the two criteria agree), and there is no per-rectangle refinement loop
(NFA simply rejects weak rectangles).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

_NO_LABEL = jnp.int32(2 ** 30)


class LineSegments(NamedTuple):
    """segments [B, L, 4] = (x1, y1, x2, y2) in pixels; width [B, L];
    angle [B, L] radians; nfa [B, L] -log10(NFA) (bigger = more
    significant); valid [B, L] bool."""
    segments: jax.Array
    width: jax.Array
    angle: jax.Array
    nfa: jax.Array
    valid: jax.Array


def _level_lines(img):
    """2x2 stencil gradients (LSD's ll_angle): returns (angle of the
    level line, gradient magnitude)."""
    # g(x,y) over the 2x2 corner neighborhood
    a = img
    b = jnp.roll(img, -1, axis=-1)     # x+1
    c = jnp.roll(img, -1, axis=-2)     # y+1
    d = jnp.roll(jnp.roll(img, -1, axis=-2), -1, axis=-1)
    gx = 0.5 * ((b - a) + (d - c))
    gy = 0.5 * ((c - a) + (d - b))
    mag = jnp.sqrt(gx * gx + gy * gy)
    # the roll-based stencil wraps at the last row/column (opposite-edge
    # differences would fabricate high-NFA border segments); mark them
    # unusable like the reference's NOTDEF border (lsd.c ll_angle)
    mag = mag.at[..., -1].set(0.0).at[..., -1, :].set(0.0)
    # level-line angle is perpendicular to the gradient
    ang = jnp.arctan2(gx, -gy)
    return ang, mag


def _angle_diff(a, b):
    """Smallest difference of undirected line angles (mod pi)."""
    d = jnp.abs(a - b) % jnp.pi
    return jnp.minimum(d, jnp.pi - d)


def _shift(x, dy, dx, fill):
    out = x
    if dy:
        out = jnp.roll(out, dy, axis=-2)
        edge = (slice(None), slice(0, dy) if dy > 0
                else slice(dy, None), slice(None))
        out = out.at[edge].set(fill)
    if dx:
        out = jnp.roll(out, dx, axis=-1)
        edge = (slice(None), slice(None),
                slice(0, dx) if dx > 0 else slice(dx, None))
        out = out.at[edge].set(fill)
    return out


@partial(jax.jit, static_argnames=("max_segments", "grad_threshold",
                                   "tau_deg", "min_pixels", "nfa_eps"))
def detect_line_segments(images, *, max_segments: int = 128,
                         grad_threshold: float = 0.02,
                         tau_deg: float = 22.5,
                         min_pixels: int = 16,
                         nfa_eps: float = 0.0) -> LineSegments:
    """images [B, H, W] float in [0, 1] -> LineSegments.

    grad_threshold: minimum gradient magnitude for a pixel to be usable
    (the reference's rho = 2/sin(tau) quantization bound, expressed on
    [0,1] images). nfa_eps: keep segments with -log10(NFA) > nfa_eps
    (the reference's log_eps, default 0).
    """
    images = jnp.asarray(images, jnp.float32)
    if images.ndim == 2:
        images = images[None]
    b, h, w = images.shape
    tau = jnp.float32(np.deg2rad(tau_deg))
    ang, mag = _level_lines(images)
    usable = mag > grad_threshold

    # ---- connected components of mutually aligned pixels --------------
    flat_idx = (jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1) * w
                + jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2))
    labels = jnp.where(usable, flat_idx, _NO_LABEL)
    neigh = ((0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1))

    def step(state):
        labels, _ = state
        new = labels
        for dy, dx in neigh:
            n_lab = _shift(labels, dy, dx, _NO_LABEL)
            n_ang = _shift(ang, dy, dx, jnp.float32(0))
            n_ok = _shift(usable, dy, dx, False)
            join = usable & n_ok & (_angle_diff(ang, n_ang) < tau)
            new = jnp.where(join, jnp.minimum(new, n_lab), new)
        # pointer jumping: hop to the label's label (path halving)
        hop = jnp.take_along_axis(
            new.reshape(b, -1),
            jnp.clip(new.reshape(b, -1), 0, h * w - 1), axis=1
        ).reshape(b, h, w)
        hop = jnp.where(new < _NO_LABEL, jnp.minimum(new, hop), new)
        return hop, jnp.any(hop != labels)

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(
        lambda s: s[1], lambda s: step(s),
        (labels, jnp.bool_(True)))
    # (the while_loop converges by label monotonicity: every step can
    # only lower labels, and a fixed point stops the loop)

    # ---- per-component moments via scatter-add ------------------------
    lab_flat = jnp.clip(labels.reshape(b, -1), 0, h * w - 1)
    on = (labels < _NO_LABEL).reshape(b, -1).astype(jnp.float32)
    wgt = (mag.reshape(b, -1) * on)
    xs = (flat_idx % w).reshape(b, -1).astype(jnp.float32)
    ys = (flat_idx // w).reshape(b, -1).astype(jnp.float32)

    def seg_sum(vals):
        return jax.vmap(
            lambda lf, v: jnp.zeros((h * w,), jnp.float32).at[lf].add(v)
        )(lab_flat, vals)

    cnt = seg_sum(on)                          # pixels per component
    sw = seg_sum(wgt)
    sx = seg_sum(wgt * xs)
    sy = seg_sum(wgt * ys)
    sxx = seg_sum(wgt * xs * xs)
    syy = seg_sum(wgt * ys * ys)
    sxy = seg_sum(wgt * xs * ys)

    # top components by pixel count (clamped to the candidate count
    # for tiny images, detect_octave-style)
    score = jnp.where(cnt >= min_pixels, cnt, 0.0)
    k_eff = min(max_segments, score.shape[1])
    top_c, comp = jax.lax.top_k(score, k_eff)            # [B, L]
    if k_eff < max_segments:
        pad = max_segments - k_eff
        top_c = jnp.pad(top_c, ((0, 0), (0, pad)))
        comp = jnp.pad(comp, ((0, 0), (0, pad)))
    take = lambda a: jnp.take_along_axis(a, comp, axis=1)
    n_pix = take(cnt)
    swc, sxc, syc = take(sw), take(sx), take(sy)
    swc_safe = jnp.maximum(swc, 1e-9)
    cx = sxc / swc_safe
    cy = syc / swc_safe
    # second moments about the center (region2rect)
    mxx = take(sxx) / swc_safe - cx * cx
    myy = take(syy) / swc_safe - cy * cy
    mxy = take(sxy) / swc_safe - cx * cy
    # principal axis angle of the smallest-eigenvalue-normal direction
    theta = 0.5 * jnp.arctan2(2.0 * mxy, mxx - myy)
    lam = jnp.sqrt(jnp.maximum(
        0.25 * (mxx - myy) ** 2 + mxy ** 2, 0.0))
    half = 0.5 * (mxx + myy)
    l_var = half + lam                       # along-axis variance
    w_var = jnp.maximum(half - lam, 0.0)     # across-axis variance
    length = 2.0 * jnp.sqrt(jnp.maximum(3.0 * l_var, 0.0))
    width = jnp.maximum(2.0 * jnp.sqrt(jnp.maximum(3.0 * w_var, 0.0)),
                        1.0)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    x1 = cx - 0.5 * length * ct
    y1 = cy - 0.5 * length * st
    x2 = cx + 0.5 * length * ct
    y2 = cy + 0.5 * length * st

    # ---- NFA validation (log domain) ----------------------------------
    # rectangle trial count (N*M)^{5/2} * 11 orientations; aligned
    # points k = component size, total n = rectangle area
    p = jnp.float32(tau_deg / 180.0)
    n_rect = jnp.maximum(length * width, n_pix)
    k = n_pix

    def log_binom_tail(n, k, p):
        # log10 of P[Bin(n, p) >= k] upper bound via the largest term
        # times (n - k + 1) (the reference uses the same hoeffding-style
        # term bound inside nfa())
        n = jnp.maximum(n, k)
        log_c = (jax.lax.lgamma(n + 1.0) - jax.lax.lgamma(k + 1.0)
                 - jax.lax.lgamma(n - k + 1.0))
        log_term = (log_c + k * jnp.log(p) + (n - k) * jnp.log1p(-p))
        return (log_term + jnp.log(n - k + 1.0)) / jnp.log(10.0)

    log_trials = 2.5 * jnp.log10(jnp.float32(h * w)) + jnp.log10(11.0)
    neg_log_nfa = -(log_trials + log_binom_tail(n_rect, k, p))
    valid = (n_pix >= min_pixels) & (neg_log_nfa > nfa_eps) & (top_c > 0)

    segs = jnp.stack([x1, y1, x2, y2], axis=-1)
    zero = jnp.zeros_like(theta)
    return LineSegments(
        segments=jnp.where(valid[..., None], segs, 0.0),
        width=jnp.where(valid, width, zero),
        angle=jnp.where(valid, theta, zero),
        nfa=jnp.where(valid, neg_log_nfa, zero),
        valid=valid)
