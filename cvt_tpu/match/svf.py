"""SVF spatial verification: pairwise consistency + greedy clique.

Reference: correspondence_matching/src/svf.cc — `spaceValidate` checks,
for every PAIR of matches, (1) that the two keypoints' angle differences
agree across images and (2) that the inter-point direction (relative to
the first keypoint's orientation) agrees across images, both within 10
degrees (:37-96); `getInliers` builds the O(n^2) "brother" matrix
(:103-124) and greedily extracts the max-degree quasi-clique (:129-151).

Batched design: the n^2 pairwise tests are one broadcasted tensor expression;
the greedy extraction is a lax.while_loop over masks with the degree
computation as a matrix-vector product. Angle differences here are
wrapped circularly (the reference compares raw degree differences, which
spuriously rejects pairs straddling 0/360 — a deliberate fix, noted for
parity review).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _circ_diff_deg(a, b):
    d = jnp.abs(a - b) % 360.0
    return jnp.minimum(d, 360.0 - d)


@partial(jax.jit, static_argnames=("angle_thresh_deg",))
def svf_inliers(pts1, ang1, pts2, ang2, valid=None, *,
                angle_thresh_deg: float = 10.0):
    """Pairwise-consistency inlier selection over matched keypoints.

    pts1/pts2 [N, 2] matched coordinates; ang1/ang2 [N] keypoint angles
    in RADIANS; valid [N] marks real matches (padded slots False).
    Returns inlier mask [N] bool.
    """
    pts1 = jnp.asarray(pts1, jnp.float32)
    pts2 = jnp.asarray(pts2, jnp.float32)
    a1 = jnp.degrees(jnp.asarray(ang1, jnp.float32))
    a2 = jnp.degrees(jnp.asarray(ang2, jnp.float32))
    n = pts1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)

    # (1) keypoint angle-difference consistency
    dA = a1[:, None] - a1[None, :]
    dB = a2[:, None] - a2[None, :]
    diff1 = _circ_diff_deg(dA, dB)

    # (2) inter-point direction consistency, relative to kp i's angle
    def rel_theta(pts, ang):
        dx = pts[None, :, 0] - pts[:, None, 0]
        dy = pts[None, :, 1] - pts[:, None, 1]
        theta = jnp.degrees(jnp.arctan2(dy, dx))
        return theta - ang[:, None]

    diff2 = _circ_diff_deg(rel_theta(pts1, a1), rel_theta(pts2, a2))

    brother = ((diff1 < angle_thresh_deg) & (diff2 < angle_thresh_deg)
               & valid[:, None] & valid[None, :])
    brother = brother & ~jnp.eye(n, dtype=bool)
    bmat = brother.astype(jnp.float32)

    # greedy max-degree quasi-clique extraction (svf.cc:129-151)
    def cond(state):
        _, _, go = state
        return go

    def body(state):
        active, inliers, _ = state
        deg = jnp.matmul(bmat, active.astype(jnp.float32))
        deg = jnp.where(active, deg, -1.0)
        maxid = jnp.argmax(deg)
        maxv = deg[maxid]
        take = maxv > 0.0
        inliers = inliers.at[maxid].set(inliers[maxid] | take)
        # restrict the active set to the selected node's neighbors
        new_active = active & (bmat[maxid] > 0.0)
        active = jnp.where(take, new_active, jnp.zeros_like(active))
        return active, inliers, take

    active0 = valid
    inl0 = jnp.zeros((n,), bool)
    _, inliers, _ = jax.lax.while_loop(cond, body,
                                       (active0, inl0, jnp.asarray(True)))
    return inliers
