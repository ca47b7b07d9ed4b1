"""Absolute / relative pose estimation, fully batched.

Reference: vlindex/src/estimators/ — absolute_pose.{h,cc} (P3PEstimator,
EPNPEstimator), essential_matrix decomposition + chirality
(PoseFromEssentialMatrix in base/pose.cc), triangulation.{h,cc}.

Redesign: no Groebner/Ceres polynomial machinery —
  * P3P uses Grunert's quartic solved in CLOSED FORM (Ferrari +
    Cardano), elementwise ops only, so thousands of minimal problems
    solve as one vectorized call; each problem emits its <=4 candidate
    poses which simply become extra RANSAC hypotheses.
  * PnP refit is a weighted 6+ point DLT (batched SVD) + nearest-
    rotation projection — the LO step.
  * Triangulation is the batched two-view DLT.
All rotations are [..., 3, 3], translations [..., 3], with camera
convention x_cam = R @ x_world + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


# --------------------------------------------------------------------------
# closed-form polynomial roots (elementwise, batch-friendly)
# --------------------------------------------------------------------------

def _cardano_real_root(b, c, d):
    """One real root of z^3 + b z^2 + c z + d, elementwise-batched."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # disc > 0: one real root via cbrt; disc <= 0: three real, trig form
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    root_pos = u + v
    # trigonometric branch (p < 0 guaranteed when disc <= 0)
    pm = jnp.minimum(p, -_EPS)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    root_tri = m * jnp.cos(jnp.arccos(arg) / 3.0)
    return jnp.where(disc > 0, root_pos, root_tri) - b / 3.0


def solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + ... + c0 (Ferrari). Returns (roots [..., 4],
    valid [..., 4]) — invalid entries are NaN-free placeholders."""
    c4s = jnp.where(jnp.abs(c4) < _EPS, _EPS, c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # resolvent cubic: z^3 + 2p z^2 + (p^2 - 4r) z - q^2 = 0, z = m^2 >= 0
    z = _cardano_real_root(2.0 * p, p * p - 4.0 * r, -q * q)
    z = jnp.maximum(z, 0.0)
    m = jnp.sqrt(z)
    safe_m = jnp.maximum(m, _EPS)
    # y^4+py^2+qy+r = (y^2 + m y + (p+z)/2 - q/(2m)) (y^2 - m y + ...)
    t1 = (p + z) / 2.0 - q / (2.0 * safe_m)
    t2 = (p + z) / 2.0 + q / (2.0 * safe_m)
    # quadratic y^2 + m y + t1 = 0 and y^2 - m y + t2 = 0
    d1 = m * m - 4.0 * t1
    d2 = m * m - 4.0 * t2
    s1 = jnp.sqrt(jnp.maximum(d1, 0.0))
    s2 = jnp.sqrt(jnp.maximum(d2, 0.0))
    roots = jnp.stack([(-m + s1) / 2.0, (-m - s1) / 2.0,
                       (m + s2) / 2.0, (m - s2) / 2.0], axis=-1)
    valid = jnp.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], axis=-1)
    return roots - a[..., None] / 4.0, valid


# --------------------------------------------------------------------------
# rigid alignment (Kabsch/Umeyama) and PnP
# --------------------------------------------------------------------------

def kabsch(src: jax.Array, dst: jax.Array,
           weights: jax.Array | None = None):
    """Best R, t with dst ~= R @ src + t. src/dst [..., n, 3].

    Batched SVD Kabsch with reflection fix (Umeyama's det sign).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None] / (
        jnp.sum(weights, axis=-1)[..., None, None] + _EPS)
    mu_s = jnp.sum(src * w, axis=-2, keepdims=True)
    mu_d = jnp.sum(dst * w, axis=-2, keepdims=True)
    cov = jnp.einsum("...ni,...nj->...ij", (dst - mu_d) * w, src - mu_s)
    u, _, vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(jnp.matmul(u, vt))
    s = jnp.ones(cov.shape[:-2] + (3,), cov.dtype).at[..., 2].set(det)
    r = jnp.einsum("...ij,...j,...jk->...ik", u, s, vt)
    t = mu_d[..., 0, :] - jnp.einsum("...ij,...j->...i", r, mu_s[..., 0, :])
    return r, t


def p3p(world: jax.Array, bearings: jax.Array):
    """Grunert P3P. world [..., 3, 3] points, bearings [..., 3, 3] UNIT
    rays in the camera frame. Returns (R [..., 4, 3, 3], t [..., 4, 3],
    valid [..., 4]) — up to 4 candidate poses per problem.
    """
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a2 = jnp.sum((p2 - p3) ** 2, -1)
    b2 = jnp.sum((p1 - p3) ** 2, -1)
    c2 = jnp.sum((p1 - p2) ** 2, -1)
    b2s = jnp.maximum(b2, _EPS)
    ca = jnp.sum(f2 * f3, -1)   # cos(alpha): angle opposite side a
    cb = jnp.sum(f1 * f3, -1)
    cg = jnp.sum(f1 * f2, -1)
    A = (a2 - c2) / b2s
    B = (a2 + c2) / b2s
    C = (b2 - c2) / b2s
    D = (b2 - a2) / b2s
    c4 = (A - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca * ca
    c3 = 4.0 * (A * (1.0 - A) * cb - (1.0 - B) * ca * cg
                + 2.0 * (c2 / b2s) * ca * ca * cb)
    c2_ = 2.0 * (A * A - 1.0 + 2.0 * A * A * cb * cb + 2.0 * C * ca * ca
                 - 4.0 * B * ca * cb * cg + 2.0 * D * cg * cg)
    c1 = 4.0 * (-A * (1.0 + A) * cb + 2.0 * (a2 / b2s) * cg * cg * cb
                - (1.0 - B) * ca * cg)
    c0 = (1.0 + A) ** 2 - 4.0 * (a2 / b2s) * cg * cg
    v, valid = solve_quartic(c4, c3, c2_, c1, c0)         # [..., 4]
    valid &= v > _EPS

    Ae = A[..., None]
    cae, cbe, cge = ca[..., None], cb[..., None], cg[..., None]
    den_u = 2.0 * (cge - v * cae)
    u = ((-1.0 + Ae) * v * v - 2.0 * Ae * cbe * v + 1.0 + Ae) / jnp.where(
        jnp.abs(den_u) < _EPS, _EPS, den_u)
    valid &= u > _EPS
    s1sq = b2s[..., None] / jnp.maximum(
        1.0 + v * v - 2.0 * v * cbe, _EPS)
    s1 = jnp.sqrt(s1sq)
    s2 = u * s1
    s3 = v * s1
    # camera-frame points [..., 4, 3, 3]
    cam = jnp.stack([s1[..., None] * f1[..., None, :],
                     s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], axis=-2)
    wrld = jnp.broadcast_to(world[..., None, :, :], cam.shape)
    r, t = kabsch(wrld, cam)                               # world -> cam
    return r, t, valid


def fit_pnp_dlt(world: jax.Array, image: jax.Array,
                weights: jax.Array | None = None):
    """Weighted 6+ point DLT projection fit, decomposed to (R, t).

    world [..., n, 3], image [..., n, 2] NORMALIZED camera coords.
    The DLT minimizes algebraic error; R is recovered as the nearest
    rotation (SVD) to the left 3x3 block — the LO-refit counterpart of
    COLMAP's EPNPEstimator.
    """
    world = jnp.asarray(world, jnp.float32)
    image = jnp.asarray(image, jnp.float32)
    ones = jnp.ones(world.shape[:-1] + (1,), world.dtype)
    xw = jnp.concatenate([world, ones], axis=-1)           # [..., n, 4]
    x, y = image[..., 0:1], image[..., 1:2]
    zero = jnp.zeros_like(xw)
    r1 = jnp.concatenate([xw, zero, -x * xw], axis=-1)     # [..., n, 12]
    r2 = jnp.concatenate([zero, xw, -y * xw], axis=-1)
    a = jnp.concatenate([r1, r2], axis=-2)                 # [..., 2n, 12]
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=-1)[..., None]
        a = a * w2
    _, _, vt = jnp.linalg.svd(a, full_matrices=False)
    p = vt[..., -1, :].reshape(world.shape[:-2] + (3, 4))
    # sign: points should be in front (positive depth for the centroid)
    ctr = jnp.concatenate([jnp.mean(world, -2),
                           jnp.ones(world.shape[:-2] + (1,))], -1)
    depth = jnp.einsum("...j,...j->...", p[..., 2, :], ctr)
    p = p * jnp.where(depth < 0, -1.0, 1.0)[..., None, None]
    m = p[..., :3]
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(m)) + _EPS)
    m = m / scale[..., None, None]
    u, _, vtm = jnp.linalg.svd(m)
    det = jnp.linalg.det(jnp.matmul(u, vtm))
    s = jnp.ones(m.shape[:-2] + (3,), m.dtype).at[..., 2].set(det)
    r = jnp.einsum("...ij,...j,...jk->...ik", u, s, vtm)
    t = p[..., 3] / scale[..., None]
    return r, t


def project(r, t, world):
    """x_cam = R X + t -> normalized image coords. world [..., n, 3]."""
    cam = jnp.einsum("...ij,...nj->...ni", r, world) + t[..., None, :]
    return cam[..., :2] / jnp.where(
        jnp.abs(cam[..., 2:3]) < _EPS, _EPS, cam[..., 2:3]), cam[..., 2]


def ransac_pnp(key, world, image, valid=None, *, threshold: float = 0.01,
               n_hypotheses: int = 64, min_inliers: int = 6):
    """Absolute-pose RANSAC: P3P minimal solves, all <=4S candidate poses
    scored in parallel, then a weighted-DLT LO refit on the winner.

    world [N, 3]; image [N, 2] normalized coords; threshold in normalized
    units (~pixels/focal). Returns (R, t, inliers [N] bool, n_inliers).
    """
    world = jnp.asarray(world, jnp.float32)
    image = jnp.asarray(image, jnp.float32)
    n = world.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
    _, picks = jax.lax.top_k(g, 3)                         # [S, 3]
    w3 = world[picks]                                      # [S, 3, 3]
    i3 = image[picks]                                      # [S, 3, 2]
    bear = jnp.concatenate([i3, jnp.ones(i3.shape[:-1] + (1,))], -1)
    bear = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)
    r, t, ok = p3p(w3, bear)                               # [S, 4, ...]
    rs = r.reshape(-1, 3, 3)
    ts = t.reshape(-1, 3)
    oks = ok.reshape(-1)
    proj, depth = project(rs, ts, jnp.broadcast_to(
        world, (rs.shape[0], n, 3)))
    res2 = jnp.sum((proj - image[None]) ** 2, axis=-1)
    inl = (res2 < threshold * threshold) & (depth > 0) & valid[None, :]
    support = jnp.where(oks, jnp.sum(inl, -1), -1)
    best = jnp.argmax(support)
    best_inl = inl[best]
    # LO: weighted DLT on the winning inlier set, keep if support grows
    r2_, t2_ = fit_pnp_dlt(world, image, best_inl.astype(jnp.float32))
    proj2, depth2 = project(r2_, t2_, world)
    rr2 = jnp.sum((proj2 - image) ** 2, axis=-1)
    inl2 = (rr2 < threshold * threshold) & (depth2 > 0) & valid
    better = jnp.sum(inl2) >= jnp.sum(best_inl)
    r_out = jnp.where(better, r2_, rs[best])
    t_out = jnp.where(better, t2_, ts[best])
    inliers = jnp.where(better, inl2, best_inl)
    return r_out, t_out, inliers, jnp.sum(inliers).astype(jnp.int32)


# --------------------------------------------------------------------------
# triangulation + essential decomposition (relative pose)
# --------------------------------------------------------------------------

def triangulate_dlt(r1, t1, r2, t2, x1, x2):
    """Two-view linear triangulation. (r_i, t_i) world->cam poses;
    x1/x2 [..., n, 2] normalized coords. Returns world points [..., n, 3].
    """
    p1 = jnp.concatenate([r1, t1[..., :, None]], axis=-1)  # [..., 3, 4]
    p2 = jnp.concatenate([r2, t2[..., :, None]], axis=-1)

    def rows(p, x):
        # x [..., n, 2]; p [..., 3, 4] -> [..., n, 2, 4]
        pe = p[..., None, :, :]
        return jnp.stack([x[..., 0:1] * pe[..., 2, :] - pe[..., 0, :],
                          x[..., 1:2] * pe[..., 2, :] - pe[..., 1, :]],
                         axis=-2)

    a = jnp.concatenate([rows(p1, x1), rows(p2, x2)], axis=-2)  # [...,n,4,4]
    _, _, vt = jnp.linalg.svd(a)
    xh = vt[..., -1, :]
    return xh[..., :3] / jnp.where(
        jnp.abs(xh[..., 3:]) < _EPS, _EPS, xh[..., 3:])


def decompose_essential(e: jax.Array):
    """E -> 4 candidate (R, t): (R1,t), (R1,-t), (R2,t), (R2,-t).
    Returns (r [..., 4, 3, 3], t [..., 4, 3])."""
    u, _, vt = jnp.linalg.svd(e)
    # enforce proper rotations
    u = u * jnp.linalg.det(u)[..., None, None]
    vt = vt * jnp.linalg.det(vt)[..., None, None]
    w = jnp.asarray([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]], e.dtype)
    r1 = jnp.einsum("...ij,jk,...kl->...il", u, w, vt)
    r2 = jnp.einsum("...ij,jk,...kl->...il", u, w.T, vt)
    t = u[..., :, 2]
    r = jnp.stack([r1, r1, r2, r2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return r, ts


def pose_from_essential(e: jax.Array, x1: jax.Array, x2: jax.Array,
                        valid: jax.Array | None = None):
    """Pick the (R, t) among the 4 decompositions with the most points
    passing the chirality test (positive depth in both views).

    x1/x2 [n, 2] normalized coords. Returns (R, t, n_cheiral).
    Reference semantics: base/pose.cc PoseFromEssentialMatrix.
    """
    if valid is None:
        valid = jnp.ones(x1.shape[:-1], bool)
    r4, t4 = decompose_essential(e)                        # [4,3,3], [4,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=e.dtype), r4.shape)
    zero = jnp.zeros_like(t4)
    pts = triangulate_dlt(eye, zero, r4, t4,
                          jnp.broadcast_to(x1, (4,) + x1.shape),
                          jnp.broadcast_to(x2, (4,) + x2.shape))
    z1 = pts[..., 2]
    cam2 = jnp.einsum("...ij,...nj->...ni", r4, pts) + t4[..., None, :]
    z2 = cam2[..., 2]
    good = (z1 > 0) & (z2 > 0) & valid[None, :]
    counts = jnp.sum(good, axis=-1)
    best = jnp.argmax(counts)
    return r4[best], t4[best], counts[best]


# ---------------------------------------------------------------------------
# GP3P: generalized absolute pose (multi-camera rig) from 3 ray-point
# correspondences. Reference: vlindex/src/estimators/
# generalized_absolute_pose.cc (GP3PEstimator: depths along three rays
# with known origins such that pairwise point distances are preserved,
# then rig-from-world alignment).
#
# Batched solver: instead of the reference's Sylvester-resultant
# octic + Eigen companion eigenvalues, the depth lambda_0 of ray 0 is
# found by a BATCHED branch scan — lambda_1(lambda_0) and
# lambda_2(lambda_0) are closed-form quadratic roots (2 branches each),
# the remaining constraint g(lambda_0) is evaluated on a tan-warped
# depth grid for all 4 branch combinations at once, and sign changes
# are refined by fixed-iteration bisection. Fixed shapes, no
# eigendecomposition, vmappable over RANSAC samples.
# ---------------------------------------------------------------------------


def _gp3p_g(lam0, o, d, x, s1, s2):
    """Residual g(lambda_0) for branch signs (s1, s2) in {-1, +1}.

    o, d, x: [3, 3] ray origins, unit directions, world points.
    Returns (g value, lam1, lam2, feasible) — feasible = both inner
    quadratics have real positive roots."""
    d01 = jnp.sum(jnp.square(x[0] - x[1]))
    d02 = jnp.sum(jnp.square(x[0] - x[2]))
    d12 = jnp.sum(jnp.square(x[1] - x[2]))
    p0 = o[0] + lam0[..., None] * d[0]

    def depth(oj, dj, dsq, sgn):
        w = p0 - oj                              # [..., 3]
        b = jnp.sum(w * dj, axis=-1)
        disc = b * b - jnp.sum(w * w, axis=-1) + dsq
        ok = disc >= 0.0
        lam = b + sgn * jnp.sqrt(jnp.maximum(disc, 0.0))
        return lam, ok & (lam > 0.0)

    lam1, ok1 = depth(o[1], d[1], d01, s1)
    lam2, ok2 = depth(o[2], d[2], d02, s2)
    p1 = o[1] + lam1[..., None] * d[1]
    p2 = o[2] + lam2[..., None] * d[2]
    g = jnp.sum(jnp.square(p1 - p2), axis=-1) - d12
    return g, lam1, lam2, ok1 & ok2


def gp3p(origins, directions, points, *, n_grid: int = 128,
         bisect_iters: int = 48):
    """Solve generalized P3P for ONE minimal sample.

    origins/directions [3, 3]: per-correspondence ray origin + unit
    direction in the RIG frame; points [3, 3]: world points. Returns
    (r [S, 3, 3], t [S, 3], ok [S]) with S = 4 branches: world->rig
    transforms p_rig = R x_world + t for every found root (ok masks
    branches with no sign change / infeasible depths). Wrap in vmap for
    batched RANSAC hypotheses.
    """
    o = jnp.asarray(origins, jnp.float32)
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    x = jnp.asarray(points, jnp.float32)

    # depth grid: tan warp concentrates resolution near the scene scale
    # while still covering (0, ~60 * scale)
    scale = jnp.sqrt(jnp.max(jnp.asarray([
        jnp.sum(jnp.square(x[0] - x[1])),
        jnp.sum(jnp.square(x[0] - x[2])),
        jnp.sum(jnp.square(x[1] - x[2]))]))) + \
        jnp.max(jnp.linalg.norm(o - o[0], axis=-1)) + 1e-6
    tt = (jnp.arange(n_grid, dtype=jnp.float32) + 0.5) / n_grid
    grid = scale * jnp.tan(tt * (jnp.pi / 2) * 0.975)      # [G]

    signs = jnp.asarray([[1., 1.], [1., -1.], [-1., 1.], [-1., -1.]])

    def solve_branch(s):
        g, _, _, ok = _gp3p_g(grid, o, d, x, s[0], s[1])
        g = jnp.where(ok, g, jnp.nan)
        flip = (g[:-1] * g[1:] < 0.0)                      # [G-1]
        has = jnp.any(flip)
        i = jnp.argmax(flip)                               # first flip
        lo = jnp.where(has, grid[i], scale)
        hi = jnp.where(has, grid[i + 1], scale * 2)

        def bis(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            gm, _, _, _ = _gp3p_g(mid, o, d, x, s[0], s[1])
            gl, _, _, _ = _gp3p_g(lo, o, d, x, s[0], s[1])
            same = (gm * gl > 0.0)
            return (jnp.where(same, mid, lo),
                    jnp.where(same, hi, mid)), None

        (lo, hi), _ = jax.lax.scan(bis, (lo, hi), None,
                                   length=bisect_iters)
        lam0 = 0.5 * (lo + hi)
        gv, lam1, lam2, okv = _gp3p_g(lam0, o, d, x, s[0], s[1])
        p_rig = jnp.stack([o[0] + lam0 * d[0],
                           o[1] + lam1 * d[1],
                           o[2] + lam2 * d[2]], axis=0)    # [3, 3]
        r, t = kabsch(x, p_rig)
        ok_all = has & okv & (jnp.abs(gv) < 1e-3 * scale * scale)
        return r, t, ok_all

    r, t, ok = jax.vmap(solve_branch)(signs)
    return r, t, ok


def ransac_gp3p(key, origins, directions, points, valid=None, *,
                threshold: float = 0.01, n_hypotheses: int = 128,
                min_inliers: int = 6):
    """Generalized-absolute-pose RANSAC over N ray-point matches.

    origins/directions [N, 3] rig-frame rays; points [N, 3] world.
    Residual: squared angular distance between the observed ray
    direction and the direction to the transformed point (the
    GP3PEstimator cosine residual). Returns (r, t, inliers, n_inliers).
    """
    o = jnp.asarray(origins, jnp.float32)
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    x = jnp.asarray(points, jnp.float32)
    n = x.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)

    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
    _, picks = jax.lax.top_k(g, 3)                         # [S, 3]

    r, t, ok = jax.vmap(lambda p: gp3p(o[p], d[p], x[p]))(picks)
    r = r.reshape(-1, 3, 3)                                # [S*4, 3, 3]
    t = t.reshape(-1, 3)
    ok = ok.reshape(-1)

    # residual: 1 - cos(angle) between d_i and normalize(R x_i + t - o_i)
    px = jnp.einsum("sab,nb->sna", r, x) + t[:, None, :] - o[None, :, :]
    pxn = px / jnp.maximum(jnp.linalg.norm(px, axis=-1, keepdims=True),
                           1e-12)
    res = 1.0 - jnp.sum(pxn * d[None, :, :], axis=-1)      # [S*4, N]
    inl = (res < threshold) & valid[None, :]
    support = jnp.where(ok, jnp.sum(inl, axis=-1), -1)
    best = jnp.argmax(support)
    # no feasible hypothesis, or support below min_inliers: report ZERO
    # inliers so callers can detect failure (the branch-scan fallback
    # pose in r[best] would otherwise look like a valid result)
    good = (support[best] >= 0) & (support[best] >= min_inliers)
    inl_best = inl[best] & good
    return (r[best], t[best], inl_best,
            jnp.sum(inl_best).astype(jnp.int32))


def similarity_transform(src, dst, weights=None):
    """3-D similarity alignment (base/similarity_transform.h — Umeyama):
    returns (scale, R [3,3], t [3]) with dst ~= scale * R src + t.
    Batched over leading axes like kabsch."""
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None] / (
        jnp.sum(weights, axis=-1)[..., None, None] + _EPS)
    mu_s = jnp.sum(src * w, axis=-2, keepdims=True)
    mu_d = jnp.sum(dst * w, axis=-2, keepdims=True)
    r, _ = kabsch(src, dst, weights)
    s0 = src - mu_s
    var_s = jnp.sum(jnp.sum(jnp.square(s0), -1) * weights, -1) / (
        jnp.sum(weights, -1) + _EPS)
    rs = jnp.einsum("...ij,...nj->...ni", r, s0)
    cov = jnp.sum(jnp.sum(rs * (dst - mu_d), -1) * weights, -1) / (
        jnp.sum(weights, -1) + _EPS)
    scale = cov / jnp.maximum(var_s, _EPS)
    t = (mu_d[..., 0, :] - scale[..., None]
         * jnp.einsum("...ij,...j->...i", r, mu_s[..., 0, :]))
    return scale, r, t


# ---------------------------------------------------------------------------
# Generalized relative pose (rig-to-rig). Reference:
# vlindex/src/estimators/generalized_relative_pose.cc (GR6P, Stewenius'
# 64-solution minimal solver via Groebner bases + eigendecomposition).
#
# Batched solver: the LINEAR 17-point formulation (the generalized
# epipolar constraint is linear in the 18 entries of (E, R)):
#     d2^T E d1 + d2^T R m1 + m2^T R d1 = 0
# with Pluecker moments m = o x d. One batched SVD of the [N, 18]
# design matrix gives (E, R) up to scale; R projects to SO(3) by SVD
# and t comes from [t]x = E R^T. No Groebner machinery, vmappable, and
# with RANSAC's redundancy the non-minimal sample costs nothing here.
# ---------------------------------------------------------------------------


def fit_generalized_relative_pose(o1, d1, o2, d2):
    """(R, t) with rig2 = R * rig1 + t from >= 17 ray-ray matches.

    o*/d* [..., n, 3]: ray origins + unit directions in each rig frame.
    Convention: a world point X satisfies, in rig frames,
    x2 = R x1 + t; rays (o_i, d_i) pass through x_i.
    """
    o1 = jnp.asarray(o1, jnp.float32)
    d1 = jnp.asarray(d1, jnp.float32)
    o2 = jnp.asarray(o2, jnp.float32)
    d2 = jnp.asarray(d2, jnp.float32)
    m1 = jnp.cross(o1, d1)
    m2 = jnp.cross(o2, d2)
    # rows: kron terms for  d2^T E d1  (E entries), and
    # d2^T R m1 + m2^T R d1  (R entries)
    e_block = jnp.einsum("...ni,...nj->...nij", d2, d1).reshape(
        *d1.shape[:-1], 9)
    r_block = (jnp.einsum("...ni,...nj->...nij", d2, m1)
               + jnp.einsum("...ni,...nj->...nij", m2, d1)).reshape(
        *d1.shape[:-1], 9)
    a = jnp.concatenate([e_block, r_block], axis=-1)         # [..., n, 18]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    sol = vt[..., -1, :]                                     # [..., 18]
    e = sol[..., :9].reshape(*sol.shape[:-1], 3, 3)
    r_raw = sol[..., 9:].reshape(*sol.shape[:-1], 3, 3)
    # project r_raw to a rotation; fix the global sign so det(+R) = +1
    u, s, vtr = jnp.linalg.svd(r_raw)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", u, vtr))
    # r_raw = sigma * R_true: det(u vt) = sign(sigma), so R_true =
    # sign(sigma) * u vt (det +1 restored)
    sign = jnp.sign(det)[..., None, None]
    r = jnp.einsum("...ij,...jk->...ik", u * sign, vtr)
    # common scale of the solution vector: rotations have unit singular
    # values; undo it on E before extracting t
    scale = jnp.mean(s, axis=-1)[..., None, None] * sign
    e = e / jnp.maximum(jnp.abs(scale), 1e-12) * jnp.sign(scale)
    tx = jnp.einsum("...ij,...kj->...ik", e, r)              # [t]x = E R^T
    t = jnp.stack([tx[..., 2, 1] - tx[..., 1, 2],
                   tx[..., 0, 2] - tx[..., 2, 0],
                   tx[..., 1, 0] - tx[..., 0, 1]], axis=-1) * 0.5
    return r, t


def generalized_epipolar_residual(r, t, o1, d1, o2, d2):
    """|generalized epipolar constraint| per match (the GR6P residual)."""
    m1 = jnp.cross(o1, d1)
    m2 = jnp.cross(o2, d2)
    tx = jnp.zeros(r.shape[:-2] + (3, 3), r.dtype)
    tx = tx.at[..., 0, 1].set(-t[..., 2]).at[..., 0, 2].set(t[..., 1])
    tx = tx.at[..., 1, 0].set(t[..., 2]).at[..., 1, 2].set(-t[..., 0])
    tx = tx.at[..., 2, 0].set(-t[..., 1]).at[..., 2, 1].set(t[..., 0])
    e = jnp.einsum("...ij,...jk->...ik", tx, r)
    v = (jnp.einsum("...ni,...ij,...nj->...n", d2, e, d1)
         + jnp.einsum("...ni,...ij,...nj->...n", d2, r, m1)
         + jnp.einsum("...ni,...ij,...nj->...n", m2, r, d1))
    return jnp.abs(v)


def ransac_generalized_relative_pose(key, o1, d1, o2, d2, valid=None, *,
                                     threshold: float = 1e-4,
                                     n_hypotheses: int = 256,
                                     sample_size: int = 20,
                                     min_inliers: int = 20):
    """RANSAC over 17+-point generalized-relative-pose samples.

    Caveat (inherent to the linear solver): a 17+-point sample needs
    (1-eps)^20 clean-sample probability, so this tolerates only LOW
    outlier rates (<~15% at the default 256 hypotheses) — raise
    n_hypotheses for dirtier matches. The reference's minimal GR6P
    (Groebner, 64 solutions) trades that robustness for a solver that
    does not batch; rig loop-closure candidates arriving from
    vocab-tree retrieval + per-pair verification are already mostly
    clean, which is this solver's regime."""
    o1 = jnp.asarray(o1, jnp.float32)
    d1 = jnp.asarray(d1, jnp.float32)
    o2 = jnp.asarray(o2, jnp.float32)
    d2 = jnp.asarray(d2, jnp.float32)
    n = d1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
    _, picks = jax.lax.top_k(g, sample_size)
    r, t = fit_generalized_relative_pose(o1[picks], d1[picks],
                                         o2[picks], d2[picks])
    res = generalized_epipolar_residual(
        r[:, None], t[:, None], o1[None], d1[None], o2[None], d2[None])
    inl = (res < threshold) & valid[None, :]
    support = jnp.sum(inl, axis=-1)
    best = jnp.argmax(support)
    good = support[best] >= min_inliers    # failure -> zero inliers
    inl_best = inl[best] & good
    return (r[best], t[best], inl_best,
            jnp.sum(inl_best).astype(jnp.int32))
