"""Two-view epipolar estimators: fundamental (7/8-point), essential (5-point).

Reference: retrieval/vlindex/src/estimators/ — fundamental_matrix
(7/8-point, fundamental_matrix.cc), essential_matrix (Nister 5-point,
essential.cc), two_view_geometry decision logic. Here: the batched
normalized 8-point algorithm (DLT + rank-2 projection), the 7-point
minimal solver (2-dim null space + closed-form Cardano cubic, up to 3
solutions), the Stewenius/Nister 5-point essential minimal solver, and
essential-from-fundamental with known intrinsics, plus Sampson error
scoring — all batched so RANSAC evaluates S hypotheses in one SVD batch.

Solver notes: the 5-point solver avoids the nonsymmetric eigensolver
(XLA has it on the CPU only) — the 10x10 action matrix's eigenvalues come
from fixed-iteration Aberth–Ehrlich on p(z) = det(zI - A), with the
Newton ratio p/p' evaluated through the trace identity
p'/p = tr((zI - A)^{-1}) via batched split-complex linear solves (no
polynomial coefficients anywhere — the f32 charpoly representation
cannot resolve clustered roots). Eigenvectors come from delta-shifted
fixed-shift inverse iteration. Everything is fixed-shape and jittable,
so the minimal solver vmaps over RANSAC hypothesis batches.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.match.solvers import _hartley_normalize


def fit_fundamental_8pt(src: jax.Array, dst: jax.Array,
                        weights: jax.Array | None = None) -> jax.Array:
    """Normalized 8-point fundamental matrix. src/dst [..., n>=8, 2].

    `weights` [..., n] (e.g. an inlier mask) scales design rows — zeroed
    rows drop out of the DLT null-space fit, giving a weighted refit
    without dynamic shapes. Returns F [..., 3, 3] with rank-2
    enforcement, dst^T F src ~ 0.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    sn, t1 = _hartley_normalize(src)
    dn, t2 = _hartley_normalize(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    one = jnp.ones_like(x)
    a = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y, one],
                  axis=-1)                                  # [..., n, 9]
    if weights is not None:
        a = a * weights[..., None]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    f = vt[..., -1, :].reshape(src.shape[:-2] + (3, 3))
    # rank-2 projection
    uf, sf, vtf = jnp.linalg.svd(f)
    sf = sf.at[..., 2].set(0.0)
    f = jnp.einsum("...ij,...j,...jk->...ik", uf, sf, vtf)
    # denormalize: F = T2^T Fn T1
    f = jnp.einsum("...ji,...jk,...kl->...il", t2, f, t1)
    norm = jnp.linalg.norm(f.reshape(f.shape[:-2] + (9,)),
                           axis=-1)[..., None, None]
    return f / (norm + 1e-12)


def essential_from_fundamental(f: jax.Array, k1: jax.Array,
                               k2: jax.Array) -> jax.Array:
    """E = K2^T F K1, with the (1,1,0) singular-value projection."""
    e = jnp.einsum("...ji,...jk,...kl->...il", k2, f, k1)
    u, _, vt = jnp.linalg.svd(e)
    s = jnp.ones(e.shape[:-2] + (3,), e.dtype).at[..., 2].set(0.0)
    return jnp.einsum("...ij,...j,...jk->...ik", u, s, vt)


def sampson_error(f: jax.Array, src: jax.Array, dst: jax.Array):
    """First-order geometric (Sampson) distance of correspondences to the
    epipolar constraint. f [..., 3, 3]; src/dst [..., n, 2] -> [..., n].
    """
    ones = jnp.ones(src.shape[:-1] + (1,), src.dtype)
    x1 = jnp.concatenate([src, ones], axis=-1)             # [..., n, 3]
    x2 = jnp.concatenate([dst, ones], axis=-1)
    fx1 = jnp.einsum("...ij,...nj->...ni", f, x1)
    ftx2 = jnp.einsum("...ji,...nj->...ni", f, x2)
    num = jnp.square(jnp.sum(x2 * fx1, axis=-1))
    den = (jnp.square(fx1[..., 0]) + jnp.square(fx1[..., 1])
           + jnp.square(ftx2[..., 0]) + jnp.square(ftx2[..., 1]))
    return num / jnp.maximum(den, 1e-12)


def _score_and_lo(src, dst, valid, models, model_ok, threshold,
                  essential: bool = False):
    """Shared RANSAC tail: Sampson-score a flat model stack [S, 3, 3],
    pick the best valid model, LO-refit with the weighted 8-point over
    the winner's inliers (projected to an essential matrix when
    essential=True), and keep whichever supports more inliers."""
    n = src.shape[0]
    s = models.shape[0]
    err = sampson_error(models, jnp.broadcast_to(src, (s, n, 2)),
                        jnp.broadcast_to(dst, (s, n, 2)))
    inl = (err < threshold * threshold) & valid[None, :]
    support = jnp.sum(inl, axis=-1)
    finite = jnp.all(jnp.isfinite(models.reshape(s, -1)), -1) & model_ok
    support = jnp.where(finite, support, -1)
    best = jnp.argmax(support)
    # LO refit: weighted 8-point over ALL points with the winner's inlier
    # mask as row weights (zero rows drop out of the null-space fit)
    w = inl[best]
    f2 = fit_fundamental_8pt(src, dst, w.astype(jnp.float32))
    if essential:
        u, _, vt = jnp.linalg.svd(f2)
        sv = jnp.ones((3,), f2.dtype).at[2].set(0.0)
        f2 = jnp.einsum("ij,j,jk->ik", u, sv, vt)
    err2 = sampson_error(f2, src, dst)
    inl2 = (err2 < threshold * threshold) & valid
    better = jnp.sum(inl2) > support[best]
    model = jnp.where(better, f2, models[best])
    inliers = jnp.where(better, inl2, w)
    n_inl = jnp.sum(inliers).astype(jnp.int32)
    return model, inliers, n_inl


def ransac_fundamental(key, src, dst, valid=None, *,
                       threshold: float = 2.0, n_hypotheses: int = 256,
                       min_inliers: int = 12, method: str = "8pt"):
    """Batched-hypothesis RANSAC for F with Sampson scoring.

    method: "8pt" (normalized DLT hypotheses) or "7pt" (the reference's
    minimal solver, FundamentalMatrixSevenPointEstimator — each sample
    yields up to 3 model candidates, all scored).
    src/dst [N, 2]; returns (F [3,3], inliers [N] bool, n_inliers)."""
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    n = src.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
    if method == "7pt":
        _, picks = jax.lax.top_k(g, 7)
        cands, ok = fit_fundamental_7pt(src[picks], dst[picks])
        models = cands.reshape(n_hypotheses * 3, 3, 3)
        model_ok = ok.reshape(n_hypotheses * 3)
    elif method == "8pt":
        _, picks = jax.lax.top_k(g, 8)
        models = fit_fundamental_8pt(src[picks], dst[picks])  # [S, 3, 3]
        model_ok = jnp.ones((n_hypotheses,), bool)
    else:
        raise ValueError(f"unknown method {method!r}")
    return _score_and_lo(src, dst, valid, models, model_ok, threshold)


def ransac_essential(key, x1, x2, valid=None, *,
                     threshold: float = 0.01, n_hypotheses: int = 64,
                     min_inliers: int = 12):
    """Batched-hypothesis RANSAC for the essential matrix using the
    5-point minimal solver (EssentialMatrixFivePointEstimator +
    RANSAC<> in the reference, essential.cc / ransac.h:184-259).

    x1/x2 [N, 2] in NORMALIZED camera coordinates (K^-1 applied);
    threshold is the Sampson distance in normalized units. Each of the
    n_hypotheses 5-point samples yields up to 10 essential candidates —
    all are scored in one batch. Returns (E [3,3], inliers [N],
    n_inliers)."""
    x1 = jnp.asarray(x1, jnp.float32)
    x2 = jnp.asarray(x2, jnp.float32)
    n = x1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits[None, :]
    _, picks = jax.lax.top_k(g, 5)
    cands, ok = fit_essential_5pt(x1[picks], x2[picks])  # [S, 10, 3, 3]
    models = cands.reshape(n_hypotheses * 10, 3, 3)
    model_ok = ok.reshape(n_hypotheses * 10)
    return _score_and_lo(x1, x2, valid, models, model_ok, threshold,
                         essential=True)


# ---------------------------------------------------------------------------
# Minimal solvers: 7-point fundamental, 5-point essential (Stewenius/Nister)
# ---------------------------------------------------------------------------

def solve_cubic_real(c3, c2, c1, c0):
    """Real roots of c3 t^3 + c2 t^2 + c1 t + c0 (batched).

    Returns (roots [..., 3], valid [..., 3]). Falls back to the quadratic /
    linear root set when leading coefficients vanish. Trigonometric /
    Cardano method — closed-form, jittable.
    """
    c3, c2, c1, c0 = jnp.broadcast_arrays(
        jnp.asarray(c3, jnp.float32), jnp.asarray(c2, jnp.float32),
        jnp.asarray(c1, jnp.float32), jnp.asarray(c0, jnp.float32))
    eps = 1e-12
    is_cubic = jnp.abs(c3) > eps * jnp.maximum(
        1.0, jnp.maximum(jnp.abs(c2), jnp.maximum(jnp.abs(c1),
                                                  jnp.abs(c0))))
    a = jnp.where(is_cubic, c3, 1.0)
    b, c, d = c2 / a, c1 / a, c0 / a
    # depressed cubic t = s - b/3:  s^3 + p s + q
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # three-real-root branch (disc <= 0): trigonometric
    pr = jnp.minimum(p, -eps)
    mp3 = jnp.sqrt(-pr / 3.0)
    arg = jnp.clip(3.0 * q / (2.0 * pr * mp3), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    kk = jnp.asarray([0.0, 1.0, 2.0], jnp.float32)
    roots3 = 2.0 * mp3[..., None] * jnp.cos(
        theta[..., None] - 2.0 * jnp.pi * kk / 3.0)
    # one-real-root branch (disc > 0): Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    root1 = u + v
    roots = jnp.where((disc <= 0.0)[..., None], roots3,
                      jnp.stack([root1, root1, root1], axis=-1))
    roots = roots - (b / 3.0)[..., None]
    valid = jnp.where((disc <= 0.0)[..., None],
                      jnp.ones_like(roots, bool),
                      jnp.asarray([True, False, False]))
    # quadratic fallback when c3 ~ 0
    qa = jnp.where(jnp.abs(c2) > eps, c2, 1.0)
    qd = c1 * c1 - 4.0 * c2 * c0
    qs = jnp.sqrt(jnp.maximum(qd, 0.0))
    q1 = (-c1 + qs) / (2.0 * qa)
    q2 = (-c1 - qs) / (2.0 * qa)
    lin = -c0 / jnp.where(jnp.abs(c1) > eps, c1, 1.0)
    quad_roots = jnp.stack([q1, q2, lin], axis=-1)
    quad_valid = jnp.stack([(jnp.abs(c2) > eps) & (qd >= 0.0),
                            (jnp.abs(c2) > eps) & (qd >= 0.0),
                            (jnp.abs(c2) <= eps) & (jnp.abs(c1) > eps)],
                           axis=-1)
    roots = jnp.where(is_cubic[..., None], roots, quad_roots)
    valid = jnp.where(is_cubic[..., None], valid, quad_valid)
    return roots, valid


def fit_fundamental_7pt(src: jax.Array, dst: jax.Array):
    """7-point minimal fundamental solver (up to 3 solutions).

    Reference: retrieval/vlindex/src/estimators/fundamental_matrix.cc
    (FundamentalMatrixSevenPointEstimator). src/dst [..., 7, 2].
    Returns (F [..., 3, 3, 3], valid [..., 3]): the 2-dim DLT null space
    F(t) = F2 + t (F1 - F2) intersected with det F = 0 via the
    closed-form cubic — batched, no iteration.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    sn, t1 = _hartley_normalize(src)
    dn, t2 = _hartley_normalize(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    one = jnp.ones_like(x)
    a = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y, one],
                  axis=-1)                                   # [..., 7, 9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    f1 = vt[..., 7, :].reshape(src.shape[:-2] + (3, 3))
    f2 = vt[..., 8, :].reshape(src.shape[:-2] + (3, 3))
    g = f1 - f2                                              # F(t) = f2 + t g
    # det(f2 + t g) = c0 + c1 t + c2 t^2 + c3 t^3 sampled at t=0,1,-1,2
    d0 = jnp.linalg.det(f2)
    d1 = jnp.linalg.det(f2 + g)
    dm1 = jnp.linalg.det(f2 - g)
    d2 = jnp.linalg.det(f2 + 2.0 * g)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - d0
    c3 = (d2 - 2.0 * d1 + d0 - 2.0 * c2) / 6.0
    c1 = d1 - d0 - c2 - c3
    roots, valid = solve_cubic_real(c3, c2, c1, c0)          # [..., 3]
    f = f2[..., None, :, :] + roots[..., :, None, None] * g[..., None, :, :]
    # denormalize each solution: F = T2^T Fn T1
    f = jnp.einsum("...ji,...sjk,...kl->...sil", t2, f, t1)
    norm = jnp.linalg.norm(f.reshape(f.shape[:-2] + (9,)),
                           axis=-1)[..., None, None]
    f = f / (norm + 1e-12)
    valid = valid & jnp.all(jnp.isfinite(f.reshape(f.shape[:-2] + (9,))),
                            axis=-1)
    return f, valid


# ---- 5-point essential: precomputed monomial algebra (numpy, import-time)
_B1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]            # x, y, z, 1
_M2 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
       (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_M3 = ([(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
        (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)] + _M2)
_M2_IDX = {e: i for i, e in enumerate(_M2)}
_M3_IDX = {e: i for i, e in enumerate(_M3)}


def _scatter_mats():
    add = lambda e1, e2: tuple(np.add(e1, e2))
    s11 = np.zeros((16, 10), np.float32)      # (deg<=1)x(deg<=1) -> deg<=2
    for i, ei in enumerate(_B1):
        for j, ej in enumerate(_B1):
            s11[i * 4 + j, _M2_IDX[add(ei, ej)]] = 1.0
    s21 = np.zeros((40, 20), np.float32)      # (deg<=2)x(deg<=1) -> deg<=3
    for i, ei in enumerate(_M2):
        for j, ej in enumerate(_B1):
            s21[i * 4 + j, _M3_IDX[add(ei, ej)]] = 1.0
    return jnp.asarray(s11), jnp.asarray(s21)


_S11, _S21 = _scatter_mats()


def _p11(a, b):
    """Multiply two degree<=1 polys over [x,y,z,1] -> degree<=2 [.., 10]."""
    outer = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (16,))
    return outer @ _S11


def _p21(a, b):
    """(degree<=2 [..,10]) * (degree<=1 [..,4]) -> degree<=3 [.., 20]."""
    outer = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (40,))
    return outer @ _S21


def _charpoly(a):
    """Characteristic polynomial of a [..., n, n] via Faddeev-LeVerrier.
    Returns monic coefficients [c0..cn] with c0=1: sum_k c_k lam^(n-k)."""
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    m = jnp.zeros_like(a) + eye
    coeffs = [jnp.ones(a.shape[:-2], a.dtype)]
    for k in range(1, n + 1):
        am = a @ m
        ck = -jnp.trace(am, axis1=-2, axis2=-1) / k
        coeffs.append(ck)
        m = am + ck[..., None, None] * eye
    return jnp.stack(coeffs, axis=-1)                        # [..., n+1]


def _durand_kerner(coeffs, iters: int = 80):
    """All complex roots of the monic REAL polynomial given by coeffs
    [..., n+1] (c0=1), returned as (real [..., n], imag [..., n]).

    Fixed-iteration Weierstrass/Durand-Kerner in EXPLICIT real/imag
    arithmetic: split arithmetic lowers to plain f32 on every backend,
    with no complex reduction ops."""
    n = coeffs.shape[-1] - 1
    c0 = coeffs.astype(jnp.float32)
    # Fujiwara root-bound scaling: all roots satisfy
    # |lam| <= 2 max_k |c_k|^(1/k); substituting lam = s mu maps them
    # into the unit disk and keeps every coefficient |c_k / s^k| <= 1,
    # so degree-n Horner never overflows f32 (unscaled, a poly with
    # |c_n| ~ 1e4 diverges DK to inf -> NaN through the denominators).
    k_idx = jnp.asarray(np.arange(1, n + 1), jnp.float32)
    fuji = jnp.max(jnp.abs(c0[..., 1:]) ** (1.0 / k_idx), axis=-1)
    s = jnp.maximum(2.0 * fuji, 1.0)                         # [...]
    c = c0 / (s[..., None] ** jnp.asarray(np.arange(n + 1), jnp.float32))
    seed = np.power(0.4 + 0.9j, np.arange(1, n + 1))
    wr = jnp.broadcast_to(jnp.asarray(seed.real, jnp.float32),
                          coeffs.shape[:-1] + (n,))
    wi = jnp.broadcast_to(jnp.asarray(seed.imag, jnp.float32),
                          coeffs.shape[:-1] + (n,))
    eye = jnp.eye(n, dtype=jnp.float32)

    def body(carry, _):
        wr, wi = carry
        wr0, wi0 = wr, wi
        # Horner: p(w) with real coefficients
        pr = jnp.broadcast_to(c[..., 0:1], wr.shape)
        pi = jnp.zeros_like(wi)
        for k in range(1, n + 1):
            pr, pi = (pr * wr - pi * wi + c[..., k:k + 1],
                      pr * wi + pi * wr)
        # denom_i = prod_{j != i} (w_i - w_j): unrolled complex product
        dr = wr[..., :, None] - wr[..., None, :] + eye       # [.., n, n]
        di = wi[..., :, None] - wi[..., None, :]
        ar = jnp.ones_like(wr)
        ai = jnp.zeros_like(wi)
        for j in range(n):
            br, bi = dr[..., j], di[..., j]
            ar, ai = ar * br - ai * bi, ar * bi + ai * br
        # w -= p(w) / denom  (complex division)
        m2 = jnp.maximum(ar * ar + ai * ai, 1e-30)
        wr = wr - (pr * ar + pi * ai) / m2
        wi = wi - (pi * ar - pr * ai) / m2
        ok = jnp.isfinite(wr) & jnp.isfinite(wi)
        wr = jnp.where(ok, wr, wr0)
        wi = jnp.where(ok, wi, wi0)
        return (wr, wi), None

    (wr, wi), _ = jax.lax.scan(body, (wr, wi), None, length=iters)
    return wr * s[..., None], wi * s[..., None]


def fit_essential_5pt(src: jax.Array, dst: jax.Array):
    """Nister/Stewenius 5-point essential matrix solver (up to 10 sols).

    Reference: retrieval/vlindex/src/estimators/essential.cc
    (EssentialMatrixFivePointEstimator). src/dst [..., 5, 2] in NORMALIZED
    camera coordinates (K^-1 applied). Returns (E [..., 10, 3, 3],
    valid [..., 10]) with dst^T E src = 0.

    batched pipeline (no Groebner tables, no nonsymmetric eig):
      1. 4-dim DLT null space E = x X + y Y + z Z + W (batched SVD);
      2. the 10 cubic constraints (det E = 0; 2 E E^T E - tr(E E^T) E = 0)
         assembled over a fixed 20-monomial basis by precomputed
         scatter-matmul polynomial products;
      3. Gauss-Jordan -> 10x10 action matrix for multiplication by x in
         the quotient ring;
      4. eigenvalues via Faddeev-LeVerrier charpoly + Durand-Kerner;
         eigenvectors via batched SVD null spaces -> (x, y, z).
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    batch = src.shape[:-2]
    x1, y1 = src[..., 0], src[..., 1]
    x2, y2 = dst[..., 0], dst[..., 1]
    one = jnp.ones_like(x1)
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                   x1, y1, one], axis=-1)                    # [..., 5, 9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    basis = vt[..., 5:9, :]                                  # [..., 4, 9]
    ex = basis[..., 0, :].reshape(batch + (3, 3))
    ey = basis[..., 1, :].reshape(batch + (3, 3))
    ez = basis[..., 2, :].reshape(batch + (3, 3))
    ew = basis[..., 3, :].reshape(batch + (3, 3))
    # E entries as degree-1 polys over [x, y, z, 1]: [..., 3, 3, 4]
    ep = jnp.stack([ex, ey, ez, ew], axis=-1)

    def det3(e):
        # cofactor expansion with poly products -> [..., 20]
        def m2(i0, i1, j0, j1):
            return (_p11(e[..., i0, j0, :], e[..., i1, j1, :])
                    - _p11(e[..., i0, j1, :], e[..., i1, j0, :]))
        return (_p21(m2(1, 2, 1, 2), e[..., 0, 0, :])
                - _p21(m2(1, 2, 0, 2), e[..., 0, 1, :])
                + _p21(m2(1, 2, 0, 1), e[..., 0, 2, :]))

    # EEt[i,j] = sum_k E[i,k] E[j,k] : degree-2 [..., 3, 3, 10]
    eet = jnp.stack([jnp.stack([
        sum(_p11(ep[..., i, k, :], ep[..., j, k, :]) for k in range(3))
        for j in range(3)], axis=-2) for i in range(3)], axis=-3)
    tr = eet[..., 0, 0, :] + eet[..., 1, 1, :] + eet[..., 2, 2, :]
    cmat = 2.0 * eet - jnp.zeros_like(eet).at[..., 0, 0, :].set(tr) \
        .at[..., 1, 1, :].set(tr).at[..., 2, 2, :].set(tr)
    # (C E)[i,j] = sum_k C[i,k] E[k,j] : degree-3 [..., 3, 3, 20]
    rows = [det3(ep)]
    for i in range(3):
        for j in range(3):
            rows.append(sum(_p21(cmat[..., i, k, :], ep[..., k, j, :])
                            for k in range(3)))
    m = jnp.stack(rows, axis=-2)                             # [..., 10, 20]

    m1 = m[..., :, :10]
    m2_ = m[..., :, 10:]
    r = jnp.linalg.solve(m1, m2_)                            # [..., 10, 10]
    # action matrix for multiplication by x over basis
    # [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1]
    amat = jnp.zeros(batch + (10, 10), jnp.float32)
    amat = amat.at[..., 0, :].set(-r[..., 0, :])   # x*x^2  = x^3
    amat = amat.at[..., 1, :].set(-r[..., 1, :])   # x*xy   = x^2 y
    amat = amat.at[..., 2, :].set(-r[..., 2, :])   # x*xz   = x^2 z
    amat = amat.at[..., 3, :].set(-r[..., 3, :])   # x*y^2  = x y^2
    amat = amat.at[..., 4, :].set(-r[..., 4, :])   # x*yz   = x y z
    amat = amat.at[..., 5, :].set(-r[..., 5, :])   # x*z^2  = x z^2
    amat = amat.at[..., 6, 0].set(1.0)             # x*x    = x^2
    amat = amat.at[..., 7, 1].set(1.0)             # x*y    = xy
    amat = amat.at[..., 8, 2].set(1.0)             # x*z    = xz
    amat = amat.at[..., 9, 6].set(1.0)             # x*1    = x

    # ---- real eigenvalues of the action matrix, backend-robustly -------
    # An f32 charpoly (Faddeev-LeVerrier) + root-finding on its
    # COEFFICIENTS cannot resolve clustered eigenvalues: the coefficient
    # representation is catastrophically ill-conditioned in f32. Instead,
    # run Aberth-Ehrlich simultaneous iteration directly on
    # p(z) = det(z I - A), with the Newton ratio p/p' obtained from the
    # trace identity  p'/p = tr((z I - A)^{-1})  via batched linear
    # solves — no polynomial coefficients anywhere. Complex arithmetic is
    # split into real/imag with an augmented 20x20 real system (no complex
    # linalg needed). The mutual-repulsion term keeps
    # the 10 candidates distinct, so clusters resolve like they do for
    # the exact eigensolver.
    eye10 = jnp.eye(10, dtype=jnp.float32)
    rad = jnp.max(jnp.sum(jnp.abs(amat), axis=-1), axis=-1)  # [...] inf-norm
    rad = jnp.maximum(rad, 1.0)
    # geometric radius spread: eigenvalue magnitudes can span 1e3x
    # (rad is only an upper bound), so seeds must cover small moduli too
    seed_c = (np.exp(1j * (2.0 * np.pi * np.arange(10) / 10.0 + 0.37))
              * np.geomspace(0.01, 0.9, 10))
    zr = rad[..., None] * jnp.asarray(seed_c.real, jnp.float32)
    zi = rad[..., None] * jnp.asarray(seed_c.imag, jnp.float32)
    rhs0 = np.concatenate([np.eye(10, dtype=np.float32),
                           np.zeros((10, 10), np.float32)], axis=0)
    rhs = jnp.broadcast_to(jnp.asarray(rhs0), zr.shape + (20, 10))
    off = jnp.asarray(1.0 - np.eye(10, dtype=np.float32), bool)

    def _aberth_step(carry, _):
        zr, zi = carry                                       # [..., 10]
        mr = zr[..., None, None] * eye10 - amat[..., None, :, :]
        mi = zi[..., None, None] * eye10 + jnp.zeros_like(mr)
        mm = jnp.concatenate(
            [jnp.concatenate([mr, -mi], axis=-1),
             jnp.concatenate([mi, mr], axis=-1)], axis=-2)   # [..,10,20,20]
        sol = jnp.linalg.solve(mm, rhs)                      # [..,10,20,10]
        tr_r = jnp.trace(sol[..., :10, :], axis1=-2, axis2=-1)
        tr_i = jnp.trace(sol[..., 10:, :], axis1=-2, axis2=-1)
        den = jnp.maximum(tr_r * tr_r + tr_i * tr_i, 1e-30)
        wr_, wi_ = tr_r / den, -tr_i / den                   # w = p/p'
        dzr = zr[..., :, None] - zr[..., None, :]
        dzi = zi[..., :, None] - zi[..., None, :]
        d2 = jnp.where(off, jnp.maximum(dzr * dzr + dzi * dzi, 1e-20), 1.0)
        sr = jnp.sum(jnp.where(off, dzr / d2, 0.0), axis=-1)
        si = jnp.sum(jnp.where(off, -dzi / d2, 0.0), axis=-1)
        dr = 1.0 - (wr_ * sr - wi_ * si)
        di = -(wr_ * si + wi_ * sr)
        dd = jnp.maximum(dr * dr + di * di, 1e-30)
        st_r = (wr_ * dr + wi_ * di) / dd
        st_i = (wi_ * dr - wr_ * di) / dd
        zr_n, zi_n = zr - st_r, zi - st_i
        ok = (jnp.isfinite(zr_n) & jnp.isfinite(zi_n)
              & (zr_n * zr_n + zi_n * zi_n
                 < 100.0 * rad[..., None] * rad[..., None]))
        return (jnp.where(ok, zr_n, zr), jnp.where(ok, zi_n, zi)), None

    (zr, zi), _ = jax.lax.scan(_aberth_step, (zr, zi), None, length=48)
    lam = zr                                                 # [..., 10]

    # eigenvectors by FIXED-shift inverse iteration: the Aberth shift is
    # already converged, and updating lam per-step (true RQI) lets two
    # candidates straddling a near-pair (gap ~3e-2) migrate onto the
    # SAME eigenvalue, silently losing one root of the pair.
    # Shift by a small RELATIVE delta off the converged root: with the
    # exact root, (A - lam I) is singular to f32 working precision and
    # LU can return garbage instead of amplifying the null direction;
    # delta ~ 1e-3 stays well inside the near-pair gap (~3e-2) while
    # keeping the solve stable.
    v = jnp.full(lam.shape + (10,), 1.0 / np.sqrt(10.0), jnp.float32)
    delta = 1e-3 * (1.0 + jnp.abs(lam))
    sh = (amat[..., None, :, :]
          - (lam + delta)[..., :, None, None] * eye10)

    def _invit_step(v_c, _):
        v_n = jnp.linalg.solve(sh, v_c[..., None])[..., 0]
        v_n = v_n / (jnp.linalg.norm(v_n, axis=-1, keepdims=True) + 1e-20)
        bad = ~jnp.all(jnp.isfinite(v_n), axis=-1)
        v_n = jnp.where(bad[..., None], v_c, v_n)
        return v_n, None

    v, _ = jax.lax.scan(_invit_step, v, None, length=10)
    av = jnp.einsum("...ij,...sj->...si", amat, v)
    # final Rayleigh value for the residual gate (one-shot, no migration)
    lam = jnp.sum(v * av, axis=-1)
    eig_res = jnp.linalg.norm(av - lam[..., None] * v, axis=-1)
    # gate scales with ||A|| (the f32 eigenpair-residual floor), NOT
    # with |lam|: near-pairs (gap ~3e-2) demand residual well below
    # the gap or the mixed eigenvector slips through as "valid"
    is_real = eig_res < 1e-4 * (1.0 + rad[..., None])

    # dedupe-select the 10 best distinct candidates: a candidate is a
    # duplicate if a strictly better (or equal-and-earlier) candidate
    # sits at the same eigenvalue; duplicates get a large penalty so
    # top_k keeps distinct roots first.
    close = (jnp.abs(lam[..., :, None] - lam[..., None, :])
             < 1e-3 * (1.0 + jnp.abs(lam[..., :, None])))
    res_i = eig_res[..., :, None]
    res_j = eig_res[..., None, :]
    jj = jax.lax.broadcasted_iota(jnp.int32, close.shape, close.ndim - 1)
    ii = jax.lax.broadcasted_iota(jnp.int32, close.shape, close.ndim - 2)
    better = (res_j < res_i) | ((res_j == res_i) & (jj < ii))
    dup = jnp.any(close & better, axis=-1)                   # [..., S]
    penal = eig_res + jnp.where(dup, 1e6, 0.0) \
        + jnp.where(is_real, 0.0, 1e3)
    _, sel = jax.lax.top_k(-penal, 10)                       # [..., 10]
    take = lambda arr: jnp.take_along_axis(arr, sel, axis=-1)
    lam = take(lam)
    is_real = take(is_real)
    v = jnp.take_along_axis(v, sel[..., None], axis=-2)      # [..., 10, 10]
    denom = v[..., 9]
    safe = jnp.abs(denom) > 1e-8
    denom = jnp.where(safe, denom, 1.0)
    xs = v[..., 6] / denom
    ys = v[..., 7] / denom
    zs = v[..., 8] / denom
    e = (xs[..., None, None] * ex[..., None, :, :]
         + ys[..., None, None] * ey[..., None, :, :]
         + zs[..., None, None] * ez[..., None, :, :]
         + ew[..., None, :, :])                              # [..., 10, 3, 3]
    norm = jnp.linalg.norm(e.reshape(e.shape[:-2] + (9,)),
                           axis=-1)[..., None, None]
    e = e / (norm + 1e-12)
    valid = (is_real & safe
             & jnp.all(jnp.isfinite(e.reshape(e.shape[:-2] + (9,))), -1))
    return e, valid
