"""Two-view relative pose: vectorized RANSAC for Essential & Homography.

Array-form replacement for the reference's `SfMHelper::recoverPose`
(`ba_project/src/ba/SfMHelper.cpp:498-742`), which calls
cv::findEssentialMat (RANSAC) + cv::findHomography, scores both with
ORB-SLAM-style symmetric-transfer chi-square sums, picks H when
score_H/(score_H+score_E) > 0.4 (`:642-643`), and otherwise requires >100
essential inliers (`:653-659`).

Instead of sequential RANSAC, we draw a fixed batch of B minimal samples,
solve all hypotheses with one batched SVD, score all hypotheses against all
correspondences with one [B, N] computation, and take the argmax — fully
static shapes, no data-dependent control flow (SURVEY.md §7 hard part (b)).

Essential: normalized 8-point algorithm + projection onto the essential
manifold; decomposition to 4 (R, t) candidates with cheirality voting
(the cv::recoverPose equivalent).
Homography: normalized 4-point DLT; decomposition via Faugeras/Zhang SVD
method with cheirality + visibility disambiguation (reference `:684-724`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import rotmat_to_aa
from bundleadjustment_tpu.utils.precision import einsum, mm

CHI2_E = 3.841  # 95% chi2, 1 dof — point-to-epipolar-line distance
CHI2_H = 5.991  # 95% chi2, 2 dof — symmetric transfer
SCORE_GAMMA_E = 5.991  # ORB-SLAM truncated score offsets
SCORE_GAMMA_H = 5.991


class TwoViewResult(NamedTuple):
    rt6: jnp.ndarray  # [6] relative world->camera transform (frame1 -> frame2)
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # int32
    used_homography: jnp.ndarray  # bool
    score_ratio: jnp.ndarray  # SH / (SH + SE)
    E: jnp.ndarray  # [3,3] best essential
    H: jnp.ndarray  # [3,3] best homography
    ok: jnp.ndarray  # bool: recovery succeeded (reference returns false
    #   when the E-path has <= min_e_inliers cheirality-positive points or
    #   the H decomposition keeps no candidate, SfMHelper.cpp:653-659,715-722)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _normalize_points(uv, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2). Returns (x, T)."""
    n = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid[:, None], uv, 0.0), axis=0) / n
    d = jnp.where(valid, jnp.linalg.norm(uv - mean, axis=-1), 0.0)
    mean_d = jnp.sum(d) / n
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-9)
    T = jnp.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=uv.dtype
    ) * s
    T = T.at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1]).at[2, 2].set(1.0)
    x = (uv - mean) * s
    return x, T


def _sample_indices(key, valid, n_hyp, sample_size):
    """[n_hyp, sample_size] indices drawn from valid correspondences."""
    n = valid.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1e-9)
    return jax.random.choice(key, n, shape=(n_hyp, sample_size), replace=True, p=p)


# ---------------------------------------------------------------------------
# Essential matrix
# ---------------------------------------------------------------------------


def _eight_point(x1, x2):
    """Batched normalized 8-point.  x1, x2: [B, 8, 2] -> E_norm [B, 3, 3]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = jnp.ones_like(u1)
    # x2^T F x1 = 0 rows
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    )  # [B, 8, 9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[..., 8, :].reshape(-1, 3, 3)
    return F


def _fit_nullvec_weighted(A, w):
    """Smallest eigenvector of sum_i w_i a_i a_i^T  (A: [N, 9], w: [N])."""
    M = einsum("ni,nj->ij", A * w[:, None], A)
    _, vecs = jnp.linalg.eigh(M)
    return vecs[:, 0]


def _eight_point_all(x1, x2, w):
    """Weighted least-squares epipolar fit over ALL correspondences."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1)
    return _fit_nullvec_weighted(A, w).reshape(3, 3)


def _project_to_essential(E):
    """Project onto the essential manifold: singular values -> (1, 1, 0)."""
    U, s, Vt = jnp.linalg.svd(E)
    d = jnp.zeros_like(E)
    d = d.at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    return mm(mm(U, d), Vt)


def _epipolar_chi2(E, x1h, x2h, inv_sigma2):
    """Squared point-to-epipolar-line distances both ways, scaled.  [B, N]."""
    l2 = einsum("bij,nj->bni", E, x1h)  # line in image 2
    l1 = einsum("bji,nj->bni", E, x2h)  # line in image 1
    num = einsum("ni,bni->bn", x2h, l2) ** 2
    d2_2 = num / jnp.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d2_1 = num / jnp.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return d2_1 * inv_sigma2, d2_2 * inv_sigma2


def estimate_essential(key, uv1, uv2, valid, K4, n_hyp=256, sigma=1.0):
    """RANSAC essential matrix in *normalized camera* coordinates.

    Returns (E_px [3,3] in pixel coords for scoring, score, inliers [N]).
    Scoring follows ORB-SLAM: sum over inliers of (gamma - chi2), chi2 < 3.84
    per direction (reference's checkE/checkH analogue, SfMHelper.cpp:539-639).
    """
    # work in K^-1-normalized coordinates for conditioning
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    x1 = jnp.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    x2 = jnp.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    idx = _sample_indices(key, valid, n_hyp, 8)
    E = _eight_point(x1[idx], x2[idx])
    E = _project_to_essential(E)

    ones = jnp.ones_like(x1[:, :1])
    x1h = jnp.concatenate([x1, ones], -1)
    x2h = jnp.concatenate([x2, ones], -1)
    # sigma in pixels -> normalized units (approx using fx)
    inv_sigma2 = (fx / sigma) ** 2
    d1, d2 = _epipolar_chi2(E, x1h, x2h, inv_sigma2)
    ok = (d1 < CHI2_E) & (d2 < CHI2_E) & valid[None, :]
    score = jnp.sum(
        jnp.where(ok, (SCORE_GAMMA_E - d1) + (SCORE_GAMMA_E - d2), 0.0), axis=1
    )
    best = jnp.argmax(score)

    # local-optimization step: refit on the best hypothesis' inliers (2 rounds)
    E_best, inl = E[best], ok[best]
    for _ in range(2):
        E_ref = _project_to_essential(
            _eight_point_all(x1, x2, inl.astype(x1.dtype))[None]
        )[0]
        d1r, d2r = _epipolar_chi2(E_ref[None], x1h, x2h, inv_sigma2)
        ok_r = (d1r[0] < CHI2_E) & (d2r[0] < CHI2_E) & valid
        score_r = jnp.sum(
            jnp.where(ok_r, (SCORE_GAMMA_E - d1r[0]) + (SCORE_GAMMA_E - d2r[0]), 0.0)
        )
        better = score_r >= score[best]
        E_best = jnp.where(better, E_ref, E_best)
        inl = jnp.where(better, ok_r, inl)
    final_score = jnp.maximum(score[best], score_r)
    return E_best, final_score, inl


def _triangulate_cheirality(R, t, x1, x2, inliers):
    """Count inlier points with positive depth in both views (midpoint-free:
    linear two-view triangulation in normalized coords)."""
    # DLT rows for P1 = [I|0], P2 = [R|t]
    P2 = jnp.concatenate([R, t[:, None]], axis=1)  # [3,4]
    n = x1.shape[0]
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], 1)
    rows = jnp.stack(
        [
            x1[:, 0, None] * P1[2] - P1[0],
            x1[:, 1, None] * P1[2] - P1[1],
            x2[:, 0, None] * P2[2] - P2[0],
            x2[:, 1, None] * P2[2] - P2[1],
        ],
        axis=1,
    )  # [N,4,4]
    _, _, vt = jnp.linalg.svd(rows)
    Xh = vt[:, 3, :]
    w = jnp.where(jnp.abs(Xh[:, 3]) < 1e-12, 1e-12, Xh[:, 3])
    X = Xh[:, :3] / w[:, None]
    z1 = X[:, 2]
    z2 = mm(X, R[2]) + t[2]
    # parallax guard: reject points at infinity
    finite = jnp.all(jnp.abs(X) < 1e4, axis=-1)
    good = inliers & (z1 > 0) & (z2 > 0) & finite
    return jnp.sum(good), X, good


def decompose_essential(E, uv1, uv2, valid, K4):
    """4-way (R, t) decomposition + cheirality vote (cv::recoverPose analogue).

    Returns (rt6 [6] relative transform frame1->frame2 in world->cam sense,
    n_good, points [N,3] triangulated in frame1, good_mask [N]).
    """
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    x1 = jnp.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    x2 = jnp.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    U, _, Vt = jnp.linalg.svd(E)
    # enforce det +1
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = mm(mm(U, W), Vt)
    R2 = mm(mm(U, W.T), Vt)
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    cands_R = jnp.stack([R1, R1, R2, R2])
    cands_t = jnp.stack([t, -t, t, -t])
    counts, Xs, goods = jax.vmap(lambda R, tt: _triangulate_cheirality(R, tt, x1, x2, valid))(
        cands_R, cands_t
    )
    best = jnp.argmax(counts)
    R, tt = cands_R[best], cands_t[best]
    rt = jnp.concatenate([rotmat_to_aa(R), tt])
    return rt, counts[best], Xs[best], goods[best]


# ---------------------------------------------------------------------------
# Homography
# ---------------------------------------------------------------------------


def _four_point_h(x1, x2):
    """Batched 4-point DLT homography.  x1, x2: [B, 4, 2] -> H [B, 3, 3]."""
    B = x1.shape[0]
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    zeros = jnp.zeros_like(u)
    ones = jnp.ones_like(u)
    r1 = jnp.stack([-u, -v, -ones, zeros, zeros, zeros, up * u, up * v, up], -1)
    r2 = jnp.stack([zeros, zeros, zeros, -u, -v, -ones, vp * u, vp * v, vp], -1)
    A = jnp.concatenate([r1, r2], axis=1)  # [B, 8, 9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[..., 8, :].reshape(B, 3, 3)


def _homography_chi2(H, uv1h, uv2h, inv_sigma2):
    """Symmetric transfer chi2 [B, N] both directions."""
    Hx1 = einsum("bij,nj->bni", H, uv1h)
    w1 = jnp.where(jnp.abs(Hx1[..., 2]) < 1e-12, 1e-12, Hx1[..., 2])
    e12 = jnp.sum((Hx1[..., :2] / w1[..., None] - uv2h[None, :, :2]) ** 2, -1)
    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3, dtype=H.dtype))
    Hx2 = einsum("bij,nj->bni", Hinv, uv2h)
    w2 = jnp.where(jnp.abs(Hx2[..., 2]) < 1e-12, 1e-12, Hx2[..., 2])
    e21 = jnp.sum((Hx2[..., :2] / w2[..., None] - uv1h[None, :, :2]) ** 2, -1)
    return e21 * inv_sigma2, e12 * inv_sigma2


def estimate_homography(key, uv1, uv2, valid, n_hyp=256, sigma=1.0):
    """RANSAC homography in pixel coordinates with Hartley normalization."""
    x1n, T1 = _normalize_points(uv1, valid)
    x2n, T2 = _normalize_points(uv2, valid)
    idx = _sample_indices(key, valid, n_hyp, 4)
    Hn = _four_point_h(x1n[idx], x2n[idx])
    # denormalize: H = T2^-1 Hn T1
    H = mm(mm(jnp.linalg.inv(T2)[None], Hn), T1[None])
    H = H / jnp.where(jnp.abs(H[:, 2:3, 2:3]) < 1e-12, 1e-12, H[:, 2:3, 2:3])

    ones = jnp.ones_like(uv1[:, :1])
    uv1h = jnp.concatenate([uv1, ones], -1)
    uv2h = jnp.concatenate([uv2, ones], -1)
    inv_sigma2 = 1.0 / (sigma * sigma)
    d1, d2 = _homography_chi2(H, uv1h, uv2h, inv_sigma2)
    ok = (d1 < CHI2_H) & (d2 < CHI2_H) & valid[None, :]
    score = jnp.sum(
        jnp.where(ok, (SCORE_GAMMA_H - d1) + (SCORE_GAMMA_H - d2), 0.0), axis=1
    )
    best = jnp.argmax(score)

    # local-optimization: weighted DLT refit on the inliers (normalized coords)
    H_best, inl = H[best], ok[best]
    for _ in range(2):
        w = inl.astype(uv1.dtype)
        u, v = x1n[:, 0], x1n[:, 1]
        up, vp = x2n[:, 0], x2n[:, 1]
        zeros = jnp.zeros_like(u)
        ones = jnp.ones_like(u)
        r1 = jnp.stack([-u, -v, -ones, zeros, zeros, zeros, up * u, up * v, up], -1)
        r2 = jnp.stack([zeros, zeros, zeros, -u, -v, -ones, vp * u, vp * v, vp], -1)
        A = jnp.concatenate([r1, r2], axis=0)
        ww = jnp.concatenate([w, w])
        Hn_ref = _fit_nullvec_weighted(A, ww).reshape(3, 3)
        H_ref = mm(mm(jnp.linalg.inv(T2), Hn_ref), T1)
        H_ref = H_ref / jnp.where(jnp.abs(H_ref[2, 2]) < 1e-12, 1e-12, H_ref[2, 2])
        d1r, d2r = _homography_chi2(H_ref[None], uv1h, uv2h, inv_sigma2)
        ok_r = (d1r[0] < CHI2_H) & (d2r[0] < CHI2_H) & valid
        score_r = jnp.sum(
            jnp.where(ok_r, (SCORE_GAMMA_H - d1r[0]) + (SCORE_GAMMA_H - d2r[0]), 0.0)
        )
        better = score_r >= score[best]
        H_best = jnp.where(better, H_ref, H_best)
        inl = jnp.where(better, ok_r, inl)
    final_score = jnp.maximum(score[best], score_r)
    return H_best, final_score, inl


def decompose_homography(H, uv1, uv2, valid, K4):
    """Faugeras SVD homography decomposition + cheirality/visibility vote.

    Produces the 8 candidate motions of K^-1 H K and picks the one with the
    most in-front points whose plane normal faces the camera (reference's
    visible-refpoint filter + plane-normal-z disambiguation,
    SfMHelper.cpp:684-724).  Returns (rt6, n_good, points, good_mask).
    """
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    K = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], H.dtype)
    Kinv = jnp.array(
        [[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy], [0, 0, 1]], H.dtype
    )
    A = mm(mm(Kinv, H), K)
    U, s, Vt = jnp.linalg.svd(A)
    # normalize by middle singular value
    A = A / jnp.maximum(s[1], 1e-12)
    U, s, Vt = jnp.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    V = Vt.T
    detUV = jnp.linalg.det(U) * jnp.linalg.det(V)

    # Faugeras: x1 = ±sqrt((d1²-d2²)/(d1²-d3²)), x3 = ±sqrt((d2²-d3²)/(d1²-d3²))
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1v = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / denom, 0.0, None))
    x3v = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / denom, 0.0, None))
    eps_pairs = jnp.array(
        [[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]], H.dtype
    )

    def motions(case_dp):  # case_dp: +1 for d'=d2, -1 for d'=-d2
        def one(eps):
            e1, e3 = eps[0], eps[1]
            x1, x3 = e1 * x1v, e3 * x3v
            # Faugeras closed-form rotation about the y-axis:
            # d' = +d2:  sin = (d1-d3) x1 x3 / d2, cos = (d1 x3^2 + d3 x1^2)/d2
            sin_p = (d1 - d3) * x1 * x3 / jnp.maximum(d2, 1e-12)
            cos_p = (d1 * x3 * x3 + d3 * x1 * x1) / jnp.maximum(d2, 1e-12)
            # d' = -d2:  sin = (d1+d3) x1 x3 / d2, cos = (d3 x1^2 - d1 x3^2)/d2
            sin_m = (d1 + d3) * x1 * x3 / jnp.maximum(d2, 1e-12)
            cos_m = (d3 * x1 * x1 - d1 * x3 * x3) / jnp.maximum(d2, 1e-12)
            sin_t = jnp.where(case_dp > 0, sin_p, sin_m)
            cos_t = jnp.where(case_dp > 0, cos_p, cos_m)
            Rp = jnp.where(
                case_dp > 0,
                jnp.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1]], H.dtype)
                .at[0, 0].set(cos_t).at[0, 2].set(-sin_t)
                .at[2, 0].set(sin_t).at[2, 2].set(cos_t),
                jnp.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]], H.dtype)
                .at[0, 0].set(cos_t).at[0, 2].set(sin_t)
                .at[2, 0].set(sin_t).at[2, 2].set(-cos_t),
            )
            tp = jnp.where(
                case_dp > 0,
                (d1 - d3) * jnp.array([x1, 0.0, -x3], H.dtype),
                (d1 + d3) * jnp.array([x1, 0.0, x3], H.dtype),
            )
            np_ = jnp.array([x1, 0.0, x3], H.dtype)
            R = detUV * mm(mm(U, Rp), Vt)
            t = mm(U, tp)
            n = mm(V, np_)
            return R, t, n

        return jax.vmap(one)(eps_pairs)

    R_p, t_p, n_p = motions(jnp.asarray(1.0, H.dtype))
    R_m, t_m, n_m = motions(jnp.asarray(-1.0, H.dtype))
    Rs = jnp.concatenate([R_p, R_m])
    ts = jnp.concatenate([t_p, t_m])
    ns = jnp.concatenate([n_p, n_m])

    x1 = jnp.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    x2 = jnp.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)

    def score(R, t, n):
        tn = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
        cnt, X, good = _triangulate_cheirality(R, tn, x1, x2, valid)
        # cheirality dominates; plane-normal-facing-camera breaks ties
        # (reference's n_z disambiguation, SfMHelper.cpp:718-724)
        facing = (n[2] < 0).astype(cnt.dtype)
        return cnt * 2 + facing, X, good, tn

    counts, Xs, goods, tns = jax.vmap(score)(Rs, ts, ns)
    best = jnp.argmax(counts)
    rt = jnp.concatenate([rotmat_to_aa(Rs[best]), tns[best]])
    return rt, jnp.sum(goods[best]), Xs[best], goods[best]


# ---------------------------------------------------------------------------
# Combined recoverPose
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_hyp", "min_e_inliers"))
def recover_pose_two_view(
    key, uv1, uv2, valid, K4, n_hyp=256, sigma=1.0, h_ratio=0.4, min_e_inliers=100
):
    """Full two-view model selection + pose recovery.

    Mirrors the reference decision procedure (`SfMHelper.cpp:642-659`): compute
    both E and H scores; if SH/(SH+SE) > 0.4 use the homography decomposition,
    else use essential.  `ok` is False when the chosen model fails the
    reference's acceptance: E-path with <= min_e_inliers cheirality-positive
    inliers (`SfMHelper.cpp:653-659`) or an H decomposition with no surviving
    candidate (`:715-722`) — callers fall back (const-velocity / failed init)
    exactly as `SfMHelper::estimatePose` does at `:144-146`.

    Returns TwoViewResult; `rt6` maps frame-1 camera coords to frame-2 camera
    coords (chain with the previous pose at the call site, as the reference
    does at SfMHelper.cpp:142).
    """
    k1, k2 = jax.random.split(key)
    E, score_e, inl_e = estimate_essential(k1, uv1, uv2, valid, K4, n_hyp, sigma)
    H, score_h, inl_h = estimate_homography(k2, uv1, uv2, valid, n_hyp, sigma)
    ratio = score_h / jnp.maximum(score_h + score_e, 1e-9)
    use_h = ratio > h_ratio

    rt_e, n_e, X_e, good_e = decompose_essential(E, uv1, uv2, inl_e, K4)
    rt_h, n_h, X_h, good_h = decompose_homography(H, uv1, uv2, inl_h, K4)

    rt = jnp.where(use_h, rt_h, rt_e)
    good = jnp.where(use_h, good_h, good_e)
    n_good = jnp.where(use_h, n_h, n_e)
    ok = jnp.where(use_h, n_h > 0, n_e > min_e_inliers)
    return TwoViewResult(
        rt6=rt,
        inliers=good,
        n_inliers=n_good.astype(jnp.int32),
        used_homography=use_h,
        score_ratio=ratio,
        E=E,
        H=H,
        ok=ok,
    )
