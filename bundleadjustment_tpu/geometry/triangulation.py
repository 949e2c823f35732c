"""Batched two-view DLT triangulation with SfM acceptance gates.

Replaces ``cv::triangulatePoints`` + the hand-rolled gate cascade at reference
`ba_project/src/ba/SfMHelper.cpp:759-878`: cheirality in both views, per-view
chi-square reprojection gates (5.991 at 95%), and ratio-of-distances scale
consistency.  Everything is batched over N candidate matches and returns masks
instead of erasing — the XLA-native idiom for the reference's early-continue
loops.
"""

from __future__ import annotations

import jax.numpy as jnp

from bundleadjustment_tpu.geometry.projection import intrinsics_matrix, project
from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu.utils.precision import mm

CHI2_2D = 5.991  # 95% quantile of chi^2 with 2 dof; reference SfMHelper.cpp:826,843


def projection_matrix(K4, rt_extr):
    """[...,4], [...,6] -> [...,3,4]  P = K [R|t]."""
    K = intrinsics_matrix(K4)
    R = aa_to_rotmat(rt_extr[..., :3])
    t = rt_extr[..., 3:]
    Rt = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return mm(K, Rt)


def triangulate_dlt(P1, P2, uv1, uv2):
    """Homogeneous DLT triangulation.

    P1, P2: [..., 3, 4] projection matrices (broadcast against points).
    uv1, uv2: [..., N, 2] pixel observations.
    Returns world points [..., N, 3].

    Builds the standard 4x4 system (rows u*P3-P1, v*P3-P2 for each view) and
    takes the smallest-singular-vector via one batched SVD.
    """
    P1 = jnp.broadcast_to(P1[..., None, :, :], uv1.shape[:-1] + (3, 4))
    P2 = jnp.broadcast_to(P2[..., None, :, :], uv2.shape[:-1] + (3, 4))
    rows = jnp.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # [..., N, 4, 4]
    # smallest right singular vector
    _, _, vt = jnp.linalg.svd(rows)
    Xh = vt[..., 3, :]
    w = Xh[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def triangulate_gated(
    K4,
    extr1,
    extr2,
    uv1,
    uv2,
    sigma2_1,
    sigma2_2,
    valid,
    chi2_max=CHI2_2D,
    min_parallax_baseline=None,
):
    """Triangulate matches and compute the reference's acceptance mask.

    Args:
      K4: [4] intrinsics (shared between the two views).
      extr1, extr2: [6] world->camera extrinsics.
      uv1, uv2: [N, 2] matched pixel observations.
      sigma2_1, sigma2_2: [N] per-keypoint scale variances (1.2^(2*octave)).
      valid: [N] bool, candidate mask.
      chi2_max: reprojection gate (reference SfMHelper.cpp:826,843).

    Returns (points [N,3], ok [N] bool). Gates mirror SfMHelper.cpp:806-858:
      - finite solution;
      - positive depth in both cameras (cheirality, :806-817);
      - squared reprojection error / sigma2 < chi2 in both views (:820-845);
      - scale-consistency: distance ratio within [1/ratioFactor, ratioFactor]
        where ratioFactor = 1.5 * sigma ratio (:848-858).
    """
    P1 = projection_matrix(K4, extr1)
    P2 = projection_matrix(K4, extr2)
    X = triangulate_dlt(P1, P2, uv1, uv2)

    R1 = aa_to_rotmat(extr1[:3])
    R2 = aa_to_rotmat(extr2[:3])
    xc1 = mm(X, R1.T) + extr1[3:]
    xc2 = mm(X, R2.T) + extr2[3:]
    uv1p, z1 = project(K4, xc1)
    uv2p, z2 = project(K4, xc2)

    finite = jnp.all(jnp.isfinite(X), axis=-1)
    cheir = (z1 > 0) & (z2 > 0)
    e1 = jnp.sum((uv1p - uv1) ** 2, axis=-1) / jnp.maximum(sigma2_1, 1e-12)
    e2 = jnp.sum((uv2p - uv2) ** 2, axis=-1) / jnp.maximum(sigma2_2, 1e-12)
    reproj_ok = (e1 < chi2_max) & (e2 < chi2_max)

    d1 = jnp.linalg.norm(xc1, axis=-1)
    d2 = jnp.linalg.norm(xc2, axis=-1)
    ratio = d1 / jnp.maximum(d2, 1e-12)
    sigma_ratio = jnp.sqrt(jnp.maximum(sigma2_1, 1e-12) / jnp.maximum(sigma2_2, 1e-12))
    factor = 1.5 * sigma_ratio
    scale_ok = (ratio < factor) & (ratio > 1.0 / jnp.maximum(factor, 1e-12))

    ok = valid & finite & cheir & reproj_ok & scale_ok
    X = jnp.where(ok[:, None], X, 0.0)
    return X, ok


def median_scene_depth(extr, points, valid):
    """Median depth of valid points in a camera — reference
    `ba_project/src/model/Frame.cpp:394-417` (used for the baseline/median-depth
    >= 0.01 triangulation precondition, SfMHelper.cpp:763-771)."""
    R = aa_to_rotmat(extr[:3])
    z = mm(points, R[2, :]) + extr[5]
    big = jnp.where(valid, z, jnp.inf)
    n = jnp.maximum(jnp.sum(valid), 1)
    zs = jnp.sort(big)
    med = zs[jnp.clip((n - 1) // 2, 0, z.shape[0] - 1)]
    return jnp.where(jnp.any(valid), med, jnp.inf)
