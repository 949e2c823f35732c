"""Reconstruction error: point-cloud vs ground-truth alignment via ICP.

Array-form replacement for the reference's PCL-based metric
(`ba_project/src/metrics/ReconstructionError.cpp:49-110,134-190`):
- transform the sparse map into the GT frame using the first keyframe's
  ground-truth pose (`:64-76`);
- zero-center both clouds and normalize scale with a percentile bounding box
  (`:212-244`);
- run point-to-point ICP; the fitness score (mean squared distance of
  correspondences) is the reconstruction error (`:184-189`).

The nearest-neighbor search is a brute-force [N, M] distance argmin — one
matrix product per iteration, batched over the whole cloud (map sizes in
play: 1e4-1e5 points).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.utils.precision import mm


def percentile_scale(points, lo=10.0, hi=90.0):
    """Robust bbox extent: percentile range per axis, L2 over axes
    (reference ReconstructionError.cpp:212-244)."""
    p_lo = np.percentile(points, lo, axis=0)
    p_hi = np.percentile(points, hi, axis=0)
    return float(np.linalg.norm(p_hi - p_lo))


def normalize_cloud(points, lo=10.0, hi=90.0):
    """Zero-center + percentile-scale to unit extent.  Returns (cloud, c, s)."""
    c = points.mean(axis=0)
    centered = points - c
    s = percentile_scale(centered, lo, hi)
    s = max(s, 1e-12)
    return centered / s, c, s


@partial(jax.jit, static_argnames=("max_iters",))
def _icp_core(src, dst, max_iters, max_corr_dist):
    """Point-to-point ICP: src onto dst.  Returns (R, t, fitness, n_corr)."""

    def nearest(src_pts):
        d2 = (
            jnp.sum(src_pts**2, 1, keepdims=True)
            - 2.0 * mm(src_pts, dst.T)
            + jnp.sum(dst**2, 1)[None, :]
        )
        idx = jnp.argmin(d2, axis=1)
        best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
        return idx, jnp.maximum(best, 0.0)

    def step(carry, _):
        R, t = carry
        cur = mm(src, R.T) + t
        idx, d2 = nearest(cur)
        w = (d2 <= max_corr_dist**2).astype(src.dtype)
        n = jnp.maximum(jnp.sum(w), 1.0)
        tgt = dst[idx]
        mu_s = jnp.sum(cur * w[:, None], 0) / n
        mu_t = jnp.sum(tgt * w[:, None], 0) / n
        H = mm(((cur - mu_s) * w[:, None]).T, tgt - mu_t)
        U, _, Vt = jnp.linalg.svd(H)
        d = jnp.sign(jnp.linalg.det(mm(Vt.T, U.T)))
        D = jnp.diag(jnp.array([1.0, 1.0, 1.0], src.dtype)).at[2, 2].set(d)
        dR = mm(mm(Vt.T, D), U.T)
        dt = mu_t - mm(dR, mu_s)
        return (mm(dR, R), mm(dR, t) + dt), None

    init = (jnp.eye(3, dtype=src.dtype), jnp.zeros(3, src.dtype))
    (R, t), _ = jax.lax.scan(step, init, None, length=max_iters)
    cur = mm(src, R.T) + t
    _, d2 = nearest(cur)
    w = d2 <= max_corr_dist**2
    n = jnp.maximum(jnp.sum(w), 1.0)
    fitness = jnp.sum(jnp.where(w, d2, 0.0)) / n
    return R, t, fitness, jnp.sum(w)


def icp_align(source, target, max_iters=30, max_corr_dist=0.1):
    """ICP align source -> target (numpy in/out).  Returns dict."""
    src = jnp.asarray(source, jnp.float32)
    dst = jnp.asarray(target, jnp.float32)
    R, t, fit, n = _icp_core(src, dst, max_iters, max_corr_dist)
    return {
        "R": np.asarray(R),
        "t": np.asarray(t),
        "fitness": float(fit),
        "n_corr": int(n),
    }


def reconstruction_error(
    map_points,
    gt_points,
    first_kf_gt_pose=None,
    max_iters=30,
    max_corr_dist=0.1,
    out_prefix=None,
):
    """Full reference metric: transform, normalize, ICP, fitness.

    map_points: [N,3] sparse map in the estimation frame.
    gt_points: [M,3] ground-truth cloud (e.g. sampled GT mesh vertices).
    first_kf_gt_pose: optional [4,4] cam->world GT of the first keyframe
      (reference transforms the map into the GT frame with it, :64-76).
    out_prefix: when given, write the reference's comparison PLYs
      (ReconstructionError.cpp:106-107,174): `<prefix>_gt_cloud.ply`,
      `<prefix>_estimated_cloud.ply` (both normalized), and
      `<prefix>_combined_colored_cloud.ply` with the ICP-aligned estimate
      red and the ground truth green.
    """
    pts = np.asarray(map_points, np.float64)
    if first_kf_gt_pose is not None:
        M = np.asarray(first_kf_gt_pose, np.float64)
        pts = pts @ M[:3, :3].T + M[:3, 3]
    src, _, _ = normalize_cloud(pts)
    dst, _, _ = normalize_cloud(np.asarray(gt_points, np.float64))
    res = icp_align(src.astype(np.float32), dst.astype(np.float32),
                    max_iters, max_corr_dist)
    if out_prefix:
        from bundleadjustment_tpu.vis.mesh import write_ply

        write_ply(out_prefix + "_gt_cloud.ply", dst)
        write_ply(out_prefix + "_estimated_cloud.ply", src)
        R, t = np.asarray(res["R"], np.float64), np.asarray(res["t"], np.float64)
        aligned = src @ R.T + t
        combined = np.concatenate([aligned, dst])
        colors = np.concatenate([
            np.tile([255, 0, 0], (len(aligned), 1)),
            np.tile([0, 255, 0], (len(dst), 1)),
        ]).astype(np.uint8)
        write_ply(out_prefix + "_combined_colored_cloud.ply", combined,
                  colors=colors)
    return res["fitness"], res
