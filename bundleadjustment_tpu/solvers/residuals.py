"""Reprojection residuals with analytic Jacobians, in SoA observation form.

This is the array-form replacement for the reference's Ceres autodiff cost
functors (`ba_project/src/ba/Optimizer.h:49-194`).  The whole bundle-adjustment
problem is four flat arrays (the observation table) plus camera/point state:

  cam_idx[N]   int32    which camera produced observation i
  pt_idx[N]    int32    which landmark it observes
  uv[N, 2]     float    measured pixel
  sigma2[N]    float    scale variance 1.2^(2*octave)  (information = 1/sigma2)
  valid[N]     bool     mask (replaces the reference's outlier bitmap,
                        `src/model/Frame.h:85`)

Camera state during optimization is (R[K,3,3], t[K,3]) — rotation matrices plus
translation — and pose increments are *left* multiplicative perturbations:

  x_cam = exp([dphi]x) R X + t + dt

so the analytic Jacobians are exact and cheap:

  d x_cam / d dphi = -[R X]x         d x_cam / d dt = I
  d x_cam / d X    = R

combined with the pinhole Jacobian d uv / d x_cam.  Residuals are whitened by
1/sigma, matching the reference's sqrt-information weighting
(`Optimizer.h:75-77`), and robustified by Huber-IRLS with delta = sqrt(5.991)
(`Optimizer.cpp:312`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu.utils.precision import einsum, mm

CHI2_2D = 5.991
HUBER_DELTA = 2.4477  # sqrt(5.991), reference Optimizer.cpp:312


class BAProblem(NamedTuple):
    """A padded, masked bundle-adjustment problem (device arrays)."""

    K4: jnp.ndarray  # [4] intrinsics
    cam_idx: jnp.ndarray  # [N] int32
    pt_idx: jnp.ndarray  # [N] int32
    uv: jnp.ndarray  # [N, 2]
    sigma2: jnp.ndarray  # [N]
    valid: jnp.ndarray  # [N] bool
    cam_fixed: jnp.ndarray  # [K] bool — gauge anchor(s), Optimizer.cpp:314-321
    pt_fixed: jnp.ndarray  # [L] bool — fixed landmarks (motion-only mode)

    @property
    def n_obs(self):
        return self.cam_idx.shape[0]


def cams_to_Rt(cam_rt6):
    """[K,6] axis-angle+t -> (R [K,3,3], t [K,3])."""
    return aa_to_rotmat(cam_rt6[..., :3]), cam_rt6[..., 3:]


def Rt_to_cams(R, t):
    return jnp.concatenate([rotmat_to_aa(R), t], axis=-1)


def reprojection_residuals(problem, R, t, points):
    """Whitened residuals r[N,2] = (proj(x) - uv)/sigma and depths z[N].

    Invalid observations produce r = 0 (fully masked).
    """
    Rc = R[problem.cam_idx]  # [N,3,3]
    tc = t[problem.cam_idx]  # [N,3]
    X = points[problem.pt_idx]  # [N,3]
    x_cam = einsum("nij,nj->ni", Rc, X) + tc
    z = x_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    fx, fy, cx, cy = problem.K4[0], problem.K4[1], problem.K4[2], problem.K4[3]
    u = fx * x_cam[..., 0] / zs + cx
    v = fy * x_cam[..., 1] / zs + cy
    inv_sigma = jax_rsqrt(problem.sigma2)
    r = jnp.stack([u - problem.uv[..., 0], v - problem.uv[..., 1]], axis=-1)
    r = r * inv_sigma[..., None]
    r = jnp.where(problem.valid[..., None], r, 0.0)
    return r, z


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(jnp.maximum(x, 1e-12))


def huber_weights(r, delta=HUBER_DELTA):
    """IRLS weights for the Huber loss on the residual 2-norm.

    w = 1 for |r| <= delta else delta/|r|; applied as sqrt(w) scaling on both
    residuals and Jacobians, which reproduces Ceres' corrected normal
    equations to first order.
    """
    nrm = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12))
    return w


def residuals_and_jacobians(problem, R, t, points, robust=True):
    """Residuals + analytic Jacobians for every observation.

    Returns (r [N,2], Jc [N,2,6], Jp [N,2,3], w [N]) where Jc columns are
    ordered [dphi(3), dt(3)], all whitened by 1/sigma and masked by validity.
    Cheirality: observations with z <= ~0 get weight 0 (Ceres would return
    +inf cost; masking is the XLA-native equivalent).
    """
    Rc = R[problem.cam_idx]
    tc = t[problem.cam_idx]
    X = points[problem.pt_idx]
    RX = einsum("nij,nj->ni", Rc, X)
    x_cam = RX + tc
    z = x_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    fx, fy = problem.K4[0], problem.K4[1]
    cx, cy = problem.K4[2], problem.K4[3]
    inv_z = 1.0 / zs
    u = fx * x_cam[..., 0] * inv_z + cx
    v = fy * x_cam[..., 1] * inv_z + cy
    inv_sigma = jax_rsqrt(problem.sigma2)
    r = jnp.stack([u - problem.uv[..., 0], v - problem.uv[..., 1]], axis=-1)
    r = r * inv_sigma[..., None]

    # d uv / d x_cam, whitened:  [N, 2, 3]
    zero = jnp.zeros_like(inv_z)
    duv_dx = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x_cam[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * x_cam[..., 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    ) * inv_sigma[..., None, None]

    # d x_cam / d dphi = -[RX]x   (left perturbation)
    RXx, RXy, RXz = RX[..., 0], RX[..., 1], RX[..., 2]
    zeros = jnp.zeros_like(RXx)
    neg_skew = jnp.stack(
        [
            jnp.stack([zeros, RXz, -RXy], -1),
            jnp.stack([-RXz, zeros, RXx], -1),
            jnp.stack([RXy, -RXx, zeros], -1),
        ],
        axis=-2,
    )
    J_phi = mm(duv_dx, neg_skew)  # [N,2,3]
    J_t = duv_dx  # [N,2,3]
    Jc = jnp.concatenate([J_phi, J_t], axis=-1)  # [N,2,6]
    Jp = mm(duv_dx, Rc)  # [N,2,3]

    mask = problem.valid & (z > 1e-6)
    w = jnp.where(mask, 1.0, 0.0)
    if robust:
        w = w * huber_weights(r)
    sw = jnp.sqrt(w)[..., None]
    r = r * sw
    Jc = Jc * sw[..., None]
    Jp = Jp * sw[..., None]
    # Gauge/fixed masking: fixed cameras contribute no camera Jacobian
    # (their residual blocks become point-only, reference Optimizer.cpp:314-321);
    # fixed points contribute no point Jacobian (pose-only costs,
    # Optimizer.h:122-194).
    Jc = jnp.where(problem.cam_fixed[problem.cam_idx][:, None, None], 0.0, Jc)
    Jp = jnp.where(problem.pt_fixed[problem.pt_idx][:, None, None], 0.0, Jp)
    r = jnp.where(mask[..., None], r, 0.0)
    return r, Jc, Jp, w


def chi2_errors(problem, R, t, points):
    """Per-observation chi^2 = |r|^2 (already whitened) and cheirality depths.

    Used for outlier pruning between LM outer iterations — the reference's
    `pruneCorrespondences` (`ba_project/src/ba/Optimizer.cpp:6-79`).
    """
    r, z = reprojection_residuals(problem, R, t, points)
    return jnp.sum(r * r, axis=-1), z


@partial(jax.jit, static_argnames=())
def prune_outliers_cams(problem, cams_rt6, points, chi2_max=CHI2_2D):
    """`prune_outliers` taking axis-angle cameras directly — ONE dispatch
    for the whole post-solve chi2 prune (driver hot path)."""
    R, t = cams_to_Rt(cams_rt6)
    chi2, z = chi2_errors(problem, R, t, points)
    return problem.valid & (chi2 <= chi2_max) & (z > 0)


@partial(jax.jit, static_argnames=())
def prune_outliers(problem, R, t, points, chi2_max=CHI2_2D):
    """Return an updated validity mask: chi2 gate + cheirality.

    Mirrors Optimizer.cpp:6-79 (chi-square at 95% with per-octave sigma,
    plus positive-depth check).  Scale-bound checks from MapPoint distance
    envelopes live at the map layer.  Jitted: one dispatch instead of ~30
    eager ops after every BA solve.
    """
    chi2, z = chi2_errors(problem, R, t, points)
    return problem.valid & (chi2 <= chi2_max) & (z > 0)
