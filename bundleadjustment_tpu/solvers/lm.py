"""Levenberg-Marquardt bundle adjustment engine.

One engine covers all five reference optimizer classes
(`ba_project/src/ba/Optimizer.h:199-289`) through masking:

- **global BA**: all cameras free except the gauge anchor (frame 0,
  `Optimizer.cpp:314-321`), all points free;
- **local BA**: non-window cameras marked fixed (their observations then act as
  point-only residuals, `Optimizer.cpp:668-696`), window cameras + their
  points free;
- **motion-only BA**: all points fixed; specialized batched fast path
  (`motion_only_ba`) that solves per-camera 6x6 systems with `vmap` — the
  batched replacement for per-frame `cv::solvePnP` / MotionOnlyBAOptimizerAngles
  (`SfMHelper.cpp:16-117`).

The LM trust-region schedule is Nielsen's (gain-ratio based), the default in
Ceres; iteration runs under `lax.scan` with accept/reject carried in state so
the whole solve is one XLA computation — no host round-trips per iteration.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu.solvers import residuals as res
from bundleadjustment_tpu.solvers import schur as schur_mod
from bundleadjustment_tpu.utils.precision import einsum, mm


class LMConfig(NamedTuple):
    max_iters: int = 10
    lam0: float = 1e-4
    solver: str = "dense"  # "dense" | "pcg"
    pcg_iters: int = 50
    pcg_tol: float = 1e-6
    robust: bool = True
    rtol: float = 1e-9  # relative cost-decrease tolerance for early freeze
    mxu_bf16: bool = False  # dense layout only: bf16 operands (f32 sums) for
    #   the one-hot camera-side contractions incl. QQ^T; no H100 measurement.


# Fixed cost charged to an observation whose point sits behind the camera.
# Ceres would evaluate a garbage/huge residual there; masking it to zero would
# make "move everything behind the cameras" a cost-0 global optimum.  The
# penalty is constant (no gradient), so LM never *accepts* a step that pushes
# points behind, while pre-existing violations cancel in step comparisons.
CHEIRALITY_PENALTY = 1.0e4


def robust_cost(problem, R, t, points, robust=True):
    """Total Huber cost  sum rho(|r|) with rho the Huber loss (delta=2.4477)."""
    r, z = res.reprojection_residuals(problem, R, t, points)
    nrm2 = jnp.sum(r * r, axis=-1)
    if robust:
        d = res.HUBER_DELTA
        nrm = jnp.sqrt(jnp.maximum(nrm2, 1e-20))
        rho = jnp.where(nrm <= d, 0.5 * nrm2, d * (nrm - 0.5 * d))
    else:
        rho = 0.5 * nrm2
    rho = jnp.where(z > 1e-6, rho, CHEIRALITY_PENALTY)
    return jnp.sum(jnp.where(problem.valid, rho, 0.0))


def _apply_update(R, t, points, dc, dp, cam_fixed, pt_fixed):
    dphi = jnp.where(cam_fixed[:, None], 0.0, dc[:, :3])
    dt = jnp.where(cam_fixed[:, None], 0.0, dc[:, 3:])
    dX = jnp.where(pt_fixed[:, None], 0.0, dp)
    R_new = mm(aa_to_rotmat(dphi), R)  # left-multiplicative retraction
    return R_new, t + dt, points + dX


class LMState(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    points: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    cost: jnp.ndarray
    done: jnp.ndarray


@partial(jax.jit, static_argnames=("config",))
def ba_solve(problem, cam_rt6, points, config=LMConfig()):
    """Run LM on a BAProblem.  Returns (cam_rt6', points', info dict).

    `problem` is a `res.BAProblem`; cameras are [K,6] world->camera rt6,
    points [L,3] world.  All shapes static; masking handles padding.
    """
    R0, t0 = res.cams_to_Rt(cam_rt6)
    cost0 = robust_cost(problem, R0, t0, points, config.robust)
    n_cams = cam_rt6.shape[0]
    n_pts = points.shape[0]

    def step(state, _):
        r, Jc, Jp, _w = res.residuals_and_jacobians(
            problem, state.R, state.t, state.points, robust=config.robust
        )
        blocks = schur_mod.build_blocks(
            r, Jc, Jp, problem.cam_idx, problem.pt_idx, n_cams, n_pts,
            state.lam, problem.cam_fixed, problem.pt_fixed,
        )
        if config.solver == "dense":
            dc = schur_mod.solve_schur_dense(blocks)
        else:
            dc = schur_mod.solve_schur_pcg(blocks, config.pcg_iters, config.pcg_tol)
        dp = schur_mod.back_substitute(blocks, dc)

        R_new, t_new, pts_new = _apply_update(
            state.R, state.t, state.points, dc, dp, problem.cam_fixed, problem.pt_fixed
        )
        new_cost = robust_cost(problem, R_new, t_new, pts_new, config.robust)

        # Nielsen gain-ratio schedule; predicted decrease uses the standard
        # surrogate 0.5 * dx^T (lam*dx - g)  (Madsen-Nielsen-Tingleff eq. 3.14)
        pred = 0.5 * (
            state.lam * (jnp.sum(dc * dc) + jnp.sum(dp * dp))
            - jnp.sum(dc * blocks.g_c)
            - jnp.sum(dp * blocks.g_p)
        )
        pred = jnp.maximum(pred, 1e-20)
        rho = (state.cost - new_cost) / pred
        accept = (new_cost < state.cost) & jnp.isfinite(new_cost)

        lam_acc = state.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_rej = state.lam * state.nu
        nu_acc = jnp.asarray(2.0, state.nu.dtype)
        nu_rej = state.nu * 2.0

        rel_decrease = (state.cost - new_cost) / jnp.maximum(state.cost, 1e-20)
        newly_done = accept & (rel_decrease < config.rtol)

        def sel(a, b):
            return jnp.where(accept & ~state.done, a, b)

        new_state = LMState(
            R=sel(R_new, state.R),
            t=sel(t_new, state.t),
            points=sel(pts_new, state.points),
            lam=jnp.where(state.done, state.lam, jnp.where(accept, lam_acc, lam_rej)),
            nu=jnp.where(state.done, state.nu, jnp.where(accept, nu_acc, nu_rej)),
            cost=sel(new_cost, state.cost),
            done=state.done | newly_done,
        )
        return new_state, new_state.cost

    init = LMState(
        R=R0,
        t=t0,
        points=points,
        lam=jnp.asarray(config.lam0, cost0.dtype),
        nu=jnp.asarray(2.0, cost0.dtype),
        cost=cost0,
        done=jnp.asarray(False),
    )
    final, cost_hist = jax.lax.scan(step, init, None, length=config.max_iters)
    cam_out = res.Rt_to_cams(final.R, final.t)
    info = {"cost0": cost0, "cost": final.cost, "cost_history": cost_hist, "lam": final.lam}
    return cam_out, final.points, info


# ---------------------------------------------------------------------------
# Batched motion-only BA (tracking fast path)
# ---------------------------------------------------------------------------


class MotionOnlyConfig(NamedTuple):
    outer_iters: int = 4  # reference SfMHelper.cpp:112 (4 outer)
    inner_iters: int = 10  # reference uses 20 Ceres its; LM with exact 6x6 needs fewer
    lam0: float = 1e-3
    chi2_max: float = res.CHI2_2D
    robust: bool = True


def _motion_residuals(K4, R, t, X, uv, sigma2, valid, robust):
    """Residuals + Jacobian wrt a single camera.  X:[M,3] fixed points."""
    x_cam = mm(X, R.T) + t
    z = x_cam[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    inv_z = 1.0 / zs
    u = fx * x_cam[:, 0] * inv_z + cx
    v = fy * x_cam[:, 1] * inv_z + cy
    inv_sigma = 1.0 / jnp.sqrt(jnp.maximum(sigma2, 1e-12))
    r = jnp.stack([u - uv[:, 0], v - uv[:, 1]], -1) * inv_sigma[:, None]
    zero = jnp.zeros_like(inv_z)
    duv_dx = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x_cam[:, 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * x_cam[:, 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    ) * inv_sigma[:, None, None]
    RX = mm(X, R.T)
    RXx, RXy, RXz = RX[:, 0], RX[:, 1], RX[:, 2]
    zeros = jnp.zeros_like(RXx)
    neg_skew = jnp.stack(
        [
            jnp.stack([zeros, RXz, -RXy], -1),
            jnp.stack([-RXz, zeros, RXx], -1),
            jnp.stack([RXy, -RXx, zeros], -1),
        ],
        axis=-2,
    )
    Jc = jnp.concatenate([mm(duv_dx, neg_skew), duv_dx], axis=-1)  # [M,2,6]
    mask = valid & (z > 1e-6)
    w = jnp.where(mask, 1.0, 0.0)
    if robust:
        w = w * res.huber_weights(r)
    sw = jnp.sqrt(w)
    return r * sw[:, None], Jc * sw[:, None, None], mask


def _motion_cost(K4, R, t, X, uv, sigma2, valid, robust):
    x_cam = mm(X, R.T) + t
    z = x_cam[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K4[0] * x_cam[:, 0] / zs + K4[2]
    v = K4[1] * x_cam[:, 1] / zs + K4[3]
    r2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / jnp.maximum(sigma2, 1e-12)
    if robust:
        d = res.HUBER_DELTA
        nrm = jnp.sqrt(jnp.maximum(r2, 1e-20))
        rho = jnp.where(nrm <= d, 0.5 * r2, d * (nrm - 0.5 * d))
    else:
        rho = 0.5 * r2
    rho = jnp.where(z > 1e-6, rho, CHEIRALITY_PENALTY)
    return jnp.sum(jnp.where(valid, rho, 0.0))


def _motion_only_single(K4, rt6, X, uv, sigma2, valid, cfg: MotionOnlyConfig):
    """4-outer x LM-inner motion-only BA for ONE camera (vmapped over batch)."""
    R0 = aa_to_rotmat(rt6[:3])
    t0 = rt6[3:]

    def outer(carry, _):
        R, t, valid_cur = carry

        def inner(state, _):
            R_i, t_i, lam, nu, cost, done = state
            r, Jc, _m = _motion_residuals(K4, R_i, t_i, X, uv, sigma2, valid_cur, cfg.robust)
            H = einsum("mri,mrj->ij", Jc, Jc)
            g = einsum("mri,mr->i", Jc, r)
            dH = jnp.clip(jnp.diag(H), 1e-6, None)
            Hd = H + lam * jnp.diag(dH)
            dx = -jnp.linalg.solve(Hd + 1e-9 * jnp.eye(6), g)
            R_new = mm(aa_to_rotmat(dx[:3]), R_i)
            t_new = t_i + dx[3:]
            c_new = _motion_cost(K4, R_new, t_new, X, uv, sigma2, valid_cur, cfg.robust)
            accept = (c_new < cost) & jnp.isfinite(c_new)
            sel = lambda a, b: jnp.where(accept & ~done, a, b)
            return (
                sel(R_new, R_i),
                sel(t_new, t_i),
                jnp.where(done, lam, jnp.where(accept, lam / 3.0, lam * nu)),
                jnp.where(done, nu, jnp.where(accept, 2.0, nu * 2.0)),
                sel(c_new, cost),
                done,
            ), None

        c0 = _motion_cost(K4, R, t, X, uv, sigma2, valid_cur, cfg.robust)
        init = (R, t, jnp.asarray(cfg.lam0), jnp.asarray(2.0), c0, jnp.asarray(False))
        (R, t, _, _, _, _), _ = jax.lax.scan(inner, init, None, length=cfg.inner_iters)

        # chi2 prune between outer rounds (reference Optimizer.cpp:417-457)
        x_cam = mm(X, R.T) + t
        z = x_cam[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = K4[0] * x_cam[:, 0] / zs + K4[2]
        v = K4[1] * x_cam[:, 1] / zs + K4[3]
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / jnp.maximum(sigma2, 1e-12)
        valid_new = valid & (chi2 <= cfg.chi2_max) & (z > 1e-6)
        # keep optimizing with pruned set, but never un-prune original invalids
        return (R, t, valid_new), None

    (R, t, valid_final), _ = jax.lax.scan(outer, (R0, t0, valid), None, length=cfg.outer_iters)
    return jnp.concatenate([rotmat_to_aa(R), t]), valid_final


@partial(jax.jit, static_argnames=("cfg",))
def motion_only_ba(K4, cam_rt6, points, uv, sigma2, valid, cfg=MotionOnlyConfig()):
    """Batched motion-only BA.

    Args:
      K4: [4]; cam_rt6: [B, 6] initial world->camera extrinsics;
      points: [B, M, 3] fixed landmarks per camera; uv: [B, M, 2];
      sigma2: [B, M]; valid: [B, M].
    Returns (cam_rt6' [B,6], inlier_mask [B,M]).
    """
    fn = jax.vmap(partial(_motion_only_single, cfg=cfg), in_axes=(None, 0, 0, 0, 0, 0))
    return fn(K4, cam_rt6, points, uv, sigma2, valid)
