"""Distributed bundle adjustment: landmark-sharded Schur reduction on a mesh.

The reference is single-process (SURVEY.md §2.3); this module adds
Schur-complement BA over >=100k landmarks sharded across devices.

Sharding layout (SURVEY.md §7 hard part (e)): **landmark-major**.  Every
landmark and ALL of its observations live on exactly one device, so

- V blocks, point gradients, point updates, and back-substitution are fully
  local (zero communication);
- only camera-side reductions cross devices: the damped U blocks / camera
  gradient ([K,6,6] + [K,6]) once per LM iteration, a scalar cost psum per
  accept test, and one [K,6] psum per PCG matvec.

Collective traffic is therefore proportional to the number of *cameras*, not
landmarks — the Schur trick applied to the network, not just the linear
algebra.  Cameras are replicated; the LM control flow (accept/reject, lambda
schedule) computes identically on every device from psum'd scalars, so no
divergence and no host round-trips inside the solve.

Implemented with `shard_map` over a 1-D device mesh + `jax.lax.psum`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu.solvers import residuals as res
from bundleadjustment_tpu.solvers.lm import CHEIRALITY_PENALTY, LMConfig
from bundleadjustment_tpu.solvers.schur import _sym3_inv
from bundleadjustment_tpu.utils.precision import einsum, mm


class ShardedBAProblem(NamedTuple):
    """Observation table partitioned by landmark over a leading shard axis.

    Shapes: [D, ...] where D = number of devices.  pt_idx is LOCAL to the
    shard's points array; cam_idx is global (cameras replicated).
    """

    K4: jnp.ndarray  # [4]
    cam_idx: jnp.ndarray  # [D, Ns] int32
    pt_idx: jnp.ndarray  # [D, Ns] int32 (local)
    uv: jnp.ndarray  # [D, Ns, 2]
    sigma2: jnp.ndarray  # [D, Ns]
    valid: jnp.ndarray  # [D, Ns] bool
    cam_fixed: jnp.ndarray  # [K] bool
    points: jnp.ndarray  # [D, Ls, 3] sharded landmarks
    pt_valid: jnp.ndarray  # [D, Ls] bool (padding mask)
    n_cams: int


def shard_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed, points,
                  n_shards):
    """Host-side partition of a flat BA problem into a ShardedBAProblem.

    Landmarks are dealt round-robin to shards (balances observation counts
    for uniformly-observed maps); per-shard arrays are padded to the max
    shard size so shapes are rectangular.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    sigma2 = np.asarray(sigma2)
    valid = np.asarray(valid)
    points = np.asarray(points)
    L = points.shape[0]

    shard_of_pt = np.arange(L) % n_shards
    local_of_pt = np.arange(L) // n_shards
    Ls = (L + n_shards - 1) // n_shards

    obs_shard = shard_of_pt[pt_idx]
    Ns = 0
    per_shard = []
    for d in range(n_shards):
        sel = np.nonzero((obs_shard == d) & valid)[0]
        per_shard.append(sel)
        Ns = max(Ns, len(sel))
    Ns = max(Ns, 1)

    def pad_field(field, fill, dtype, extra=()):
        out = np.full((n_shards, Ns) + extra, fill, dtype)
        return out

    ci = pad_field(None, 0, np.int32)
    pi = pad_field(None, 0, np.int32)
    uv_s = pad_field(None, 0, np.float32, (2,))
    sg = pad_field(None, 1, np.float32)
    vd = pad_field(None, False, bool)
    pts_s = np.zeros((n_shards, Ls, 3), np.float32)
    pv = np.zeros((n_shards, Ls), bool)
    for d in range(n_shards):
        sel = per_shard[d]
        n = len(sel)
        ci[d, :n] = cam_idx[sel]
        pi[d, :n] = local_of_pt[pt_idx[sel]]
        uv_s[d, :n] = uv[sel]
        sg[d, :n] = sigma2[sel]
        vd[d, :n] = True
        mine = np.nonzero(shard_of_pt == d)[0]
        pts_s[d, : len(mine)] = points[mine]
        pv[d, : len(mine)] = True

    return (
        ShardedBAProblem(
            K4=jnp.asarray(np.asarray(K4, np.float32)),
            cam_idx=jnp.asarray(ci),
            pt_idx=jnp.asarray(pi),
            uv=jnp.asarray(uv_s),
            sigma2=jnp.asarray(sg),
            valid=jnp.asarray(vd),
            cam_fixed=jnp.asarray(np.asarray(cam_fixed, bool)),
            points=jnp.asarray(pts_s),
            pt_valid=jnp.asarray(pv),
            n_cams=0,  # set by caller below
        ),
        shard_of_pt,
        local_of_pt,
    )


def unshard_points(points_sharded, shard_of_pt, local_of_pt):
    """[D, Ls, 3] -> [L, 3] in original landmark order."""
    pts = np.asarray(points_sharded)
    return pts[shard_of_pt, local_of_pt]


# ---------------------------------------------------------------------------
# in-shard math (runs under shard_map; axis name "shard")
# ---------------------------------------------------------------------------

AXIS = "shard"


def _psum(x):
    return jax.lax.psum(x, AXIS)


def _shard_residuals_jacobians(K4, cam_idx, pt_idx, uv, sigma2, valid,
                               cam_fixed, R, t, points, robust):
    """Local residuals + Jacobians (same math as residuals.py, local arrays)."""
    prob = res.BAProblem(
        K4=K4, cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, sigma2=sigma2,
        valid=valid, cam_fixed=cam_fixed,
        pt_fixed=jnp.zeros(points.shape[0], bool),
    )
    return res.residuals_and_jacobians(prob, R, t, points, robust=robust)


def _shard_cost(K4, cam_idx, pt_idx, uv, sigma2, valid, R, t, points, robust):
    prob = res.BAProblem(
        K4=K4, cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, sigma2=sigma2,
        valid=valid, cam_fixed=jnp.zeros(R.shape[0], bool),
        pt_fixed=jnp.zeros(points.shape[0], bool),
    )
    r, z = res.reprojection_residuals(prob, R, t, points)
    nrm2 = jnp.sum(r * r, axis=-1)
    if robust:
        d = res.HUBER_DELTA
        nrm = jnp.sqrt(jnp.maximum(nrm2, 1e-20))
        rho = jnp.where(nrm <= d, 0.5 * nrm2, d * (nrm - 0.5 * d))
    else:
        rho = 0.5 * nrm2
    rho = jnp.where(z > 1e-6, rho, CHEIRALITY_PENALTY)
    local = jnp.sum(jnp.where(valid, rho, 0.0))
    return _psum(local)


def _sharded_lm_body(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                     points0, pt_valid, R0, t0, config: LMConfig):
    """The whole LM solve for one shard (replicated control flow)."""
    n_cams = R0.shape[0]
    Ls = points0.shape[0]
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)

    def build(R, t, points, lam):
        r, Jc, Jp, _ = _shard_residuals_jacobians(
            K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed, R, t, points,
            config.robust,
        )
        U_local = jax.ops.segment_sum(
            einsum("nri,nrj->nij", Jc, Jc), cam_idx, num_segments=n_cams
        )
        g_c_local = jax.ops.segment_sum(
            einsum("nri,nr->ni", Jc, r), cam_idx, num_segments=n_cams
        )
        # cross-device reduction: camera-side quantities only
        U = _psum(U_local)
        g_c = _psum(g_c_local)
        V = jax.ops.segment_sum(
            einsum("nri,nrj->nij", Jp, Jp), pt_idx, num_segments=Ls
        )
        g_p = jax.ops.segment_sum(
            einsum("nri,nr->ni", Jp, r), pt_idx, num_segments=Ls
        )
        W = einsum("nri,nrj->nij", Jc, Jp)

        dU = jnp.clip(jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6, None)
        dV = jnp.clip(jnp.diagonal(V, axis1=-2, axis2=-1), 1e-6, None)
        U = U + (lam * dU)[..., None] * eye6
        V = V + (lam * dV)[..., None] * eye3
        U = jnp.where(cam_fixed[:, None, None], eye6, U)
        V = jnp.where(pt_valid[:, None, None], V, eye3)
        g_c = jnp.where(cam_fixed[:, None], 0.0, g_c)
        V_inv = _sym3_inv(V)
        return U, V_inv, W, g_c, g_p

    def schur_matvec(U, V_inv, W, x):
        Ux = einsum("kij,kj->ki", U, x)
        Wx = einsum("nij,ni->nj", W, x[cam_idx])
        y = jax.ops.segment_sum(Wx, pt_idx, num_segments=Ls)
        z = einsum("lij,lj->li", V_inv, y)
        Wz = einsum("nij,nj->ni", W, z[pt_idx])
        back_local = jax.ops.segment_sum(Wz, cam_idx, num_segments=n_cams)
        return Ux - _psum(back_local)

    def pcg(U, V_inv, W, b):
        Minv = jnp.linalg.inv(U)
        precond = lambda v: einsum("kij,kj->ki", Minv, v)
        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = precond(r0)
        rz0 = jnp.sum(r0 * z0)

        def body(state, _):
            x, rr, p, rz = state
            Sp = schur_matvec(U, V_inv, W, p)
            pSp = jnp.sum(p * Sp)
            alpha = rz / jnp.where(jnp.abs(pSp) < 1e-30, 1e-30, pSp)
            x = x + alpha * p
            rr = rr - alpha * Sp
            zz = precond(rr)
            rz_new = jnp.sum(rr * zz)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
            return (x, rr, zz + beta * p, rz_new), None

        (x, _, _, _), _ = jax.lax.scan(
            body, (x0, r0, z0, rz0), None, length=config.pcg_iters
        )
        return x

    def step(state, _):
        R, t, points, lam, nu, cost, done = state
        U, V_inv, W, g_c, g_p = build(R, t, points, lam)
        # Schur RHS
        z = einsum("lij,lj->li", V_inv, g_p)
        Wz = einsum("nij,nj->ni", W, z[pt_idx])
        red = _psum(jax.ops.segment_sum(Wz, cam_idx, num_segments=n_cams))
        b = -(g_c - red)
        dc = pcg(U, V_inv, W, b)
        # local back-substitution
        Wx = einsum("nij,ni->nj", W, dc[cam_idx])
        y = jax.ops.segment_sum(Wx, pt_idx, num_segments=Ls)
        dp = -einsum("lij,lj->li", V_inv, g_p + y)

        dphi = jnp.where(cam_fixed[:, None], 0.0, dc[:, :3])
        dt = jnp.where(cam_fixed[:, None], 0.0, dc[:, 3:])
        R_new = mm(aa_to_rotmat(dphi), R)
        t_new = t + dt
        pts_new = points + jnp.where(pt_valid[:, None], dp, 0.0)

        new_cost = _shard_cost(
            K4, cam_idx, pt_idx, uv, sigma2, valid, R_new, t_new, pts_new,
            config.robust,
        )
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        sel = lambda a, b2: jnp.where(accept & ~done, a, b2)
        lam_new = jnp.where(
            done, lam, jnp.where(accept, lam / 3.0, lam * nu)
        )
        nu_new = jnp.where(done, nu, jnp.where(accept, 2.0, nu * 2.0))
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done_new = done | (accept & (rel < config.rtol))
        return (
            sel(R_new, R), sel(t_new, t), sel(pts_new, points),
            lam_new, nu_new, sel(new_cost, cost), done_new,
        ), new_cost

    cost0 = _shard_cost(
        K4, cam_idx, pt_idx, uv, sigma2, valid, R0, t0, points0, config.robust
    )
    init = (
        R0, t0, points0,
        jnp.asarray(config.lam0), jnp.asarray(2.0), cost0, jnp.asarray(False),
    )
    (R, t, points, _, _, cost, _), hist = jax.lax.scan(
        step, init, None, length=config.max_iters
    )
    return R, t, points, cost0, cost, hist


@partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_solve_jit(problem: ShardedBAProblem, cams_rt6, config, mesh):
    R0, t0 = res.cams_to_Rt(cams_rt6)

    def per_shard(cam_idx, pt_idx, uv, sigma2, valid, points, pt_valid):
        return _sharded_lm_body(
            problem.K4, cam_idx[0], pt_idx[0], uv[0], sigma2[0], valid[0],
            problem.cam_fixed, points[0], pt_valid[0], R0, t0, config,
        )

    shard = P(AXIS)
    rep = P()

    def wrapped(ci, pi, uv, sg, vd, pts, pv):
        R, t, points, cost0, cost, hist = per_shard(ci, pi, uv, sg, vd, pts, pv)
        # points are landmark-sharded: re-add the leading block dim for the
        # sharded out_spec; everything else is replicated
        return R, t, points[None], cost0, cost, hist

    fn = jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(shard,) * 7,
        out_specs=(rep, rep, shard, rep, rep, rep),
    )
    R, t, points, cost0, cost, hist = fn(
        problem.cam_idx, problem.pt_idx, problem.uv, problem.sigma2,
        problem.valid, problem.points, problem.pt_valid,
    )
    cams_out = res.Rt_to_cams(R, t)
    return cams_out, points, {"cost0": cost0, "cost": cost, "cost_history": hist}


def sharded_ba_solve(problem: ShardedBAProblem, cams_rt6, config=None, mesh=None):
    """Run the landmark-sharded LM solve over a device mesh.

    Args:
      problem: from `shard_problem` (leading dim == mesh size).
      cams_rt6: [K, 6] replicated camera extrinsics.
      config: LMConfig (solver is always matrix-free PCG here).
      mesh: jax.sharding.Mesh with one axis named "shard"; defaults to all
        devices.
    Returns (cams [K,6], points_sharded [D,Ls,3], info).
    """
    if config is None:
        config = LMConfig(max_iters=10, solver="pcg")
    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs, (AXIS,))
    return _sharded_solve_jit(problem, jnp.asarray(cams_rt6), config, mesh)
