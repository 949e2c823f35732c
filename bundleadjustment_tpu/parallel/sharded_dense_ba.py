"""Distributed dense-layout BA: the single-device dense engine, sharded.

`parallel/sharded_ba.py` distributes the *flat* observation-table engine
with its segment_sum scatters.
This module shards the **dense landmark-major** engine
(`solvers/dense_ba.py`) instead: the [L, O] landmark blocks split across the
mesh axis, every point-side quantity stays device-local and scatter-free,
and the camera-side one-hot contractions produce per-shard partials that
are `psum`-reduced — the same communication profile as the flat sharded
engine (traffic ~ cameras) with the dense engine's per-device speed.

Solvers: exact DENSE_SCHUR (the replicated [6K,6K] reduced camera system is
assembled from psummed per-shard QQ^T partials, then Cholesky-solved on every
device) or matrix-free Schur + block-Jacobi PCG (one [K,6] psum per matvec)
for camera counts where S is too large to replicate.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu.solvers.dense_ba import (
    DenseBAProblem,
    _make_step,
    _to_cm,
    densify_problem,
)
from bundleadjustment_tpu.solvers.lm import LMConfig

AXIS = "shard"


class ShardedDenseBAProblem(NamedTuple):
    """Dense problem with a leading device axis: arrays [D, Ls, ...]."""

    K4: jnp.ndarray
    cam_idx: jnp.ndarray  # [D, Ls, O]
    uv: jnp.ndarray  # [D, Ls, O, 2]
    sigma2: jnp.ndarray  # [D, Ls, O]
    valid: jnp.ndarray  # [D, Ls, O]
    cam_fixed: jnp.ndarray  # [K]
    pt_valid: jnp.ndarray  # [D, Ls]


def shard_dense_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                        points, n_shards, max_obs=16):
    """Round-robin landmark partition of a flat table into sharded dense
    blocks.  Returns (problem, points_sharded [D,Ls,3], shard_of, local_of)."""
    dense, _dropped = densify_problem(
        K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
        np.asarray(points).shape[0], max_obs=max_obs,
    )
    L = np.asarray(points).shape[0]
    shard_of = np.arange(L) % n_shards
    local_of = np.arange(L) // n_shards
    Ls = (L + n_shards - 1) // n_shards

    def scatter(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((n_shards, Ls) + arr.shape[1:], fill, arr.dtype)
        out[shard_of, local_of] = arr
        return out

    prob = ShardedDenseBAProblem(
        K4=dense.K4,
        cam_idx=jnp.asarray(scatter(dense.cam_idx)),
        uv=jnp.asarray(scatter(dense.uv)),
        sigma2=jnp.asarray(scatter(dense.sigma2, 1)),
        valid=jnp.asarray(scatter(dense.valid, False)),
        cam_fixed=dense.cam_fixed,
        pt_valid=jnp.asarray(scatter(np.asarray(dense.pt_valid), False)),
    )
    pts_sharded = jnp.asarray(scatter(np.asarray(points, np.float32)))
    return prob, pts_sharded, shard_of, local_of


def _shard_body(K4, cam_idx, uv, sigma2, valid, cam_fixed, pt_valid,
                points0, R0, t0, config: LMConfig):
    """Whole LM solve for one landmark shard (camera state replicated).

    Reuses the single-device component-major step (`solvers/dense_ba.py`)
    with `lax.psum` as the cross-shard reduction hook: the [K,42] block
    reduction, Schur RHS, PCG matvec back-term, and cost are psummed; all
    landmark-side state stays device-local.
    """
    local = DenseBAProblem(
        K4=K4, cam_idx=cam_idx, uv=uv, sigma2=sigma2, valid=valid,
        cam_fixed=cam_fixed, pt_valid=pt_valid,
    )
    cm = _to_cm(local)
    step, eval_assemble = _make_step(
        cm, config, psum=lambda x: jax.lax.psum(x, AXIS))

    Xt0 = points0.T
    cost0, red0, Vu0, gp0, W0 = eval_assemble(R0, t0, Xt0)
    init = (R0, t0, Xt0, jnp.asarray(config.lam0), jnp.asarray(2.0),
            cost0, jnp.asarray(False), red0, Vu0, gp0, W0)
    (R, t, Xt, _, _, cost, _, _, _, _, _), _ = jax.lax.scan(
        step, init, None, length=config.max_iters
    )
    return R, t, Xt.T, cost0, cost


@partial(jax.jit, static_argnames=("config", "mesh"))
def _solve_jit(prob: ShardedDenseBAProblem, cams_rt6, points_sharded, config,
               mesh):
    R0 = aa_to_rotmat(cams_rt6[:, :3])
    t0 = cams_rt6[:, 3:]

    def wrapped(ci, uv, sg, vd, pv, pts):
        R, t, X, cost0, cost = _shard_body(
            prob.K4, ci[0], uv[0], sg[0], vd[0], prob.cam_fixed, pv[0],
            pts[0], R0, t0, config,
        )
        return R, t, X[None], cost0, cost

    shard = P(AXIS)
    rep = P()
    fn = jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(shard,) * 6,
        out_specs=(rep, rep, shard, rep, rep),
    )
    R, t, X, cost0, cost = fn(
        prob.cam_idx, prob.uv, prob.sigma2, prob.valid, prob.pt_valid,
        points_sharded,
    )
    cams = jnp.concatenate([rotmat_to_aa(R), t], -1)
    return cams, X, {"cost0": cost0, "cost": cost}


def _is_multiprocess(mesh):
    return len({d.process_index for d in mesh.devices.flat}) > 1


def sharded_dense_ba_solve(prob, cams_rt6, points_sharded, config=None,
                           mesh=None):
    """Landmark-sharded dense-layout LM solve over a device mesh.

    Works on a multi-process mesh (every process calls with the SAME
    host-global values, jax.distributed initialized — see
    parallel/multihost.py): inputs are device_put with explicit
    NamedShardings so each process places only its addressable shards.
    """
    if config is None:
        config = LMConfig(max_iters=10, solver="pcg")
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (AXIS,))
    cams_rt6 = jnp.asarray(cams_rt6)
    if _is_multiprocess(mesh):
        from jax.sharding import NamedSharding

        shard = NamedSharding(mesh, P(AXIS))
        rep = NamedSharding(mesh, P())
        put = lambda a, s: jax.device_put(np.asarray(a), s)
        prob = ShardedDenseBAProblem(
            K4=put(prob.K4, rep),
            cam_idx=put(prob.cam_idx, shard),
            uv=put(prob.uv, shard),
            sigma2=put(prob.sigma2, shard),
            valid=put(prob.valid, shard),
            cam_fixed=put(prob.cam_fixed, rep),
            pt_valid=put(prob.pt_valid, shard),
        )
        cams_rt6 = put(cams_rt6, rep)
        points_sharded = put(points_sharded, shard)
    return _solve_jit(prob, cams_rt6, points_sharded, config, mesh)
