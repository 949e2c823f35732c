"""Pose-graph optimization: stitching local windows into a global trajectory.

The reference has nothing like this (single global BA only); BASELINE.json's
north star calls for "a pose-graph layer stitching local windows into a
global trajectory" for the multi-host configuration.  Design:

- nodes: keyframe extrinsics (world->camera rt6), [K, 6];
- edges: measured relative transforms Z_ij ~ T_i o T_j^-1 with scalar
  weights (e.g. covisibility counts or window-solve confidences);
- residual per edge: r_ij = log( Z_ij^-1 o (T_i o T_j^-1) )  in R^6
  (rotation log + translation difference — the standard chordal-ish
  parameterization);
- Gauss-Newton with per-edge Jacobians from forward-mode autodiff (vmap over
  edges — each is a tiny 6x12 system, perfectly batched), assembled with
  segment_sum into block-sparse normal equations, solved matrix-free by
  Jacobi-preconditioned CG.  Node 0 is the gauge anchor.

Everything is fixed-shape: edges are padded with a validity mask.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import (
    aa_to_rotmat,
    rotmat_to_aa,
)
from bundleadjustment_tpu.utils.precision import einsum, mm


class PoseGraph(NamedTuple):
    edge_i: jnp.ndarray  # [E] int32
    edge_j: jnp.ndarray  # [E] int32
    rel: jnp.ndarray  # [E, 6] measured T_i o T_j^-1
    weight: jnp.ndarray  # [E]
    valid: jnp.ndarray  # [E] bool
    node_fixed: jnp.ndarray  # [K] bool


def _edge_residual(Ti, Tj, Zij):
    """r = log(Z^-1 o (Ti o Tj^-1)) as [6] (aa, t)."""
    Ri = aa_to_rotmat(Ti[:3])
    Rj = aa_to_rotmat(Tj[:3])
    Rz = aa_to_rotmat(Zij[:3])
    # T_i o T_j^-1
    R_ij = mm(Ri, Rj.T)
    t_ij = Ti[3:] - mm(R_ij, Tj[3:])
    # Z^-1 o that
    R_e = mm(Rz.T, R_ij)
    t_e = mm(Rz.T, t_ij - Zij[3:])
    return jnp.concatenate([rotmat_to_aa(R_e), t_e])


def _edge_residual_local(xi, xj, Ti, Tj, Zij):
    """Residual as a function of local left-perturbations xi, xj in R^6."""
    Ti2 = jnp.concatenate(
        [rotmat_to_aa(mm(aa_to_rotmat(xi[:3]), aa_to_rotmat(Ti[:3]))), Ti[3:] + xi[3:]]
    )
    Tj2 = jnp.concatenate(
        [rotmat_to_aa(mm(aa_to_rotmat(xj[:3]), aa_to_rotmat(Tj[:3]))), Tj[3:] + xj[3:]]
    )
    return _edge_residual(Ti2, Tj2, Zij)


@partial(jax.jit, static_argnames=("max_iters", "cg_iters"))
def solve_pose_graph(graph: PoseGraph, poses0, max_iters=20, cg_iters=50,
                     lam0=1e-6):
    """LM pose-graph solve.  poses0: [K, 6] initial extrinsics.  Returns
    (poses [K, 6], info)."""
    K = poses0.shape[0]
    E = graph.edge_i.shape[0]
    zero6 = jnp.zeros(6)

    def residuals(poses):
        Ti = poses[graph.edge_i]
        Tj = poses[graph.edge_j]
        r = jax.vmap(_edge_residual)(Ti, Tj, graph.rel)
        w = jnp.where(graph.valid, graph.weight, 0.0)
        return r * jnp.sqrt(w)[:, None], w

    def jacobians(poses):
        Ti = poses[graph.edge_i]
        Tj = poses[graph.edge_j]

        def per_edge(ti, tj, z):
            Ji = jax.jacfwd(lambda x: _edge_residual_local(x, zero6, ti, tj, z))(zero6)
            Jj = jax.jacfwd(lambda x: _edge_residual_local(zero6, x, ti, tj, z))(zero6)
            return Ji, Jj

        Ji, Jj = jax.vmap(per_edge)(Ti, Tj, graph.rel)
        w = jnp.where(graph.valid, graph.weight, 0.0)
        sw = jnp.sqrt(w)[:, None, None]
        Ji = Ji * sw
        Jj = Jj * sw
        fix_i = graph.node_fixed[graph.edge_i]
        fix_j = graph.node_fixed[graph.edge_j]
        Ji = jnp.where(fix_i[:, None, None], 0.0, Ji)
        Jj = jnp.where(fix_j[:, None, None], 0.0, Jj)
        return Ji, Jj

    def cost_of(poses):
        r, w = residuals(poses)
        return jnp.sum(r * r)

    def step(state, _):
        poses, lam, nu, cost, done = state
        r, _w = residuals(poses)
        Ji, Jj = jacobians(poses)

        # gradient: g = J^T r scattered to nodes
        gi = einsum("eri,er->ei", Ji, r)
        gj = einsum("eri,er->ei", Jj, r)
        g = jax.ops.segment_sum(gi, graph.edge_i, num_segments=K) + \
            jax.ops.segment_sum(gj, graph.edge_j, num_segments=K)

        # block-diagonal (for damping + preconditioner)
        Hii = einsum("eri,erj->eij", Ji, Ji)
        Hjj = einsum("eri,erj->eij", Jj, Jj)
        D = jax.ops.segment_sum(Hii, graph.edge_i, num_segments=K) + \
            jax.ops.segment_sum(Hjj, graph.edge_j, num_segments=K)
        eye6 = jnp.eye(6)
        dD = jnp.clip(jnp.diagonal(D, axis1=-2, axis2=-1), 1e-8, None)
        D_damped = D + (lam * dD)[..., None] * eye6
        D_damped = jnp.where(graph.node_fixed[:, None, None], eye6, D_damped)
        Minv = jnp.linalg.inv(D_damped)

        def matvec(x):
            xi = x[graph.edge_i]
            xj = x[graph.edge_j]
            yi = einsum("eri,ei->er", Ji, xi) + einsum("eri,ei->er", Jj, xj)
            zi = einsum("eri,er->ei", Ji, yi)
            zj = einsum("eri,er->ei", Jj, yi)
            out = jax.ops.segment_sum(zi, graph.edge_i, num_segments=K) + \
                jax.ops.segment_sum(zj, graph.edge_j, num_segments=K)
            # Marquardt damping + gauge pinning
            out = out + (lam * dD) * x
            return jnp.where(graph.node_fixed[:, None], x, out)

        b = jnp.where(graph.node_fixed[:, None], 0.0, -g)

        def cg_body(s, _):
            x, rr, p, rz = s
            Ap = matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = einsum("kij,kj->ki", Minv, rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
            return (x, rr, z + beta * p, rz_new), None

        x0 = jnp.zeros_like(b)
        z0 = einsum("kij,kj->ki", Minv, b)
        (dx, _, _, _), _ = jax.lax.scan(
            cg_body, (x0, b, z0, jnp.sum(b * z0)), None, length=cg_iters
        )

        dphi = jnp.where(graph.node_fixed[:, None], 0.0, dx[:, :3])
        dt = jnp.where(graph.node_fixed[:, None], 0.0, dx[:, 3:])
        R_new = mm(aa_to_rotmat(dphi), aa_to_rotmat(poses[:, :3]))
        poses_new = jnp.concatenate([rotmat_to_aa(R_new), poses[:, 3:] + dt], -1)

        new_cost = cost_of(poses_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        sel = lambda a, b2: jnp.where(accept & ~done, a, b2)
        rel_dec = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        return (
            sel(poses_new, poses),
            jnp.where(done, lam, jnp.where(accept, lam / 3.0, lam * nu)),
            jnp.where(done, nu, jnp.where(accept, 2.0, nu * 2.0)),
            sel(new_cost, cost),
            done | (accept & (rel_dec < 1e-10)),
        ), new_cost

    cost0 = cost_of(poses0)
    init = (poses0, jnp.asarray(lam0), jnp.asarray(2.0), cost0, jnp.asarray(False))
    (poses, _, _, cost, _), hist = jax.lax.scan(step, init, None, length=max_iters)
    return poses, {"cost0": cost0, "cost": cost, "cost_history": hist}


def build_odometry_graph(poses, loop_edges=None, odo_weight=1.0,
                         loop_weight=1.0, node_fixed=None):
    """Helper: sequential odometry edges (i, i+1) from current pose estimates,
    plus optional loop-closure edges [(i, j, rel6, w)]."""
    import numpy as np

    poses = np.asarray(poses)
    K = len(poses)
    from bundleadjustment_tpu.geometry import np_se3

    ei, ej, rel, w = [], [], [], []
    for i in range(K - 1):
        ei.append(i)
        ej.append(i + 1)
        rel.append(np_se3.rt6_compose(poses[i], np_se3.rt6_inverse(poses[i + 1])))
        w.append(odo_weight)
    if loop_edges:
        for (i, j, r, lw) in loop_edges:
            ei.append(i)
            ej.append(j)
            rel.append(np.asarray(r))
            w.append(lw if lw is not None else loop_weight)
    E = len(ei)
    fixed = np.zeros(K, bool)
    if node_fixed is None:
        fixed[0] = True
    else:
        fixed[:] = node_fixed
    return PoseGraph(
        edge_i=jnp.asarray(np.asarray(ei, np.int32)),
        edge_j=jnp.asarray(np.asarray(ej, np.int32)),
        rel=jnp.asarray(np.asarray(rel, np.float32)),
        weight=jnp.asarray(np.asarray(w, np.float32)),
        valid=jnp.ones(E, bool),
        node_fixed=jnp.asarray(fixed),
    )
