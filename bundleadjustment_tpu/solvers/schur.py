"""Schur-complement normal equations for bundle adjustment.

Replaces Ceres' LM + DENSE_SCHUR configuration (reference
`ba_project/src/ba/Optimizer.cpp:80-90`).  The normal equations

    [ U   W ] [dc]   [-g_c]
    [ W^T V ] [dp] = [-g_p]

are reduced onto the camera block:  S dc = b  with

    S = U - W V^{-1} W^T,     b = -(g_c - W V^{-1} g_p)

and back-substitution  dp = -V^{-1} (g_p + W^T dc).

Everything is built with `jax.ops.segment_sum` over the flat observation table
— no sparse matrix structures, no per-landmark loops.  Two solve modes:

- **dense**: materialize S ([6K, 6K]) by applying the matrix-free operator to
  the identity (vmapped), then Cholesky.  Exact; right for K up to a few
  hundred cameras — same regime where Ceres uses DENSE_SCHUR.
- **pcg**: matrix-free preconditioned conjugate gradient on S with a
  block-Jacobi (per-camera 6x6) preconditioner.  Scales to large K and is the
  unit that distributes across a device mesh (see
  `bundleadjustment_tpu/parallel/sharded_ba.py`): per-shard partial U/V/W
  products are `psum`-reduced across devices.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.utils.precision import einsum


class BABlocks(NamedTuple):
    U: jnp.ndarray  # [K, 6, 6] camera Hessian blocks (damped)
    V_inv: jnp.ndarray  # [L, 3, 3] inverted damped point blocks
    W: jnp.ndarray  # [N, 6, 3] per-observation camera-point coupling
    g_c: jnp.ndarray  # [K, 6] camera gradient
    g_p: jnp.ndarray  # [L, 3] point gradient
    cam_idx: jnp.ndarray  # [N]
    pt_idx: jnp.ndarray  # [N]


def _sym3_inv(V):
    """Batched closed-form 3x3 symmetric inverse via adjugate (no LU)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e = V[..., 1, 1], V[..., 1, 2]
    f = V[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], -1),
            jnp.stack([B, D, E], -1),
            jnp.stack([C, E, F], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def build_blocks(r, Jc, Jp, cam_idx, pt_idx, n_cams, n_pts, lam, cam_fixed, pt_fixed):
    """Assemble damped Schur blocks from per-observation residuals/Jacobians.

    Damping is Marquardt-style (lam * diag(H), floored), matching Ceres'
    default trust-region scaling.  Fixed/empty camera and point blocks get
    identity so the solves stay well-posed (their gradients are zero, so their
    increments come out exactly zero).
    """
    # per-observation blocks
    Uc = einsum("nri,nrj->nij", Jc, Jc)  # [N,6,6]
    Vp = einsum("nri,nrj->nij", Jp, Jp)  # [N,3,3]
    W = einsum("nri,nrj->nij", Jc, Jp)  # [N,6,3]
    gc = einsum("nri,nr->ni", Jc, r)  # [N,6]
    gp = einsum("nri,nr->ni", Jp, r)  # [N,3]

    U = jax.ops.segment_sum(Uc, cam_idx, num_segments=n_cams)
    V = jax.ops.segment_sum(Vp, pt_idx, num_segments=n_pts)
    g_c = jax.ops.segment_sum(gc, cam_idx, num_segments=n_cams)
    g_p = jax.ops.segment_sum(gp, pt_idx, num_segments=n_pts)

    eye6 = jnp.eye(6, dtype=U.dtype)
    eye3 = jnp.eye(3, dtype=V.dtype)
    # Marquardt damping on diagonals (with absolute floor for stability)
    dU = jnp.clip(jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6, None)
    dV = jnp.clip(jnp.diagonal(V, axis1=-2, axis2=-1), 1e-6, None)
    U = U + (lam * dU)[..., None] * eye6
    V = V + (lam * dV)[..., None] * eye3

    U = jnp.where(cam_fixed[:, None, None], eye6, U)
    V = jnp.where(pt_fixed[:, None, None], eye3, V)
    g_c = jnp.where(cam_fixed[:, None], 0.0, g_c)
    g_p = jnp.where(pt_fixed[:, None], 0.0, g_p)

    return BABlocks(U, _sym3_inv(V), W, g_c, g_p, cam_idx, pt_idx)


def schur_matvec(blocks, x):
    """S @ x for x [K, 6], matrix-free:  Ux - W V^{-1} W^T x.

    All gathers/scatters ride segment ops — the same code path shards over a
    mesh axis by psum-ing the two segment_sums (see parallel/sharded_ba.py).
    """
    Ux = einsum("kij,kj->ki", blocks.U, x)
    # y_l = sum_{o in obs(l)} W_o^T x_{cam(o)}
    Wx = einsum("nij,ni->nj", blocks.W, x[blocks.cam_idx])  # [N,3]
    y = jax.ops.segment_sum(Wx, blocks.pt_idx, num_segments=blocks.V_inv.shape[0])
    z = einsum("lij,lj->li", blocks.V_inv, y)  # [L,3]
    Wz = einsum("nij,nj->ni", blocks.W, z[blocks.pt_idx])  # [N,6]
    back = jax.ops.segment_sum(Wz, blocks.cam_idx, num_segments=x.shape[0])
    return Ux - back


def schur_rhs(blocks):
    """b = -(g_c - W V^{-1} g_p)."""
    z = einsum("lij,lj->li", blocks.V_inv, blocks.g_p)
    Wz = einsum("nij,nj->ni", blocks.W, z[blocks.pt_idx])
    red = jax.ops.segment_sum(Wz, blocks.cam_idx, num_segments=blocks.g_c.shape[0])
    return -(blocks.g_c - red)


def back_substitute(blocks, dc):
    """dp = -V^{-1} (g_p + W^T dc)."""
    Wx = einsum("nij,ni->nj", blocks.W, dc[blocks.cam_idx])
    y = jax.ops.segment_sum(Wx, blocks.pt_idx, num_segments=blocks.V_inv.shape[0])
    return -einsum("lij,lj->li", blocks.V_inv, blocks.g_p + y)


def solve_schur_dense(blocks):
    """Materialize S and Cholesky-solve.  Exact (the DENSE_SCHUR analogue)."""
    K = blocks.U.shape[0]
    eye = jnp.eye(K * 6, dtype=blocks.U.dtype)
    cols = jax.vmap(lambda e: schur_matvec(blocks, e.reshape(K, 6)).reshape(-1))(eye)
    S = cols.T  # symmetric, so orientation is cosmetic
    b = schur_rhs(blocks).reshape(-1)
    # small diagonal lift for numerical safety
    S = S + 1e-8 * eye
    dc = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), b)
    return dc.reshape(K, 6)


@partial(jax.jit, static_argnames=("max_iters",))
def _pcg(blocks, b, Minv, max_iters, tol):
    """Block-Jacobi preconditioned CG on the Schur complement."""

    def precond(v):
        return einsum("kij,kj->ki", Minv, v)

    def dot(a, c):
        return jnp.sum(a * c)

    x0 = jnp.zeros_like(b)
    r0 = b  # x0 = 0
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    b_norm = jnp.sqrt(dot(b, b)) + 1e-30

    def body(state, _):
        x, r, p, rz = state
        Sp = schur_matvec(blocks, p)
        pSp = dot(p, Sp)
        alpha = rz / jnp.where(jnp.abs(pSp) < 1e-30, 1e-30, pSp)
        x_new = x + alpha * p
        r_new = r - alpha * Sp
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p_new = z_new + beta * p
        converged = jnp.sqrt(dot(r_new, r_new)) / b_norm < tol
        # freeze once converged
        keep = lambda new, old: jnp.where(converged, old, new)
        return (keep(x_new, x_new), keep(r_new, r_new), keep(p_new, p_new), rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, p0, rz0), None, length=max_iters)
    return x


def solve_schur_pcg(blocks, max_iters=50, tol=1e-6):
    """Matrix-free PCG solve of S dc = b with block-Jacobi preconditioning."""
    b = schur_rhs(blocks)
    # preconditioner: inverse of the damped per-camera 6x6 diagonal blocks
    Minv = jnp.linalg.inv(blocks.U)
    return _pcg(blocks, b, Minv, max_iters, tol)
