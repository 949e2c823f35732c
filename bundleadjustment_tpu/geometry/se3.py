"""SO(3)/SE(3) utilities on axis-angle ("rt6") parameterizations.

An ``rt6`` is a 6-vector ``[rvec(3), tvec(3)]`` encoding the rigid transform
``x -> R(rvec) @ x + tvec``.  This is the same parameterization the reference
uses for its Ceres "Angles" cost functors (reference
`ba_project/src/ba/Optimizer.h:49-88`, `Optimizer.cpp:296-299`), but here every
op is a pure jittable function that broadcasts over leading batch dimensions,
and pose updates during optimization are applied as *left multiplicative*
perturbations ``R <- exp([dphi]x) @ R`` (a proper manifold retraction rather
than the reference's Cayley re-orthonormalization hack,
`Optimizer.cpp:143-145`).

All functions accept arbitrary leading batch dims; internally they are written
for unbatched inputs and rely on broadcasting-friendly formulations (no
`jnp.vectorize` overhead on the hot path).
"""

from __future__ import annotations

import jax.numpy as jnp

from bundleadjustment_tpu.utils.precision import einsum, mm

_EPS = 1e-8


def skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    w = jnp.asarray(w)
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def aa_to_rotmat(rvec):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues).

    Small-angle safe: uses Taylor-stable sinc-style coefficients so it is
    differentiable through rvec = 0.
    """
    rvec = jnp.asarray(rvec)
    theta2 = jnp.sum(rvec * rvec, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # a = sin(t)/t, b = (1-cos(t))/t^2; near 0 use Taylor via the eps-guarded theta
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / (theta * theta)
    K = skew(rvec)
    KK = mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def rotmat_to_aa(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Robust log map: angle from trace, axis from the skew part, with a
    quaternion-style fallback for angles near pi (where the skew part vanishes).
    """
    R = jnp.asarray(R)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # skew part: v = [R32-R23, R13-R31, R21-R12] = 2 sin(theta) * axis
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    # generic branch: axis = v / (2 sin t)
    small = sin_t < 1e-5
    scale_generic = theta / jnp.where(small, 1.0, 2.0 * sin_t)
    aa_generic = v * scale_generic[..., None]
    # near-pi branch: axis^2 from diagonal: R = 2 aa^T aa - I + cos-ish terms
    # diag(R) = cos t + (1-cos t) axis_i^2  ->  axis_i^2 = (R_ii - cos t)/(1-cos t)
    denom = jnp.where(jnp.abs(1.0 - cos_t) < 1e-9, 1.0, 1.0 - cos_t)
    axis2 = jnp.clip(
        (jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1) - cos_t[..., None])
        / denom[..., None],
        0.0,
        1.0,
    )
    axis_abs = jnp.sqrt(axis2)
    # signs from the symmetric off-diagonal part (valid near pi where sin t ~ 0):
    # R + R^T has off-diagonals 2(1-cos t) a_i a_j -> sign(a_i a_j)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    # pick the largest |axis| component positive, derive others' signs
    ax = axis_abs[..., 0]
    ay = axis_abs[..., 1]
    az = axis_abs[..., 2]
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    syz = R[..., 1, 2] + R[..., 2, 1]
    sign = jnp.sign
    axis_pi = jnp.where(
        x_major[..., None],
        jnp.stack([ax, sign(sxy) * ay, sign(sxz) * az], axis=-1),
        jnp.where(
            y_major[..., None],
            jnp.stack([sign(sxy) * ax, ay, sign(syz) * az], axis=-1),
            jnp.stack([sign(sxz) * ax, sign(syz) * ay, az], axis=-1),
        ),
    )
    aa_pi = axis_pi * theta[..., None]
    near_pi = cos_t < -1.0 + 1e-5
    # tiny angle: aa ~ v/2 (first order)
    aa_tiny = 0.5 * v
    tiny = theta < 1e-6
    return jnp.where(tiny[..., None], aa_tiny, jnp.where(near_pi[..., None], aa_pi, aa_generic))


def rt6_identity(dtype=jnp.float32):
    return jnp.zeros((6,), dtype=dtype)


def rt6_apply(rt, x):
    """Apply transform: [..., 6], [..., 3] -> [..., 3]."""
    R = aa_to_rotmat(rt[..., :3])
    return einsum("...ij,...j->...i", R, x) + rt[..., 3:]


def rt6_inverse(rt):
    """Inverse transform: R^T, -R^T t."""
    R = aa_to_rotmat(rt[..., :3])
    t = rt[..., 3:]
    Rt = jnp.swapaxes(R, -1, -2)
    return jnp.concatenate(
        [rotmat_to_aa(Rt), -einsum("...ij,...j->...i", Rt, t)], axis=-1
    )


def rt6_compose(a, b):
    """Compose: result applies b first then a  (x -> Ra (Rb x + tb) + ta)."""
    Ra = aa_to_rotmat(a[..., :3])
    Rb = aa_to_rotmat(b[..., :3])
    R = mm(Ra, Rb)
    t = einsum("...ij,...j->...i", Ra, b[..., 3:]) + a[..., 3:]
    return jnp.concatenate([rotmat_to_aa(R), t], axis=-1)


def rt6_to_mat44(rt):
    """[..., 6] -> [..., 4, 4] homogeneous matrix."""
    rt = jnp.asarray(rt)
    R = aa_to_rotmat(rt[..., :3])
    t = rt[..., 3:]
    batch = rt.shape[:-1]
    M = jnp.zeros(batch + (4, 4), dtype=rt.dtype)
    M = M.at[..., :3, :3].set(R)
    M = M.at[..., :3, 3].set(t)
    M = M.at[..., 3, 3].set(1.0)
    return M


def rt6_from_mat44(M):
    """[..., 4, 4] -> [..., 6]."""
    M = jnp.asarray(M)
    return jnp.concatenate([rotmat_to_aa(M[..., :3, :3]), M[..., :3, 3]], axis=-1)
