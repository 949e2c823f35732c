"""Pinhole camera projection / back-projection.

Intrinsics are packed as a 4-vector ``[fx, fy, cx, cy]`` (no distortion — both
reference datasets are pre-rectified; reference hardcodes the same model at
`ba_project/src/data/VirtualSensor.h:100-116,154-164`).

Conventions (matching the reference, `ba_project/src/ba/Optimizer.h:62-78`):
- "extrinsic" maps world -> camera: ``x_cam = R x_world + t``;
- "pose" (camera -> world) is its inverse — stored at the map level;
- projection: ``u = fx * x/z + cx``, ``v = fy * y/z + cy``.
"""

from __future__ import annotations

import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu.utils.precision import einsum


def make_intrinsics(fx, fy, cx, cy, dtype=jnp.float32):
    return jnp.array([fx, fy, cx, cy], dtype=dtype)


def intrinsics_matrix(K4):
    """[..., 4] -> [..., 3, 3]."""
    K4 = jnp.asarray(K4)
    fx, fy, cx, cy = K4[..., 0], K4[..., 1], K4[..., 2], K4[..., 3]
    zeros = jnp.zeros_like(fx)
    ones = jnp.ones_like(fx)
    return jnp.stack(
        [
            jnp.stack([fx, zeros, cx], axis=-1),
            jnp.stack([zeros, fy, cy], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )


def project(K4, x_cam, eps=1e-9):
    """Project camera-frame points: [..., 4], [..., 3] -> (uv [..., 2], z [...]).

    z <= 0 points still produce finite uv (guarded divide); callers gate on the
    returned depth (cheirality), as the reference does at
    `ba_project/src/ba/SfMHelper.cpp:806-858`.
    """
    z = x_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
    u = K4[..., 0] * x_cam[..., 0] / zs + K4[..., 2]
    v = K4[..., 1] * x_cam[..., 1] / zs + K4[..., 3]
    return jnp.stack([u, v], axis=-1), z


def project_rt(K4, rt_extr, x_world):
    """Project world points through an rt6 extrinsic. Returns (uv, depth)."""
    R = aa_to_rotmat(rt_extr[..., :3])
    x_cam = einsum("...ij,...j->...i", R, x_world) + rt_extr[..., 3:]
    return project(K4, x_cam)


def backproject(K4, uv, depth):
    """Pixel + depth -> camera-frame 3D point.  [...,4],[...,2],[...] -> [...,3].

    Mirrors the reference's deprojection `ba_project/src/ba/Initializer.cpp:61-66`
    and `src/model/PointCloud.h:46-135`.
    """
    x = (uv[..., 0] - K4[..., 2]) / K4[..., 0] * depth
    y = (uv[..., 1] - K4[..., 3]) / K4[..., 1] * depth
    return jnp.stack([x, y, depth], axis=-1)


def pixel_grid(height, width, dtype=jnp.float32):
    """[H, W, 2] grid of (u, v) pixel coordinates."""
    v, u = jnp.meshgrid(
        jnp.arange(height, dtype=dtype), jnp.arange(width, dtype=dtype), indexing="ij"
    )
    return jnp.stack([u, v], axis=-1)
