"""Depth-map back-projection + finite-difference normals, on device.

Array-form replacement for the OpenMP back-projection loops in the reference
(`ba_project/src/model/PointCloud.h:46-135`): the whole depth map deprojects
in one fused elementwise computation; normals come from central differences
of neighboring camera-space points (`PointCloud.h:87-135` semantics: invalid
if any neighbor is invalid)."""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.projection import backproject, pixel_grid


@partial(jax.jit, static_argnames=())
def _backproject_core(K4, depth, cam_to_world):
    h, w = depth.shape
    uv = pixel_grid(h, w, depth.dtype)
    valid = jnp.isfinite(depth) & (depth > 0)
    d = jnp.where(valid, depth, 1.0)
    xc = backproject(K4, uv, d)  # [H, W, 3] camera frame
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    xw = xc @ R.T + t
    return xw, xc, valid


def backproject_depth(K4, depth, cam_to_world=None, stride=1):
    """Depth map -> (points_world [M,3], valid [M]) flattened with stride."""
    if cam_to_world is None:
        cam_to_world = np.eye(4, dtype=np.float32)
    xw, _, valid = _backproject_core(
        jnp.asarray(K4), jnp.asarray(depth), jnp.asarray(cam_to_world, jnp.float32)
    )
    xw = np.asarray(xw)[::stride, ::stride].reshape(-1, 3)
    valid = np.asarray(valid)[::stride, ::stride].reshape(-1)
    return xw, valid


@jax.jit
def _normals_core(K4, depth):
    h, w = depth.shape
    uv = pixel_grid(h, w, depth.dtype)
    valid = jnp.isfinite(depth) & (depth > 0)
    d = jnp.where(valid, depth, 1.0)
    xc = backproject(K4, uv, d)
    dx = jnp.roll(xc, -1, axis=1) - jnp.roll(xc, 1, axis=1)
    dy = jnp.roll(xc, -1, axis=0) - jnp.roll(xc, 1, axis=0)
    n = jnp.cross(dy, dx)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    ok = (
        valid
        & jnp.roll(valid, 1, 0) & jnp.roll(valid, -1, 0)
        & jnp.roll(valid, 1, 1) & jnp.roll(valid, -1, 1)
    )
    # border pixels have wrapped neighbors -> invalid
    ok = ok.at[0, :].set(False).at[-1, :].set(False)
    ok = ok.at[:, 0].set(False).at[:, -1].set(False)
    return n, ok


def depth_normals(K4, depth):
    """[H,W] depth -> (normals [H,W,3] camera frame, valid [H,W])."""
    n, ok = _normals_core(jnp.asarray(K4), jnp.asarray(depth))
    return np.asarray(n), np.asarray(ok)
