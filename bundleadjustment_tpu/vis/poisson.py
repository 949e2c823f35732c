"""Poisson surface reconstruction on device.

Replaces PCL's Poisson meshing (reference
`ba_project/src/visualization/SimpleMesh.cpp:414-491`) with a
spectral-solver pipeline that keeps the heavy math on device:

1. normals: chunked k-NN PCA over the point cloud (`estimate_normals`) —
   all-pairs distances as one matrix product, smallest-eigenvector via batched
   `eigh`; oriented toward the camera viewpoints (PCL uses the sensor
   origin the same way);
2. splat the oriented normal field onto a ``D^3`` voxel grid with trilinear
   weights (`splat_normals`);
3. solve the (screened) Poisson equation ``div(grad chi) = div V`` with a
   3-D real FFT — the Laplacian diagonalizes in Fourier space, so the solve
   is two FFTs and one elementwise divide (`solve_poisson_grid`); an
   indicator-function smoothing sigma plays the role of PCL's octree depth;
4. extract the isosurface at the mean indicator value of the input samples
   with a vectorized surface-nets dual contouring pass (host numpy,
   `surface_nets`) — no 256-case marching-cubes tables needed.

The result is a watertight-ish triangle mesh of grid-resolution detail,
independent of the input point count.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# normals
# ---------------------------------------------------------------------------


def estimate_normals(points, k=16, viewpoints=None, chunk=2048):
    """k-NN PCA normal estimation (device), oriented toward `viewpoints`.

    points: [N, 3]; viewpoints: [M, 3] camera centers (or None -> centroid
    looking outward is NOT assumed; falls back to +z hemisphere).
    Returns [N, 3] unit normals (numpy).
    """
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.utils.precision import einsum, mm

    pts = jnp.asarray(np.asarray(points, np.float32))
    N = pts.shape[0]
    k = min(k, N - 1)
    pad = (-N) % chunk
    pts_pad = jnp.concatenate([pts, jnp.full((pad, 3), 1e6, pts.dtype)])

    def one_chunk(block):
        # block [C, 3] vs all points
        d2 = (
            jnp.sum(block**2, 1)[:, None]
            - 2.0 * mm(block, pts.T)
            + jnp.sum(pts**2, 1)[None, :]
        )
        _, idx = jax.lax.top_k(-d2, k + 1)  # includes self
        nb = pts[idx]  # [C, k+1, 3]
        c = nb - nb.mean(axis=1, keepdims=True)
        cov = einsum("cki,ckj->cij", c, c)
        _w, v = jnp.linalg.eigh(cov)
        return v[..., 0]  # smallest-eigenvalue eigenvector

    blocks = pts_pad.reshape(-1, chunk, 3)
    normals = jax.lax.map(jax.jit(one_chunk), blocks).reshape(-1, 3)[:N]
    normals = np.array(normals)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)

    p = np.asarray(points, np.float32)
    if viewpoints is not None and len(np.atleast_2d(viewpoints)):
        vps = np.atleast_2d(np.asarray(viewpoints, np.float32))
        # orient toward the nearest viewpoint, chunked over points so the
        # [chunk, M] distance block stays small for big maps
        flip = np.zeros(len(p), bool)
        vn = (vps**2).sum(1)
        for s in range(0, len(p), 8192):
            blk = p[s:s + 8192]
            d = (blk**2).sum(1)[:, None] - 2.0 * blk @ vps.T + vn[None]
            to_vp = vps[np.argmin(d, axis=1)] - blk
            flip[s:s + len(blk)] = (normals[s:s + len(blk)] * to_vp).sum(1) < 0
    else:
        flip = normals[:, 2] < 0
    normals[flip] *= -1.0
    return normals


# ---------------------------------------------------------------------------
# grid splat + spectral solve
# ---------------------------------------------------------------------------


def _to_unit_cube(points, margin=0.15):
    p = np.asarray(points, np.float64)
    lo, hi = p.min(0), p.max(0)
    scale = (1.0 - 2 * margin) / max(float((hi - lo).max()), 1e-9)
    center = (lo + hi) / 2.0
    q = (p - center) * scale + 0.5
    return q.astype(np.float32), center, scale


def splat_normals(points01, normals, D):
    """Trilinear scatter of the normal field onto a [D,D,D,3] grid (device)."""
    import jax.numpy as jnp

    p = jnp.asarray(points01) * (D - 1)
    n = jnp.asarray(normals, jnp.float32)
    i0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, D - 2)
    f = p - i0
    grid = jnp.zeros((D * D * D, 3), jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                lin = ((i0[:, 0] + dx) * D + (i0[:, 1] + dy)) * D + (i0[:, 2] + dz)
                grid = grid.at[lin].add(w[:, None] * n)
    return grid.reshape(D, D, D, 3)


def solve_poisson_grid(V, sigma=1.5, screen=0.0):
    """Spectral solve of  lap(chi) = div(V)  on a periodic D^3 grid (device).

    sigma: Gaussian smoothing of the splatted field in voxels (the analogue
    of PCL's reconstruction depth/scale).  screen: screening weight
    (chi-damping) for the screened-Poisson variant.  Returns chi [D,D,D].
    """
    import jax.numpy as jnp

    D = V.shape[0]
    kx = jnp.fft.fftfreq(D)[:, None, None]
    ky = jnp.fft.fftfreq(D)[None, :, None]
    kz = jnp.fft.rfftfreq(D)[None, None, :]

    Vh = [jnp.fft.rfftn(V[..., a]) for a in range(3)]
    # Gaussian low-pass (unit-voxel spacing)
    g = jnp.exp(
        -2.0 * (np.pi * sigma) ** 2 * (kx**2 + ky**2 + kz**2)
    )
    # spectral divergence (central differences diagonalize too; use exact ik)
    two_pi_i = 2j * np.pi
    div_h = two_pi_i * (kx * Vh[0] + ky * Vh[1] + kz * Vh[2]) * g
    # discrete Laplacian symbol (matches central-difference stencil)
    lap = (
        2.0 * (jnp.cos(2 * np.pi * kx) - 1.0)
        + 2.0 * (jnp.cos(2 * np.pi * ky) - 1.0)
        + 2.0 * (jnp.cos(2 * np.pi * kz) - 1.0)
    ) - screen
    lap = jnp.where(jnp.abs(lap) < 1e-12, 1.0, lap)
    chi_h = div_h / lap
    chi_h = chi_h.at[0, 0, 0].set(0.0)
    return jnp.fft.irfftn(chi_h, s=(D, D, D))


def sample_trilinear(grid, points01):
    """Sample a [D,D,D] grid at [N,3] unit-cube positions (numpy)."""
    g = np.asarray(grid)
    D = g.shape[0]
    p = np.asarray(points01) * (D - 1)
    i0 = np.clip(np.floor(p).astype(np.int64), 0, D - 2)
    f = p - i0
    out = np.zeros(len(p))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                out += w * g[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    return out


# ---------------------------------------------------------------------------
# surface nets (dual contouring) — host
# ---------------------------------------------------------------------------


def surface_nets(chi, iso):
    """Extract the iso-surface of a [D,D,D] scalar grid as a triangle mesh.

    Dual approach: one vertex per sign-change cell (at the mean of its edge
    crossings), one quad (two triangles) per sign-change grid edge, wound by
    crossing direction.  Returns (verts [M,3] in grid coords, faces [F,3]).
    """
    chi = np.asarray(chi, np.float64)
    D = chi.shape[0]
    occ = chi > iso

    # --- edge crossings per axis, with interpolated crossing points
    cell_vsum = np.zeros((D - 1, D - 1, D - 1, 3))
    cell_cnt = np.zeros((D - 1, D - 1, D - 1))

    def denom_safe(a, b):
        d = b - a
        return np.where(np.abs(d) < 1e-30, 1e-30, d)

    crossings = []
    for axis in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, D - 1)
        sl1[axis] = slice(1, D)
        a = chi[tuple(sl0)]
        b = chi[tuple(sl1)]
        cross = occ[tuple(sl0)] != occ[tuple(sl1)]
        idx = np.argwhere(cross)  # [E, 3] base-node coords
        if len(idx) == 0:
            crossings.append((idx, None, None))
            continue
        t = (iso - a[cross]) / denom_safe(a[cross], b[cross])
        pt = idx.astype(np.float64)
        pt[:, axis] += np.clip(t, 0.0, 1.0)
        # accumulate into the <=4 cells sharing this edge
        o1, o2 = [ax for ax in range(3) if ax != axis]
        for d1 in (0, 1):
            for d2 in (0, 1):
                c = idx.copy()
                c[:, o1] -= d1
                c[:, o2] -= d2
                ok = (
                    (c[:, 0] >= 0) & (c[:, 0] < D - 1)
                    & (c[:, 1] >= 0) & (c[:, 1] < D - 1)
                    & (c[:, 2] >= 0) & (c[:, 2] < D - 1)
                )
                np.add.at(cell_vsum, (c[ok, 0], c[ok, 1], c[ok, 2]), pt[ok])
                np.add.at(cell_cnt, (c[ok, 0], c[ok, 1], c[ok, 2]), 1.0)
        # remember which edges flip outward (low corner inside) for winding
        flips = occ[tuple(sl0)][cross]
        crossings.append((idx, flips, None))

    active = cell_cnt > 0
    if not active.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    vid = -np.ones((D - 1, D - 1, D - 1), np.int64)
    vid[active] = np.arange(int(active.sum()))
    verts = cell_vsum[active] / cell_cnt[active][:, None]

    faces = []
    for axis in range(3):
        idx, flips, _ = crossings[axis]
        if len(idx) == 0:
            continue
        o1, o2 = [ax for ax in range(3) if ax != axis]
        if axis == 1:
            # keep the (axis, o1, o2) frame right-handed: e_o1 x e_o2 must
            # equal +e_axis (true for (1,2) and (0,1), but (0,2) is
            # left-handed) so all three edge orientations wind consistently
            o1, o2 = o2, o1
        # the 4 cells around the edge, in a consistent cyclic order
        quads = []
        for d1, d2 in ((0, 0), (1, 0), (1, 1), (0, 1)):
            c = idx.copy()
            c[:, o1] -= d1
            c[:, o2] -= d2
            inb = (
                (c[:, 0] >= 0) & (c[:, 0] < D - 1)
                & (c[:, 1] >= 0) & (c[:, 1] < D - 1)
                & (c[:, 2] >= 0) & (c[:, 2] < D - 1)
            )
            ids = np.full(len(idx), -1, np.int64)
            ids[inb] = vid[c[inb, 0], c[inb, 1], c[inb, 2]]
            quads.append(ids)
        q = np.stack(quads, 1)  # [E, 4]
        ok = (q >= 0).all(1)
        q = q[ok]
        fl = flips[ok]
        # two triangles per quad, wound so normals point toward the
        # occupied (chi > iso) side — outward for an interior solid
        t1 = np.where(fl[:, None], q[:, [0, 2, 1]], q[:, [0, 1, 2]])
        t2 = np.where(fl[:, None], q[:, [0, 3, 2]], q[:, [0, 2, 3]])
        faces.append(t1)
        faces.append(t2)
    faces = (
        np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
    )
    return verts, faces


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------


def poisson_reconstruct(points, normals=None, viewpoints=None, grid=96,
                        sigma=1.5, k=16):
    """Full Poisson pipeline: points (+optional normals/camera viewpoints)
    -> (verts [M,3] in input coordinates, faces [F,3] int).
    """
    points = np.asarray(points, np.float64)
    if len(points) < 8:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    if normals is None:
        normals = estimate_normals(points, k=k, viewpoints=viewpoints)
    p01, center, scale = _to_unit_cube(points)
    V = splat_normals(p01, normals, grid)
    chi = solve_poisson_grid(V, sigma=sigma)
    chi_np = np.asarray(chi)
    iso = float(np.mean(sample_trilinear(chi_np, p01)))
    verts_g, faces = surface_nets(chi_np, iso)
    # grid coords -> unit cube -> world
    verts01 = verts_g / (grid - 1)
    verts = (verts01 - 0.5) / scale + center
    return verts, faces
