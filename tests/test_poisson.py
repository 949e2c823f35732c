"""Poisson surface reconstruction (vis/poisson.py) — the on-device
replacement for PCL Poisson meshing (reference SimpleMesh.cpp:414-491)."""

import numpy as np

from bundleadjustment_tpu.vis.poisson import (
    estimate_normals,
    poisson_reconstruct,
    sample_trilinear,
    solve_poisson_grid,
    splat_normals,
    surface_nets,
)


def sphere_cloud(n=3000, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r, v


def test_normals_on_sphere_point_radially():
    pts, gt = sphere_cloud(2000)
    nrm = estimate_normals(pts, k=12, viewpoints=pts * 3.0)
    dots = (nrm * gt).sum(1)
    assert dots.mean() > 0.98
    assert (dots > 0.9).mean() > 0.97
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)


def test_reconstruct_sphere_exact_normals():
    pts, gt = sphere_cloud(3000)
    verts, faces = poisson_reconstruct(pts, normals=gt, grid=64)
    assert len(verts) > 1000 and len(faces) > 2000
    r = np.linalg.norm(verts, axis=1)
    assert abs(r.mean() - 1.0) < 0.02
    assert r.std() < 0.02
    # all faces reference valid vertices
    assert faces.min() >= 0 and faces.max() < len(verts)


def test_reconstruct_sphere_estimated_normals():
    pts, _ = sphere_cloud(3000, seed=1)
    verts, faces = poisson_reconstruct(pts, grid=64, viewpoints=pts * 3.0)
    r = np.linalg.norm(verts, axis=1)
    assert abs(r.mean() - 1.0) < 0.03
    assert r.std() < 0.03


def test_surface_nets_closed_surface():
    # chi = signed distance to a sphere on the grid -> surface nets of the
    # zero level set; every edge of every triangle must be shared by exactly
    # two triangles (closed 2-manifold) away from the boundary
    D = 32
    g = np.stack(np.meshgrid(*([np.arange(D)] * 3), indexing="ij"), -1)
    chi = np.linalg.norm(g - (D - 1) / 2.0, axis=-1) - D / 4.0
    verts, faces = surface_nets(chi, 0.0)
    assert len(verts) and len(faces)
    # consistent orientation: every DIRECTED edge appears exactly once
    # (undirected-edge counting would miss winding inconsistencies)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 1).all()
    # outward orientation: positive enclosed volume, close to the sphere's
    v = verts[faces]
    vol = np.einsum("fi,fi->f", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum() / 6.0
    true_vol = 4.0 / 3.0 * np.pi * (D / 4.0) ** 3
    assert abs(vol - true_vol) / true_vol < 0.05


def test_splat_and_sample_roundtrip():
    rng = np.random.default_rng(3)
    p01 = rng.uniform(0.2, 0.8, (50, 3)).astype(np.float32)
    n = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (50, 1))
    V = np.asarray(splat_normals(p01, n, 32))
    # total splatted mass equals the number of points (trilinear partition)
    np.testing.assert_allclose(V[..., 2].sum(), 50.0, rtol=1e-5)
    assert abs(V[..., 0].sum()) < 1e-4

    grid = np.zeros((16, 16, 16), np.float32)
    grid[8, 8, 8] = 1.0
    val = sample_trilinear(grid, np.array([[8.0 / 15, 8.0 / 15, 8.0 / 15]]))
    np.testing.assert_allclose(val, [1.0], atol=1e-6)


def test_mesh_integration_poisson_faces():
    from bundleadjustment_tpu.vis.mesh import create_map_mesh

    pts, _ = sphere_cloud(1500, seed=4)
    eye = np.eye(4)
    verts, faces, cols = create_map_mesh(
        pts, cam_poses=[eye], faces_type="poisson"
    )
    # mesh vertices (grid resolution) + 5 frustum glyph verts
    assert len(faces) > 500
    assert len(cols) == len(verts)
