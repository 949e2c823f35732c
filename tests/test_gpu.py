"""Checks that need an NVIDIA GPU.  Elsewhere they skip; `chip_smoke.py`
runs them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu


def test_one_hot_gather_is_exact(gpu):
    """The dense engine gathers camera poses through one-hot products; on
    the card they must return the table bit for bit (a TF32 product would
    move a 30 m translation by centimetres)."""
    from bundleadjustment_tpu.solvers.dense_ba import _gather_cams, _to_cm
    from bundleadjustment_tpu.solvers.dense_ba import DenseBAProblem

    K, L, O = 16, 512, 8
    rng = np.random.default_rng(0)
    table = (rng.standard_normal((K, 12)) * 30.0).astype(np.float32)
    cam_idx = rng.integers(0, K, (L, O)).astype(np.int32)
    prob = DenseBAProblem(
        K4=jnp.ones(4), cam_idx=jnp.asarray(cam_idx),
        uv=jnp.zeros((L, O, 2)), sigma2=jnp.ones((L, O)),
        valid=jnp.ones((L, O), bool), cam_fixed=jnp.zeros(K, bool),
        pt_valid=jnp.ones(L, bool))
    out = jax.jit(lambda t, p: _gather_cams(t, _to_cm(p)))(
        jax.device_put(table, gpu), jax.device_put(prob, gpu))
    np.testing.assert_array_equal(np.asarray(out),
                                  table[cam_idx.T].transpose(2, 0, 1))


def test_dense_ba_matches_host_cpu(gpu):
    """The same small dense solve on the card and on the host CPU."""
    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.solvers import LMConfig
    from bundleadjustment_tpu.solvers.dense_ba import (
        dense_ba_solve,
        densify_problem,
    )

    sc = make_synthetic_scene(n_cams=8, n_pts=400, pixel_noise=0.5, seed=7)
    fixed = np.zeros(8, bool)
    fixed[0] = True
    dense, _ = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                               sc.sigma2, sc.valid, fixed, 400)
    cfg = LMConfig(max_iters=10, solver="dense")
    out = {}
    for name, dev in (("gpu", gpu), ("cpu", jax.devices("cpu")[0])):
        args = jax.device_put((dense, sc.extr_init.astype(np.float32),
                               sc.points_init.astype(np.float32)), dev)
        cams, _pts, info = dense_ba_solve(*args, cfg)
        out[name] = (np.asarray(cams), float(info["cost"]))
    assert abs(out["gpu"][1] - out["cpu"][1]) <= 1e-4 * out["cpu"][1]
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], atol=1e-4)
