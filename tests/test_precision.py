"""Every float32 matrix product on the main path carries HIGHEST precision.

A DEFAULT-precision float32 product may run in TF32 on a GPU, which would
shift one-hot camera gathers and projections by millimetres (see
`utils/precision.py`).  The checks walk the jaxprs of the main-path entry
points, sub-jaxprs included (scan bodies, conds, nested jits)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.solvers import BAProblem, LMConfig
from bundleadjustment_tpu.utils.precision import HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "dot_general"
                and any(v.aval.dtype == jnp.float32 for v in eqn.invars)):
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _f32_dots(sub)


def _scene():
    return make_synthetic_scene(n_cams=4, n_pts=40, pixel_noise=0.3, seed=5)


def _dense_ba():
    from bundleadjustment_tpu.solvers.dense_ba import (
        dense_ba_solve,
        densify_problem,
    )

    sc = _scene()
    fixed = np.zeros(4, bool)
    fixed[0] = True
    dense, _ = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                               sc.sigma2, sc.valid, fixed, 40, max_obs=8)
    return jax.make_jaxpr(
        lambda d, c, p: dense_ba_solve(d, c, p, LMConfig(max_iters=2))
    )(dense, sc.extr_init, sc.points_init)


def _flat_ba():
    from bundleadjustment_tpu.solvers import ba_solve

    sc = _scene()
    prob = BAProblem(
        K4=jnp.asarray(sc.K4), cam_idx=jnp.asarray(sc.cam_idx),
        pt_idx=jnp.asarray(sc.pt_idx), uv=jnp.asarray(sc.uv),
        sigma2=jnp.asarray(sc.sigma2), valid=jnp.asarray(sc.valid),
        cam_fixed=jnp.zeros(4, bool).at[0].set(True),
        pt_fixed=jnp.zeros(40, bool),
    )
    return jax.make_jaxpr(
        lambda c, p: ba_solve(prob, c, p, LMConfig(max_iters=2))
    )(sc.extr_init, sc.points_init)


def _motion_only():
    from bundleadjustment_tpu.solvers.lm import motion_only_ba

    B, M = 2, 16
    return jax.make_jaxpr(motion_only_ba)(
        jnp.ones(4), jnp.zeros((B, 6)), jnp.ones((B, M, 3)),
        jnp.ones((B, M, 2)), jnp.ones((B, M)), jnp.ones((B, M), bool))


def _track_batch():
    from bundleadjustment_tpu.ops.features import FeatureConfig, _level_allocations
    from bundleadjustment_tpu.pipeline import driver as drv
    from bundleadjustment_tpu.solvers.lm import MotionOnlyConfig

    fc = FeatureConfig(n_features=64, n_levels=2)
    M, N, H, W = sum(_level_allocations(fc)), 32, 60, 80
    fn = lambda *a: drv._track_batch_jit(
        *a, feat_cfg=fc, ratio=0.7, assoc_max=50.0,
        mcfg=MotionOnlyConfig(outer_iters=1, inner_iters=2), max_obs=32,
        min_track=4, pnp_guard=None, tlm=True, width=W, height=H)
    return jax.make_jaxpr(fn)(
        jnp.zeros((2, H, W)), jnp.zeros((M, 8), jnp.uint32),
        jnp.zeros(M, bool), jnp.zeros((M, 3)), jnp.zeros(M, bool),
        jnp.full(M, N, jnp.int32), jnp.zeros((N, 3)),
        jnp.zeros((N, 8), jnp.uint32), jnp.zeros(N, bool), jnp.zeros(6),
        jnp.zeros(6), jnp.ones(4))


@pytest.mark.parametrize("build", [_dense_ba, _flat_ba, _motion_only,
                                   _track_batch],
                         ids=["dense_ba_solve", "ba_solve", "motion_only_ba",
                              "track_batch"])
def test_f32_dots_carry_highest(build):
    dots = list(_f32_dots(build().jaxpr))
    assert dots, "expected float32 dot_generals"
    loose = [str(e) for e in dots
             if e.params["precision"] != (HIGHEST, HIGHEST)]
    assert not loose, loose[:3]
