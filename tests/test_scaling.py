import pytest

from bundleadjustment_tpu.parallel.scaling import measure_scaling


@pytest.mark.slow
def test_scaling_harness_runs_on_virtual_mesh():
    out = measure_scaling(
        n_landmarks=512, n_cams=8, obs_per_pt=4,
        device_counts=[1, 2, 4], lm_iters=2, pcg_iters=10, repeats=1,
    )
    assert out["mode"] == "strong"
    assert [r["devices"] for r in out["results"]] == [1, 2, 4]
    for r in out["results"]:
        assert r["iters_per_s"] > 0
        assert 0 < r["efficiency"]
    # virtual CPU devices share cores: no perf claim, just harness validity


def test_analytic_model_predicts_config5_floor():
    """The analytic scaling model takes its link and compute rates
    explicitly and degrades sensibly: efficiency falls as devices grow,
    rises as landmarks grow (compute/iter scales with L/D while psum bytes
    are constant in L), and rises with link bandwidth."""
    from functools import partial

    from bundleadjustment_tpu.parallel.scaling import predicted_efficiency

    eff = partial(predicted_efficiency, link_gbps=100.0, qqt_tflops=20.0)
    for args in ((128, 100_000, 4), (128, 10_000, 32)):
        assert 0.0 < eff(*args) < 1.0
    assert eff(128, 100_000, 32) < eff(128, 100_000, 8) < eff(128, 100_000, 2)
    assert eff(128, 10_000, 8) < eff(128, 100_000, 8)
    assert (eff(128, 100_000, 8)
            < predicted_efficiency(128, 100_000, 8, link_gbps=400.0,
                                   qqt_tflops=20.0))


def test_psum_bytes_model_matches_compiled_hlo():
    """Tie the analytic model's bytes/iteration to the artifact it models:
    the all-reduce bytes in the compiled HLO of the sharded dense solve must
    equal (iterations + 1 seed eval) worth of the model's per-iteration
    psum inventory."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.parallel.scaling import psum_bytes_per_iter
    from bundleadjustment_tpu.parallel.sharded_dense_ba import (
        AXIS,
        _solve_jit,
        shard_dense_problem,
    )
    from bundleadjustment_tpu.solvers import LMConfig

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), (AXIS,))
    cfg = LMConfig(max_iters=3, solver="dense")
    K = 8
    sc = make_synthetic_scene(n_cams=K, n_pts=2048, obs_per_pt=4,
                              pixel_noise=0.3, seed=3)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    prob, pts, _, _ = shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
        cam_fixed, sc.points_init, len(devs),
    )
    import jax.numpy as jnp

    lowered = _solve_jit.lower(prob, jnp.asarray(sc.extr_init), pts, cfg,
                               mesh)
    hlo_bytes = _allreduce_bytes(lowered.compile().as_text())
    # HLO contains each psum op once (the scan body is compiled once):
    # per-iteration inventory (S + rhs red6 + red27 + cost) plus the seed
    # eval's (red27 + cost)
    per_iter = psum_bytes_per_iter(K)
    seed = 4 * (27 * K + 1)
    assert hlo_bytes == per_iter + seed, (
        f"compiled all-reduce bytes {hlo_bytes} != model "
        f"{per_iter} + seed {seed}")


def _allreduce_bytes(compiled_text):
    """Total bytes moved by all-reduce ops in a compiled HLO dump.

    HLO lines look like
      %all-reduce.1 = (f32[], f32[8,27]{1,0}) all-reduce(%a, %b), ...
    — the result type (possibly a tuple) sits between '=' and 'all-reduce('.
    """
    import re

    sizes = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "pred": 1, "u32": 4}
    total = 0
    for line in compiled_text.splitlines():
        m = re.search(r"=\s*(.*?)\s*all-reduce(?:-start)?\(", line)
        if not m:
            continue
        for dtype, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * sizes.get(dtype, 4)
    return total


@pytest.mark.slow
def test_sharded_ba_psum_traffic_independent_of_landmarks():
    """The falsifiable core of the scaling model: per-iteration traffic of the
    landmark-sharded dense BA is a function of the CAMERA count only —
    growing the landmark axis must not grow the psummed bytes, so
    comm/compute ratio FALLS as problems grow.  Checked on the compiled
    HLO: total all-reduce bytes are identical at 2k and 8k landmarks."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.parallel.sharded_dense_ba import (
        AXIS,
        _solve_jit,
        shard_dense_problem,
    )
    from bundleadjustment_tpu.solvers import LMConfig

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), (AXIS,))
    cfg = LMConfig(max_iters=3, solver="dense")

    def compiled_bytes(n_pts):
        sc = make_synthetic_scene(n_cams=8, n_pts=n_pts, obs_per_pt=4,
                                  pixel_noise=0.3, seed=3)
        cam_fixed = np.zeros(8, bool)
        cam_fixed[0] = True
        prob, pts, _, _ = shard_dense_problem(
            sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
            cam_fixed, sc.points_init, len(devs),
        )
        import jax.numpy as jnp

        lowered = _solve_jit.lower(prob, jnp.asarray(sc.extr_init), pts,
                                   cfg, mesh)
        return _allreduce_bytes(lowered.compile().as_text())

    b_small = compiled_bytes(2048)
    b_large = compiled_bytes(8192)
    assert b_small > 0, "expected all-reduces in the sharded solve"
    assert b_large == b_small, (
        f"psum traffic grew with landmarks: {b_small} -> {b_large} bytes")
