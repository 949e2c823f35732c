"""Distributed global BA as a product path (round-4 VERDICT #1).

The reference's global BA *is* its pipeline's solver
(`ba_project/src/ba/Optimizer.cpp:93-160`, invoked from
`BundleAdjustment.cpp:196-207,228-230`).  These tests lock this build's
equivalent: `cfg.global_ba_mode` routes the pipeline's global solves through
the windowed (window-shard_map + pose-graph stitch) or landmark-sharded
dense engines on the 8-virtual-device CPU mesh, with ATE parity against the
single-device solve, plus the RGB-D depth-landmark seeding that produces
BASELINE-config-4-scale maps inside the pipeline.
"""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.metrics import evaluate_ate
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline, PipelineConfig
from tests.test_pipeline import frames_to_framedata


def _run_mode(mode, frames, K4, mesh=None):
    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", n_features=400, n_levels=3,
        local_ba=False, final_ba_outer=1, final_ba_iters=10,
        keyframe_ratio=0.35, global_ba_mode=mode,
    )
    ds = frames_to_framedata(frames)
    pipe = BundleAdjustmentPipeline(cfg, K4, 320, 240)
    if mesh is not None:
        pipe.global_ba_mesh = mesh
    pipe.run(ds)
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    res = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)
    return res["rmse"], pipe


@pytest.mark.slow
def test_global_ba_modes_ate_parity():
    """single vs sharded vs windowed finalize over an 8-device mesh: every
    mode tracks the same sequence inside the ATE bound, sharded matches the
    single-device dense solve tightly (same algorithm, psummed partials),
    windowed (a genuinely different solve: windows + pose graph) stays
    within the accuracy envelope."""
    frames, K4 = render_plane_sequence(
        n_frames=14, width=320, height=240, fx=300.0, fy=300.0,
        motion_step=0.25,
    )
    devs = np.array(jax.devices()[:8])

    ate_single, pipe_s = _run_mode("single", frames, K4)
    assert pipe_s.stats["keyframes"] >= 4, pipe_s.stats

    ate_sharded, _ = _run_mode(
        "sharded", frames, K4, mesh=Mesh(devs, ("shard",)))
    ate_windowed, _ = _run_mode(
        "windowed", frames, K4, mesh=Mesh(devs, ("window",)))

    bound = 0.25  # the mapping-path bound (tests/test_pipeline_mapping.py)
    assert ate_single < bound, ate_single
    assert ate_sharded < bound, ate_sharded
    assert ate_windowed < bound, ate_windowed
    # sharded is the same LM/DENSE_SCHUR algorithm with psummed partials:
    # trajectories must agree closely with the single-device solve
    assert abs(ate_sharded - ate_single) < 0.02, (ate_sharded, ate_single)
    # windowed+pose-graph is a different (stitched) solve; parity within the
    # same accuracy envelope rather than numerically
    assert ate_windowed < max(3.0 * ate_single, 0.1), (ate_windowed, ate_single)


@pytest.mark.slow
def test_depth_landmarks_seeding():
    """RGB-D per-keyframe depth seeding densifies the map dramatically
    (the route to >=10k-landmark maps in the pipeline) without breaking
    tracking accuracy."""
    frames, K4 = render_plane_sequence(
        n_frames=14, width=320, height=240, fx=300.0, fy=300.0,
        motion_step=0.25,
    )

    def run(depth_landmarks):
        cfg = PipelineConfig(
            init_type="gtdepth", estimation="ba", n_features=400, n_levels=3,
            local_ba=True, final_ba_outer=1, final_ba_iters=10,
            keyframe_ratio=0.35, depth_landmarks=depth_landmarks,
            depth_landmarks_max=300,
            # isolate the seeding mechanism: guided local-map tracking
            # claims the same free keypoints the seeds need for their
            # second observations (the 10k-map protocol likewise runs with
            # it off to maximize density)
            track_local_map=False,
        )
        ds = frames_to_framedata(frames)
        pipe = BundleAdjustmentPipeline(cfg, K4, 320, 240)
        pipe.run(ds)
        ts, mats = pipe.trajectory_cam_to_world()
        gt_ts = np.array([f["timestamp"] for f in frames])
        gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
        res = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)
        return res["rmse"], len(pipe.map.active_points()), pipe

    ate_off, n_off, pipe_off = run(False)
    ate_on, n_on, pipe = run(True)
    assert n_on > 1.25 * n_off, (n_on, n_off)
    assert ate_on < 0.25, ate_on
    # seeded landmarks must gain second observations through the guided
    # projection search (otherwise they'd be dead weight: never in BA).
    # The gain is bounded by the landmark-free keypoints per keyframe
    # (~150 at n_features=400); protocol-scale runs use n_features >= 2500.
    def ge2(p):
        ids = p.map.active_points()
        return int((p.map.point_obs_counts(ids) >= 2).sum())

    assert ge2(pipe) >= ge2(pipe_off) + 10, (ge2(pipe), ge2(pipe_off))
