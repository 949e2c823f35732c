"""Config-1/2/3-shaped protocols on hard layered synthetic scenes.

Without real TUM/Replica downloads, each config (BASELINE.json) runs on
`render_layered_scene` hard scenes (multi-depth structure, occlusion,
sensor-model depth, photometric nuisance) at the matching camera geometry,
on the default device.  Prints one JSON line per config.

- config 1 — fr1/xyz-shaped: 640x480 fx=525, 50 frames, gtdepth init,
  motion-only-BA tracking, final global BA (reference main.cpp:48-64 with
  --local-ba off).
- config 2 — long-sequence keyframe mapping: 120 frames handheld, keyframe
  selection + local BA + keyframe culling (reference --local-ba
  --cull-frames).
- config 3 — Replica-shaped RGB-D: depth-assisted init + colored map fusion,
  reconstruction error vs the GT cloud (reference --reconstruction-error,
  main.cpp:189-202).
"""

from __future__ import annotations

import json
import time

import numpy as np


def make_dataset(frames):
    from bundleadjustment_tpu.data.tum import FrameData

    rgb = lambda g: np.repeat(
        (np.clip(g, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1
    )
    return [
        FrameData(
            index=i,
            timestamp=f["timestamp"],
            gray=f["gray"],
            depth=f["depth"],
            rgb=rgb(f["gray"]),
            gt_cam_to_world=f["gt_cam_to_world"],
        )
        for i, f in enumerate(frames)
    ]


class CompileCounter:
    """Counts XLA compiles (`compiles`) and persistent-cache hits
    (`cache_hits`) through `jax.monitoring` while the context is open."""

    _COMPILE = "/jax/core/compile/backend_compile_duration"
    _CACHE_HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        self.compiles = 0
        self.cache_hits = 0

    def _duration(self, name, _secs, **_kw):
        if name == self._COMPILE:
            self.compiles += 1

    def _event(self, name, **_kw):
        if name == self._CACHE_HIT:
            self.cache_hits += 1

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._duration)
        jax.monitoring.unregister_event_listener(self._event)
        return False


def prewarm(cfg, K4, width, height):
    """Construct the pipeline and start the background compile warm-up
    BEFORE the (tens of seconds of) host-side scene rendering, so the
    critical-path frontend compile overlaps it.  Returns the pipe; pass it
    to run_protocol."""
    from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline
    from bundleadjustment_tpu.pipeline.warmup import CompileWarmer

    pipe = BundleAdjustmentPipeline(cfg, np.asarray(K4, np.float32),
                                    width, height)
    CompileWarmer(pipe).start()
    return pipe


def run_protocol(frames, K4, cfg, width, height, warmup=10, pipe=None):
    """Run the pipeline frame by frame with per-frame timing.

    Returns (pipe, ate_result, steady_fps, wall_s, n_compiles): steady_fps
    is the median rate over tracked frames after the first `warmup`."""
    from bundleadjustment_tpu.metrics import evaluate_ate
    from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline

    with CompileCounter() as cc:
        if pipe is None:
            pipe = prewarm(cfg, K4, width, height)
        ds = make_dataset(frames)
        t_start = time.perf_counter()
        timings = []
        statuses = pipe.process_frames(ds, timings=timings)
        # online trajectory: CAUSAL poses as tracked (keyframes at their
        # during-run BA state), BEFORE the final global BA and without the
        # (forward-looking) segment interpolation — the per-frame quality
        # the reference's motion-only BA delivers live
        # (SfMHelper.cpp:106-117); round-4 VERDICT #2
        ts_online, mats_online = pipe.trajectory_cam_to_world(smooth=False)
        pipe.finalize()
        wall = time.perf_counter() - t_start
    frame_times = list(zip(timings, statuses))

    # steady-state tracked-frame fps: median over post-warmup tracked frames
    tracked = [t for t, s in frame_times[warmup:] if s == "tracked"]
    fps = 1.0 / float(np.median(tracked)) if tracked else float("nan")

    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    res = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)
    res_online = evaluate_ate(ts_online, mats_online[:, :3, 3], gt_ts, gt_xyz)
    res["ate_online"] = res_online["rmse"]
    return pipe, res, fps, wall, cc.compiles


def keyframe_ate(pipe, frames):
    """ATE over keyframe poses only (isolates tracked-frame pose noise
    from map quality — round-3 VERDICT #6 diagnostic)."""
    from bundleadjustment_tpu.metrics import evaluate_ate

    ts, mats = pipe.trajectory_cam_to_world()
    kf = np.array([r.is_keyframe for r in pipe.trajectory])
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    res = evaluate_ate(ts[kf], mats[kf][:, :3, 3], gt_ts, gt_xyz)
    return res["rmse"]


def gt_cloud(frames, K4, stride=4, px_stride=8):
    """Ground-truth point cloud from GT depth + GT poses (the synthetic
    stand-in for the Replica GT mesh)."""
    fx, fy, cx, cy = K4
    pts = []
    for f in frames[::stride]:
        d = f["depth"]
        h, w = d.shape
        vs, us = np.mgrid[0:h:px_stride, 0:w:px_stride]
        dep = d[vs, us]
        ok = np.isfinite(dep) & (dep > 0)
        xc = np.stack(
            [(us - cx) / fx * dep, (vs - cy) / fy * dep, dep], -1
        )[ok]
        C = f["gt_cam_to_world"]
        pts.append(xc @ C[:3, :3].T + C[:3, 3])
    return np.concatenate(pts)


def config1(track_batch=1, seed=11):
    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=False,
        n_features=1000, n_levels=8, track_batch=track_batch,
    )
    # K4 convention of render_layered_scene: cx, cy = (size-1)/2
    K4 = np.array([525.0, 525.0, (640 - 1) / 2.0, (480 - 1) / 2.0],
                  np.float32)
    pipe = prewarm(cfg, K4, 640, 480)  # overlap compiles with rendering
    frames, K4r = render_layered_scene(
        n_frames=50, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="forward", motion_step=0.03, seed=seed,
    )
    assert np.allclose(K4, K4r)
    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, 640, 480,
                                               pipe=pipe)
    return {
        "metric": "config1_fr1_shaped" + (
            f"_tb{track_batch}" if track_batch > 1 else ""
        ),
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": 50,
        "keyframes": pipe.stats["keyframes"],
        "landmarks": int(len(pipe.map.active_points())),
        "phase_times": {k: {kk: round(vv, 2) for kk, vv in v.items()}
                        for k, v in pipe.timers.report().items()},
    }


def config2(seed=12):
    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        cull_frames=True, n_features=1000, n_levels=8,
    )
    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    pipe = prewarm(cfg, K4, 640, 480)
    frames, _ = render_layered_scene(
        n_frames=120, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="handheld", motion_step=0.05, rot_step=0.012, seed=seed,
    )
    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, 640, 480,
                                               pipe=pipe)
    return {
        "metric": "config2_long_sequence",
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "keyframe_ate_m": round(keyframe_ate(pipe, frames), 4),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": 120,
        "keyframes": pipe.stats["keyframes"],
        "landmarks": int(len(pipe.map.active_points())),
    }


def config3(seed=13):
    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.metrics.reconstruction import reconstruction_error
    from bundleadjustment_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        n_features=1000, n_levels=8,
    )
    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    pipe = prewarm(cfg, K4, 640, 480)
    frames, _ = render_layered_scene(
        n_frames=40, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="orbit", motion_step=0.06, seed=seed,
    )
    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, 640, 480,
                                               pipe=pipe)
    pts, cols = pipe.map_points_colored()
    gt = gt_cloud(frames, K4)
    first_kf = int(pipe.map.active_keyframes()[0])
    fitness, _ = reconstruction_error(
        pts, gt, first_kf_gt_pose=pipe.map.kf_gt[first_kf]
    )
    return {
        "metric": "config3_rgbd_fusion",
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "recon_error": round(float(fitness), 5),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": 40,
        "keyframes": pipe.stats["keyframes"],
        "landmarks": int(len(pts)),
        "colored": bool(np.any(cols != 200)),
    }


def config4_teddy(seed=14):
    """fr1/teddy-shaped: rotation-dominant object orbit, texture-poor
    background, occluding panels (reference VirtualSensor.h:15-20 ships
    fr1/teddy; this protocol covers the object-orbit regime the forward/
    handheld protocols don't)."""
    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        cull_frames=True, n_features=1000, n_levels=8,
    )
    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    pipe = prewarm(cfg, K4, 640, 480)
    frames, _ = render_layered_scene(
        n_frames=60, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="orbit", motion_step=0.08, n_layers=8,
        background_texture=0.15, seed=seed,
    )
    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, 640, 480,
                                               pipe=pipe)
    return {
        "metric": "config4_teddy_orbit",
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": 60,
        "keyframes": pipe.stats["keyframes"],
        "landmarks": int(len(pipe.map.active_points())),
    }


def config5_replica_geometry(seed=15):
    """Replica room0 camera geometry end to end (round-3 VERDICT #3): the
    reference's primary dataset is 1200x680 / fx=fy=600 / depth scale
    6553.5 (`/root/reference/ba_project/src/data/VirtualSensor.h:100-116`,
    default dataset `src/main.cpp:48-64`).  RGB-D fusion orbit +
    reconstruction error, plus frontend ms/frame at the 3.6x-larger image
    measured in the same session."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.metrics.reconstruction import reconstruction_error
    from bundleadjustment_tpu.pipeline import PipelineConfig
    import bundleadjustment_tpu.ops.features as F

    W, H = 1200, 680
    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        n_features=1000, n_levels=8,
    )
    K4 = np.array([600.0, 600.0, (W - 1) / 2.0, (H - 1) / 2.0], np.float32)
    pipe5 = prewarm(cfg, K4, W, H)
    frames, _ = render_layered_scene(
        n_frames=40, width=W, height=H, fx=600.0, fy=600.0,
        trajectory="orbit", motion_step=0.06, depth_scale=6553.5, seed=seed,
    )

    # frontend cost at Replica resolution: sustained detect_and_describe
    fcfg = F.FeatureConfig(n_features=1000, n_levels=8)
    det = jax.jit(lambda im: F.detect_and_describe(im, fcfg))
    imgs = [jnp.asarray(f["gray"], jnp.float32) for f in frames[:8]]
    jax.device_get(jax.tree.leaves(det(imgs[0])))
    t0 = time.perf_counter()
    out = None
    N_SUS = 3
    for _ in range(N_SUS):
        for im in imgs:
            out = det(im)
    jax.device_get(jax.tree.leaves(out)[0])
    frontend_ms = (time.perf_counter() - t0) / (N_SUS * len(imgs)) * 1e3

    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, W, H,
                                               pipe=pipe5)
    pts, cols = pipe.map_points_colored()
    gt = gt_cloud(frames, K4)
    first_kf = int(pipe.map.active_keyframes()[0])
    fitness, _ = reconstruction_error(
        pts, gt, first_kf_gt_pose=pipe.map.kf_gt[first_kf]
    )
    return {
        "metric": "config5_replica_geometry",
        "width": W, "height": H, "fx": 600.0, "depth_scale": 6553.5,
        "frontend_ms_per_frame": round(frontend_ms, 2),
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "recon_error": round(float(fitness), 5),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": 40,
        "keyframes": pipe.stats["keyframes"],
        "landmarks": int(len(pts)),
    }


def config6_long_sequence(seed=16, n_frames=500):
    """500-frame long-sequence protocol (round-3 VERDICT #4): the
    reference's default regime is `--frames 2000` with keyframe culling and
    local BA (`/root/reference/ba_project/src/main.cpp:48-64`,
    `src/ba/SfMHelper.cpp:974-1077`).  Records ATE, steady fps, wall, peak
    map occupancy, jit-bucket compiles (first vs second half — plateau
    evidence), and keyframes culled."""
    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        cull_frames=True, n_features=1000, n_levels=8,
    )
    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    pipe6 = prewarm(cfg, K4, 640, 480)
    frames, _ = render_layered_scene(
        n_frames=n_frames, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="sweep", motion_step=0.04, rot_step=0.01, seed=seed,
    )
    # split-half compile counts: re-run the protocol body inline so the
    # counter can be read mid-stream
    from bundleadjustment_tpu.metrics import evaluate_ate
    from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline
    from bundleadjustment_tpu.pipeline.warmup import CompileWarmer

    ds = make_dataset(frames)
    with CompileCounter() as cc:
        pipe = pipe6
        t_start = time.perf_counter()
        timings = []
        half = n_frames // 2
        statuses = pipe.process_frames(ds[:half], timings=timings)
        compiles_first_half = cc.compiles
        statuses += pipe.process_frames(ds[half:], timings=timings)
        compiles_second_half = cc.compiles - compiles_first_half
        kfs_before_final = pipe.stats["keyframes"]
        ts_online, mats_online = pipe.trajectory_cam_to_world(smooth=False)
        pipe.finalize()
        wall = time.perf_counter() - t_start

    tracked = [t for t, s in list(zip(timings, statuses))[10:]
               if s == "tracked"]
    med = float(np.median(tracked)) if tracked else float("nan")
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    res = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)
    res["ate_online"] = evaluate_ate(
        ts_online, mats_online[:, :3, 3], gt_ts, gt_xyz)["rmse"]
    active_kfs = len(pipe.map.active_keyframes())
    path_len = float(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1).sum())
    return {
        "metric": f"config6_long_sequence_{n_frames}f",
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "keyframe_ate_m": round(keyframe_ate(pipe, frames), 4),
        "gt_path_length_m": round(path_len, 2),
        "ate_pct_of_path": round(100.0 * res["rmse"] / max(path_len, 1e-9),
                                 3),
        "steady_fps": round(1.0 / med, 2) if med == med else None,
        "wall_s": round(wall, 1),
        "frames": n_frames,
        "keyframes_created": kfs_before_final,
        "keyframes_active": active_kfs,
        "keyframes_culled": kfs_before_final - active_kfs,
        "landmarks": int(len(pipe.map.active_points())),
        "jit_compiles_first_half": compiles_first_half,
        "jit_compiles_second_half": compiles_second_half,
        "phase_times": {k: {kk: round(vv, 2) for kk, vv in v.items()}
                        for k, v in pipe.timers.report().items()},
    }


def config7_global_10k(n_frames=100, n_features=2500, mode="single", seed=17):
    """BASELINE config-4 for real (round-4 VERDICT #1): build a
    >=10k-landmark map INSIDE the pipeline — RGB-D depth seeding at every
    keyframe + guided projection densification + a raised feature budget —
    then global-BA-solve the map the pipeline actually produced and measure
    BA it/s on that map-derived problem (its real sparsity and
    obs-per-landmark distribution, not a synthetic table).  Reference:
    global BA over the entire map at every keyframe / at the end
    (`ba_project/src/ba/Optimizer.cpp:93-160`,
    `BundleAdjustment.cpp:228-230`)."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.pipeline import PipelineConfig
    from bundleadjustment_tpu.solvers import LMConfig
    from bundleadjustment_tpu.solvers.dense_ba import (
        dense_ba_solve,
        densify_problem_auto,
    )
    from bundleadjustment_tpu.utils.flops import roofline
    from bundleadjustment_tpu.utils.marginal import measure_marginal

    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        n_features=n_features, n_levels=8, keyframe_ratio=0.25,
        depth_landmarks=True, depth_landmarks_max=2000,
        global_ba_mode=mode,
        # map-density protocol: guided local-map tracking would re-claim
        # the free keypoints the depth seeds need for second observations
        track_local_map=False,
    )
    K4 = np.array([525.0, 525.0, (640 - 1) / 2.0, (480 - 1) / 2.0],
                  np.float32)
    pipe7 = prewarm(cfg, K4, 640, 480)
    frames, _ = render_layered_scene(
        n_frames=n_frames, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="sweep", motion_step=0.04, rot_step=0.01, seed=seed,
    )
    pipe, res, fps, wall, ncomp = run_protocol(frames, K4, cfg, 640, 480,
                                               pipe=pipe7)

    # the map-derived global-BA problem (exactly what finalize solved)
    kfs = [int(k) for k in pipe.map.active_keyframes()]
    snap = pipe.map.snapshot_problem(kfs, min_obs=2)
    n_solve = int(snap.pt_ids.shape[0])
    n_obs = int(np.asarray(snap.valid).sum())

    # measured BA it/s on the real problem: LSQ marginal fit over scan
    # lengths (utils/marginal.py methodology)
    dense, _dropped, max_obs = densify_problem_auto(
        snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2, snap.valid,
        snap.cam_fixed, snap.points.shape[0],
        max_obs=cfg.ba_max_obs_per_pt,
    )
    cams0 = jnp.asarray(snap.extr)
    pts0 = jnp.asarray(snap.points)

    def _t(it):
        lmcfg = LMConfig(max_iters=it, solver="dense")
        out = dense_ba_solve(dense, cams0, pts0, lmcfg)
        t0 = time.perf_counter()  # timed call (first call compiled)
        out = dense_ba_solve(dense, cams0, pts0, lmcfg)
        jax.device_get((out[0], out[1]))
        return time.perf_counter() - t0

    fit = measure_marginal(_t, iter_counts=(8, 24, 48, 72), repeats=2)
    Kp, Lp = int(snap.extr.shape[0]), int(snap.points.shape[0])
    roof = roofline(fit["iters_per_s"], Kp, Lp, max_obs, jax.devices()[0],
                    solver="dense")
    return {
        "metric": "config7_global_ba_10k" + ("" if mode == "single"
                                             else f"_{mode}"),
        "ate_rmse_m": round(res["rmse"], 4),
        "ate_online_m": round(res["ate_online"], 4),
        "steady_fps": round(fps, 2),
        "jit_compiles": ncomp,
        "wall_s": round(wall, 1),
        "frames": n_frames,
        "keyframes": pipe.stats["keyframes"],
        "keyframes_active": len(kfs),
        "landmarks_active": int(len(pipe.map.active_points())),
        "landmarks_in_solve": n_solve,
        "obs_in_solve": n_obs,
        "max_obs_per_pt": max_obs,
        "global_ba_mode": mode,
        "ba_iter_per_s": round(fit["iters_per_s"], 1),
        "ba_marginal_ms": round(fit["slope_s"] * 1e3, 4),
        "ba_marginal_ms_stderr": round(fit["slope_stderr_s"] * 1e3, 4),
        "ba_marginal_flops_share": round(roof["flops_share"], 4),
        "solve_shape_KLO": [Kp, Lp, max_obs],
    }


def checkpoint_resume_worker(spec_path):
    """One half of the checkpoint/resume equivalence protocol, run in its
    own process: `python -c "import protocols;
    protocols.checkpoint_resume_worker(p)"`.

    The JSON spec names the (deterministic) scene, the config, the frame
    `start` and the checkpoint path.  mode "straight" processes the frames
    before `start`, saves the checkpoint, then runs on to the end;
    mode "resume" (the default) loads the checkpoint in a fresh process and
    processes the remaining frames.  Either way the pipeline finalizes and
    the final ATE goes to spec["out"]."""
    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("platform") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from bundleadjustment_tpu.metrics import evaluate_ate
    from bundleadjustment_tpu.pipeline import (
        BundleAdjustmentPipeline,
        PipelineConfig,
    )
    from bundleadjustment_tpu.pipeline.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    if spec["scene"] == "layered":
        from bundleadjustment_tpu.data.synthetic import (
            render_layered_scene as render,
        )
    else:
        from bundleadjustment_tpu.data.synthetic import (
            render_plane_sequence as render,
        )
    frames, K4 = render(**spec["render"])
    cfg = PipelineConfig(**spec["cfg"])
    ds = make_dataset(frames)
    t0 = time.perf_counter()
    if spec.get("mode", "resume") == "straight":
        r = spec["render"]
        pipe = BundleAdjustmentPipeline(cfg, K4, r["width"], r["height"])
        pipe.process_frames(ds[:spec["start"]])
        save_checkpoint(spec["ckpt"], pipe)
    else:
        pipe = load_checkpoint(spec["ckpt"], cfg)
    pipe.process_frames(ds[spec["start"]:])
    pipe.finalize()
    wall = time.perf_counter() - t0
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    res = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)
    import jax

    out = {
        "device": str(jax.devices()[0]),
        "ate_rmse_m": round(res["rmse"], 4),
        "frames_tracked": int(len(ts)),
        "keyframes": int(pipe.stats["keyframes"]),
        "landmarks": int(len(pipe.map.active_points())),
        "wall_s": round(wall, 1),
    }
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


def config6_checkpoint_resume(seed=16):
    """Protocol-scale checkpoint/resume equivalence: run config 6's
    500-frame sequence, checkpoint at frame 250 and run on (the straight
    run), then resume from the checkpoint in a FRESH process and run to
    completion; compare the final ATEs.  Both halves run in child
    processes one after the other, and the caller must not have started a
    JAX backend (see `main`), so only one process holds the device at a
    time.  The feats-not-checkpointed fallback (pipeline/checkpoint.py)
    means frames tracked before the cut lose guided re-association at
    finalize — the delta quantifies that degradation.  The reference has
    no checkpointing at all (SURVEY.md §5)."""
    import os
    import subprocess
    import sys
    import tempfile

    tmpd = tempfile.mkdtemp(prefix="ckpt6_")
    spec = {
        "ckpt": os.path.join(tmpd, "state.npz"), "scene": "layered",
        "render": dict(
            n_frames=500, width=640, height=480, fx=525.0, fy=525.0,
            trajectory="sweep", motion_step=0.04, rot_step=0.01, seed=seed,
        ),
        "cfg": dict(
            init_type="gtdepth", estimation="ba", local_ba=True,
            cull_frames=True, n_features=1000, n_levels=8,
        ),
        "start": 250,
    }
    out = {}
    for mode in ("straight", "resume"):
        spec_path = os.path.join(tmpd, f"{mode}.json")
        with open(spec_path, "w") as f:
            json.dump({**spec, "mode": mode,
                       "out": os.path.join(tmpd, f"{mode}_out.json")}, f)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import protocols; "
             f"protocols.checkpoint_resume_worker({spec_path!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=3600,
        )
        if proc.returncode != 0:
            return {"metric": "config6_checkpoint_resume", "error":
                    f"{mode}: {proc.stderr[-500:]}"}
        with open(os.path.join(tmpd, f"{mode}_out.json")) as f:
            out[mode] = json.load(f)
    straight, resumed = out["straight"], out["resume"]
    return {
        "metric": "config6_checkpoint_resume",
        "ate_straight_m": straight["ate_rmse_m"],
        "ate_resumed_m": resumed["ate_rmse_m"],
        "ate_delta_m": round(abs(resumed["ate_rmse_m"]
                                 - straight["ate_rmse_m"]), 4),
        "frames": 500, "checkpoint_at": 250,
        "checkpoint_mb": round(os.path.getsize(spec["ckpt"]) / 1e6, 1),
        "keyframes_straight": straight["keyframes"],
        "keyframes_resumed": resumed["keyframes"],
        "wall_straight_s": straight["wall_s"],
        "wall_resume_s": resumed["wall_s"],
        "device": straight["device"],
    }


PROTOCOLS = {
    "1": config1,
    "2": config2,
    "3": config3,
    "4": config4_teddy,
    "5": config5_replica_geometry,
    "6": config6_long_sequence,
    "7": config7_global_10k,
    "6r": config6_checkpoint_resume,
}


def seed_sweep(names=("1", "2", "3", "4", "5", "6"), offsets=(0, 100, 200)):
    """Seed-robustness sweep (round-4 VERDICT #3): every config at >=3
    scene/trajectory seeds (offset 0 = the canonical seed).  Prints one
    JSON line per run plus a summary row per config with mean/max/spread.
    The reference is evaluated across whole TUM sequences, not one draw
    (`/root/reference/ba_project/src/metrics/evaluate_ate_scale.py:131-180`)
    — multi-seed synthetics are this environment's equivalent."""
    import inspect

    import jax

    dev = str(jax.devices()[0])
    summary = []
    for name in names:
        fn = PROTOCOLS[name]
        base = inspect.signature(fn).parameters["seed"].default
        ates = []
        for off in offsets:
            out = fn(seed=base + off)
            out["device"] = dev
            out["scene_seed"] = base + off
            print(json.dumps(out), flush=True)
            ates.append(out["ate_rmse_m"])
        row = {
            "metric": f"seed_sweep_config{name}",
            "seeds": [base + o for o in offsets],
            "ate_all_m": ates,
            "ate_mean_m": round(float(np.mean(ates)), 4),
            "ate_max_m": round(float(np.max(ates)), 4),
            "ate_spread_m": round(float(np.max(ates) - np.min(ates)), 4),
            "in_bound_0p05": bool(np.max(ates) < 0.05),
        }
        summary.append(row)
        print(json.dumps(row), flush=True)
    return summary


# protocols whose work runs in child processes: they run before this
# process starts a JAX backend, which would hold the card the children need
CHILD_PROTOCOLS = ("6r",)


def main(argv=None):
    import sys

    names = (argv if argv is not None else sys.argv[1:]) or list(PROTOCOLS)
    if names and names[0] == "sweep":
        names = names[1:] or ("1", "2", "3", "4", "5", "6")
        if set(names) & set(CHILD_PROTOCOLS):
            raise SystemExit(f"sweep: {CHILD_PROTOCOLS} cannot be swept")
        seed_sweep(names)
        return
    # "1:111" runs config 1 at scene seed 111
    runs = [tuple(n.split(":")) if ":" in n else (n, None) for n in names]
    # child protocols first; the stable sort keeps the given order otherwise
    runs.sort(key=lambda r: r[0] not in CHILD_PROTOCOLS)
    for name, seed in runs:
        fn = PROTOCOLS[name]
        out = fn() if seed is None else fn(seed=int(seed))
        if "device" not in out:
            import jax

            out["device"] = str(jax.devices()[0])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
