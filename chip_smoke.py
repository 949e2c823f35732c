"""Smoke run of the SfM / bundle-adjustment main path on an NVIDIA GPU.

    python chip_smoke.py           # phases 0-3 on one card
    python chip_smoke.py --four    # the multi-device paths on four cards

Phases (one JSON line of findings each; any failure exits non-zero):

0. device: JAX must find a GPU (no CPU fallback); prints the card's
   `nvidia-smi` name and power limit, `device_kind`, JAX version and the
   compile-cache directory.
1. end to end: renders the 120-frame 640x480 handheld RGB-D sequence
   (fx = fy = 525), writes it as a TUM dataset under `.smoke_data/`, and
   drives `bundleadjustment_tpu.cli.main` with tracking, local BA, keyframe
   culling and final global BA.  Requires ATE < 0.05 m and no tracking
   failure.
2. global BA: the dense LM/Schur solve at 64 cameras / 10k landmarks on the
   GPU against the same solve on the host CPU in this process, and at
   128 cameras / 100k landmarks against the cost at the ground truth.
3. tests: runs the test suite's `gpu`-marked tests in this process.

`--four` runs only the multi-device paths: the landmark-sharded dense solve
on a 4-card mesh against the single-card solve, the windowed and sharded
dry run (`__graft_entry__.dryrun_multichip`), and sharded feature detection
over 32 frames against single-device detection.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".smoke_data")  # generated data and outputs

ATE_BOUND_M = 0.05
# phase 2: GPU vs host-CPU solve of the same 64c/10k problem, both float32
# with full-precision products; on an H100 the gaps measured 3.9e-7
# (relative cost) and 3.1e-5 m (camera centres)
COST_RTOL = 1e-5
CENTER_ATOL_M = 5e-4
# --four: sharded vs single-card solve (psums sum in another order)
SHARDED_COST_RTOL = 1e-3
# --four: sharded vs single-device detection; keypoints of the two compiled
# programs may differ in the last float32 bits (a few 1e-5 px at 640 px)
XY_ATOL_PX = 1e-3
# phase 2: at 128c/100k, |final cost / cost at the ground truth - expected
# ratio| must stay below this (see phase_ba_large); on an H100 the ratio
# measured 0.6615 against an expected 0.6503
GT_RATIO_ATOL = 0.03


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def require_gpu(devices):
    """Exit unless JAX's first device is a GPU: a smoke run on any other
    backend proves nothing about the card."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (first device: {d.platform} "
            f"{d.device_kind!r}); this script runs only on an NVIDIA GPU")
    return d


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    from bundleadjustment_tpu.utils.cache import cache_dir

    dev = require_gpu(jax.devices())
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), cards=cards, jax=jax.__version__,
         compile_cache=cache_dir())
    return dev


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def write_handheld_dataset(root, n_frames=120, seed=12):
    """The config-2 handheld recipe as an on-disk TUM dataset."""
    from bundleadjustment_tpu.data.synthetic import (
        render_layered_scene,
        write_tum_format,
    )

    frames, K4 = render_layered_scene(
        n_frames=n_frames, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="handheld", motion_step=0.05, rot_step=0.012, seed=seed,
    )
    write_tum_format(root, frames)
    with open(os.path.join(root, "intrinsics.json"), "w") as f:
        json.dump({"fx": float(K4[0]), "fy": float(K4[1]),
                   "cx": float(K4[2]), "cy": float(K4[3]),
                   "width": 640, "height": 480}, f)
    return n_frames


def phase_end_to_end():
    from bundleadjustment_tpu import cli
    from protocols import CompileCounter

    data = os.path.join(DATA, "handheld120")
    t0 = time.perf_counter()
    n_frames = write_handheld_dataset(data)
    t_data = time.perf_counter() - t0
    out = os.path.join(DATA, "e2e_out")
    args = [
        "--dataset-name", "synthetic", "--dataset-path", data,
        "--output-path", out, "--frames", str(n_frames),
        "--init-type", "gtdepth", "--estimation", "ba", "--local-ba",
        "--cull-frames", "--n-features", "1000", "--n-levels", "8",
        "--trajectory",
    ]
    with CompileCounter() as cc:
        t0 = time.perf_counter()
        res = cli.main(args)
        wall = time.perf_counter() - t0
    fields = dict(
        frames=res["frames"], wall_s=wall, dataset_s=t_data,
        steady_fps=res.get("steady_fps"), ate_rmse_m=res.get("ate_rmse"),
        keyframes=res["keyframes"], landmarks=res["n_map_points"],
        tracking_failures=res["tracking_failures"],
        jit_compiles=cc.compiles, compile_cache_hits=cc.cache_hits,
        phase_times={k: v["total_s"] for k, v in res["phase_times"].items()},
    )
    emit("end_to_end", **fields)
    check(res["frames"] == n_frames, f"processed {res['frames']} frames")
    check(res.get("ate_rmse") is not None
          and res["ate_rmse"] < ATE_BOUND_M, f"ATE {res.get('ate_rmse')}")
    check(res["tracking_failures"] == 0,
          f"{res['tracking_failures']} tracking failures")
    return fields


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def build_dense_problem(n_cams, n_pts, obs_per_pt, max_obs, seed=0):
    """Synthetic scene + its dense layout, keeping every observation
    (`max_obs` is raised until none is dropped)."""
    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.solvers.dense_ba import densify_problem_auto

    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts,
                              obs_per_pt=obs_per_pt, pixel_noise=0.5,
                              seed=seed)
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    dense, dropped, _ = densify_problem_auto(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cam_fixed,
        n_pts, max_obs=max_obs,
    )
    check(dropped == 0, f"{dropped} observations dropped")
    return sc, cam_fixed, dense


def solve_on(device, dense, cams0, pts0, config):
    """Compile and run `dense_ba_solve` on `device`; returns
    (cams, points, info, seconds of the run, memory analysis)."""
    import jax

    from bundleadjustment_tpu.solvers.dense_ba import dense_ba_solve

    args = jax.device_put((dense, cams0, pts0), device)
    compiled = dense_ba_solve.lower(*args, config=config).compile()
    jax.block_until_ready(compiled(*args))  # warm
    t0 = time.perf_counter()
    cams, pts, info = jax.block_until_ready(compiled(*args))
    secs = time.perf_counter() - t0
    return (np.asarray(cams), np.asarray(pts),
            {k: np.asarray(v) for k, v in info.items()}, secs,
            _memory(compiled))


def _memory(compiled):
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def camera_centres(cams):
    from bundleadjustment_tpu.geometry import np_se3

    return np.stack([np_se3.rt6_inverse(c)[3:] for c in
                     np.asarray(cams, np.float64)])


def phase_ba_vs_cpu(gpu):
    import jax

    from bundleadjustment_tpu.solvers import LMConfig

    sc, _, dense = build_dense_problem(64, 10_000, 8, max_obs=16)
    cfg = LMConfig(max_iters=10, solver="dense")
    cams0, pts0 = sc.extr_init.astype(np.float32), sc.points_init.astype(
        np.float32)
    cg, _pg, ig, tg, mg = solve_on(gpu, dense, cams0, pts0, cfg)
    cc, _pc, ic, tc, _mc = solve_on(jax.devices("cpu")[0], dense, cams0,
                                    pts0, cfg)
    cost_g, cost_c = float(ig["cost"]), float(ic["cost"])
    rel = abs(cost_g - cost_c) / max(abs(cost_c), 1e-30)
    dc = float(np.max(np.linalg.norm(camera_centres(cg) - camera_centres(cc),
                                     axis=1)))
    emit("ba_64c_10k_vs_cpu", K=64, L=10_000, O=int(dense.cam_idx.shape[1]),
         iters=cfg.max_iters, cost0=float(ig["cost0"]), cost_gpu=cost_g,
         cost_cpu=cost_c, cost_rel_gap=rel, centre_max_gap_m=dc,
         gpu_solve_s=tg, cpu_solve_s=tc, gpu_memory=mg)
    check(np.isfinite(cost_g) and cost_g < float(ig["cost0"]),
          "GPU solve did not reduce the cost")
    check(rel < COST_RTOL, f"GPU/CPU final cost gap {rel:.3e}")
    check(dc < CENTER_ATOL_M, f"GPU/CPU camera centre gap {dc:.3e} m")


def gt_cost(sc, cam_fixed):
    """Robust cost of the flat problem at the ground-truth parameters
    (`solvers/lm.robust_cost`, independent of the dense engine)."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.solvers import BAProblem
    from bundleadjustment_tpu.solvers.lm import robust_cost
    from bundleadjustment_tpu.solvers.residuals import cams_to_Rt

    prob = BAProblem(
        K4=jnp.asarray(sc.K4), cam_idx=jnp.asarray(sc.cam_idx),
        pt_idx=jnp.asarray(sc.pt_idx), uv=jnp.asarray(sc.uv),
        sigma2=jnp.asarray(sc.sigma2), valid=jnp.asarray(sc.valid),
        cam_fixed=jnp.asarray(cam_fixed),
        pt_fixed=jnp.zeros(len(sc.points_gt), bool),
    )

    @jax.jit
    def cost(cams, pts):
        R, t = cams_to_Rt(cams)
        return robust_cost(prob, R, t, pts)

    return float(cost(jnp.asarray(sc.extr_gt, jnp.float32),
                      jnp.asarray(sc.points_gt, jnp.float32)))


def phase_ba_large(gpu):
    """128c/100k on the GPU against the cost at the ground truth.

    With Gaussian pixel noise the least-squares optimum fits part of the
    noise, so its cost lies BELOW the ground truth's, at the expected ratio
    1 - parameters / residuals (~0.65 here).  The check holds the final
    cost / ground-truth cost to that ratio within GT_RATIO_ATOL: a solve
    that stops short of the optimum, or products at a lower precision,
    land above it."""
    from bundleadjustment_tpu.solvers import LMConfig

    sc, cam_fixed, dense = build_dense_problem(128, 100_000, 6, max_obs=8)
    cfg = LMConfig(max_iters=10, solver="dense")
    _c, _p, info, secs, mem = solve_on(
        gpu, dense, sc.extr_init.astype(np.float32),
        sc.points_init.astype(np.float32), cfg)
    c_gt = gt_cost(sc, cam_fixed)
    cost = float(info["cost"])
    n_res = 2 * int(np.asarray(dense.valid).sum())
    n_par = 6 * (128 - 1) + 3 * 100_000
    ratio, expected = cost / c_gt, 1.0 - n_par / n_res
    emit("ba_128c_100k_vs_gt", K=128, L=100_000,
         O=int(dense.cam_idx.shape[1]), iters=cfg.max_iters,
         cost0=float(info["cost0"]), cost=cost, cost_at_gt=c_gt,
         ratio=ratio, expected_ratio=expected,
         gpu_solve_s=secs, gpu_memory=mem)
    check(np.isfinite(cost), "non-finite cost")
    check(abs(ratio - expected) <= GT_RATIO_ATOL,
          f"final/ground-truth cost ratio {ratio:.4f}, expected "
          f"{expected:.4f} +- {GT_RATIO_ATOL}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


class _Outcomes:
    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)


def phase_gpu_tests():
    import pytest

    res = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
         os.path.join(REPO, "tests", "test_gpu.py")],
        plugins=[res],
    )
    emit("gpu_tests", rc=int(rc), passed=res.passed, failed=res.failed,
         skipped=res.skipped)
    check(rc == 0 and res.passed and not res.failed and not res.skipped,
          f"gpu tests: rc={rc}")


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------


def phase_sharded_solve(devs):
    import jax
    from jax.sharding import Mesh

    from bundleadjustment_tpu.parallel.sharded_dense_ba import (
        AXIS,
        shard_dense_problem,
        sharded_dense_ba_solve,
    )
    from bundleadjustment_tpu.solvers import LMConfig

    sc, cam_fixed, dense = build_dense_problem(128, 100_000, 6, max_obs=8)
    cfg = LMConfig(max_iters=10, solver="dense")
    cams0 = sc.extr_init.astype(np.float32)
    _c1, _p1, info1, t1, _m1 = solve_on(
        devs[0], dense, cams0, sc.points_init.astype(np.float32), cfg)
    mesh = Mesh(np.array(devs), (AXIS,))
    # the same observation slots as the single-card problem: none dropped
    prob, pts_sh, _, _ = shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cam_fixed,
        sc.points_init, len(devs), max_obs=int(dense.cam_idx.shape[1]),
    )
    out = jax.block_until_ready(
        sharded_dense_ba_solve(prob, cams0, pts_sh, cfg, mesh))  # compile
    t0 = time.perf_counter()
    _cams, _pts, info4 = jax.block_until_ready(
        sharded_dense_ba_solve(prob, cams0, pts_sh, cfg, mesh))
    t4 = time.perf_counter() - t0
    del out
    c1, c4 = float(info1["cost"]), float(info4["cost"])
    rel = abs(c4 - c1) / max(abs(c1), 1e-30)
    emit("sharded_128c_100k", devices=len(devs), cost_1card=c1,
         cost_sharded=c4, cost_rel_gap=rel, solve_1card_s=t1,
         solve_sharded_s=t4)
    check(rel < SHARDED_COST_RTOL,
          f"sharded/single final cost gap {rel:.3e}")


def phase_dryrun(n):
    sys.path.insert(0, REPO)
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n)
    emit("dryrun_multichip", devices=n, wall_s=time.perf_counter() - t0)


def phase_predetect(devs):
    import jax
    from jax.sharding import Mesh

    from bundleadjustment_tpu.data.synthetic import render_layered_scene
    from bundleadjustment_tpu.ops.features import FeatureConfig
    from bundleadjustment_tpu.parallel.frontend import (
        FRAME_AXIS,
        detect_batch_sharded,
    )

    frames, _ = render_layered_scene(
        n_frames=32, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="handheld", motion_step=0.05, rot_step=0.012, seed=12)
    imgs = np.stack([f["gray"] for f in frames]).astype(np.float32)
    cfg = FeatureConfig(n_features=1000, n_levels=8)
    one = jax.device_get(detect_batch_sharded(imgs, cfg, mesh=None))
    mesh = Mesh(np.array(devs), (FRAME_AXIS,))
    many = jax.device_get(detect_batch_sharded(imgs, cfg, mesh=mesh))
    same_valid = bool(np.array_equal(one.valid, many.valid))
    same_desc = bool(np.array_equal(np.where(one.valid[..., None], one.desc, 0),
                                    np.where(many.valid[..., None], many.desc,
                                             0)))
    xy_gap = float(np.max(np.abs(np.where(one.valid[..., None],
                                          one.xy - many.xy, 0.0))))
    emit("predetect_32", devices=len(devs), frames=len(imgs),
         keypoints=int(one.valid.sum()), same_valid=same_valid,
         same_desc=same_desc, xy_max_gap_px=xy_gap)
    check(same_valid and same_desc and xy_gap <= XY_ATOL_PX,
          "sharded detection differs from single-device detection")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)

    dev = phase_device()
    import jax

    if args.four:
        devs = jax.devices()
        check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        phase_sharded_solve(devs)
        phase_dryrun(4)
        phase_predetect(devs)
        count = 4
    else:
        phase_end_to_end()
        phase_ba_vs_cpu(dev)
        phase_ba_large(dev)
        phase_gpu_tests()
        count = 1  # every phase above runs on the first card only
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)


if __name__ == "__main__":
    main()
