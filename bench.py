"""Global-BA benchmark: dense LM iterations/s on one NVIDIA GPU.

Builds a synthetic global bundle-adjustment problem (64 cameras / 10k
landmarks), times the jitted dense-layout exact LM/DENSE_SCHUR solve
(`solvers/dense_ba.py`) on the GPU, and compares it with the flat engine on
the host CPU (the hardware class the reference's Ceres solver runs on,
`ba_project/src/ba/Optimizer.cpp:88`), run in a child process pinned to the
CPU platform.  Also times the 128-camera / 100k-landmark solve and the
batched frontend in this process.

Exits with an error when JAX finds no GPU.  Prints the card's name and
power limit, then ONE JSON line:
  {"metric": "ba_iterations_per_s", "value": N, "unit": "iter/s",
   "vs_baseline": gpu_over_cpu_speedup, ...extras}
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

N_CAMS = 64
N_PTS = 10_000
OBS_PER_PT = 8
LM_ITERS = 10
PCG_ITERS = 50
MAX_OBS = 16


def build_problem():
    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.solvers.dense_ba import densify_problem

    sc = make_synthetic_scene(
        n_cams=N_CAMS, n_pts=N_PTS, obs_per_pt=OBS_PER_PT,
        pixel_noise=0.5, seed=0,
    )
    cam_fixed = np.zeros(N_CAMS, bool)
    cam_fixed[0] = True
    dense, dropped = densify_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
        cam_fixed, N_PTS, max_obs=MAX_OBS,
    )
    return sc, dense, int(sc.valid.sum()) - dropped


def time_solve(device, sc, dense, repeats=3, layout="dense", iters=LM_ITERS):
    """Time the LM solve on `device`.

    layout="dense": landmark-major one-hot engine;
    layout="flat": segment_sum engine (the faster one on CPU — the fair
    baseline for the reference's CPU/Ceres hardware class).
    """
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.solvers import BAProblem, LMConfig
    from bundleadjustment_tpu.solvers import lm as lm_mod
    from bundleadjustment_tpu.solvers.dense_ba import dense_ba_solve

    put = lambda x: jax.device_put(x, device)
    cams0 = put(jnp.asarray(sc.extr_init))
    pts0 = put(jnp.asarray(sc.points_init))
    # dense layout: exact DENSE_SCHUR (explicit S + Cholesky); flat layout:
    # matrix-free Schur-PCG
    if layout == "dense":
        config = LMConfig(max_iters=iters, solver="dense")
    else:
        config = LMConfig(max_iters=iters, solver="pcg", pcg_iters=PCG_ITERS)

    if layout == "dense":
        prob = jax.tree.map(put, dense)
        solve = lambda: dense_ba_solve(prob, cams0, pts0, config)
    else:
        cam_fixed = np.zeros(N_CAMS, bool)
        cam_fixed[0] = True
        prob = BAProblem(
            K4=put(jnp.asarray(sc.K4)),
            cam_idx=put(jnp.asarray(sc.cam_idx)),
            pt_idx=put(jnp.asarray(sc.pt_idx)),
            uv=put(jnp.asarray(sc.uv)),
            sigma2=put(jnp.asarray(sc.sigma2)),
            valid=put(jnp.asarray(sc.valid)),
            cam_fixed=put(jnp.asarray(cam_fixed)),
            pt_fixed=put(jnp.zeros(N_PTS, bool)),
        )
        solve = lambda: lm_mod.ba_solve(prob, cams0, pts0, config)

    def run():
        cams, pts, info = solve()
        jax.block_until_ready((cams, pts))
        return info

    info = run()  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return iters / best, float(info["cost0"]), float(info["cost"])


def time_frontend_batch(B, H=480, W=640, n_features=1000, n_levels=8,
                        repeats=3, n_sustained=4):
    """Sustained ms/frame of the batched frontend (`detect_batch`) at batch
    size B: the dispatch cost amortizes across the batch.  Sustained
    protocol: n_sustained back-to-back dispatches, then one wait."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.ops.features import FeatureConfig, detect_batch

    cfg = FeatureConfig(n_features=n_features, n_levels=n_levels)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.random((B, H, W)).astype(np.float32))
    det = jax.jit(lambda x: detect_batch(x, cfg))
    jax.block_until_ready(det(imgs))  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_sustained):
            out = det(imgs)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / (n_sustained * B) * 1e3


def _run_cpu_baseline():
    """The CPU flat-engine baseline in a child process pinned to the CPU
    platform, so it never touches the card this process holds.  Returns
    iters/s (NaN on failure, logged).  The child keeps no compile cache:
    XLA:CPU entries written there are tied to this host's CPU features."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = (
        "import json, jax, bench\n"
        "sc, dense, n_obs = bench.build_problem()\n"
        "it, c0, c = bench.time_solve(jax.devices('cpu')[0], sc, dense,"
        " repeats=1, layout='flat')\n"
        "print(json.dumps({'cpu_iters_per_s': it}))\n"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=900, env=env,
        )
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                return float(json.loads(line)["cpu_iters_per_s"])
            except (json.JSONDecodeError, KeyError):
                continue
        print(f"cpu baseline subprocess produced no JSON "
              f"(rc={proc.returncode}); stderr tail: {proc.stderr[-300:]}",
              file=sys.stderr)
    except subprocess.TimeoutExpired:
        print("cpu baseline subprocess timed out", file=sys.stderr)
    return float("nan")


def time_large(device):
    """128 cameras / 100k landmarks: full-solve iters/s, marginal
    per-iteration time, and its roofline share."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.solvers import LMConfig
    from bundleadjustment_tpu.solvers.dense_ba import (
        dense_ba_solve,
        densify_problem_auto,
    )
    from bundleadjustment_tpu.utils.flops import roofline
    from bundleadjustment_tpu.utils.marginal import measure_marginal

    K, L = 128, 100_000
    sc = make_synthetic_scene(n_cams=K, n_pts=L, obs_per_pt=6,
                              pixel_noise=0.5, seed=0)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    dense, _, O = densify_problem_auto(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cam_fixed,
        L, max_obs=8,
    )
    cams0 = jax.device_put(jnp.asarray(sc.extr_init), device)
    pts0 = jax.device_put(jnp.asarray(sc.points_init), device)

    def t_solve(it):
        cfg = LMConfig(max_iters=it, solver="dense")
        jax.block_until_ready(dense_ba_solve(dense, cams0, pts0, cfg))
        t0 = time.perf_counter()
        jax.block_until_ready(dense_ba_solve(dense, cams0, pts0, cfg))
        return time.perf_counter() - t0

    fit = measure_marginal(t_solve, iter_counts=(5, 15, 40), repeats=3)
    roof = roofline(fit["iters_per_s"], K, L, O, device, solver="dense")
    return {
        "large_n_cams": K,
        "large_n_landmarks": L,
        "large_iter_per_s": round(5 / t_solve(5), 3),
        "large_marginal_ms_per_iter": round(fit["slope_s"] * 1e3, 4),
        "large_marginal_ms_stderr": round(fit["slope_stderr_s"] * 1e3, 4),
        "large_marginal_flops_share": round(roof["flops_share"], 4),
    }


def main():
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: JAX found no GPU (first device: "
                         f"{dev.platform}); the benchmark runs only on one")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)

    from bundleadjustment_tpu.utils.cache import enable_persistent_cache
    from bundleadjustment_tpu.utils.flops import (
        FLOP_MODEL_VERSION,
        frontend_roofline,
        roofline,
    )
    from bundleadjustment_tpu.utils.marginal import measure_marginal

    enable_persistent_cache()
    large = time_large(dev)

    sc, dense, n_obs = build_problem()
    O_actual = int(dense.cam_idx.shape[1])  # densify trims unused O slots
    iters_dev, cost0, cost = time_solve(dev, sc, dense)
    roof = roofline(iters_dev, N_CAMS, N_PTS, O_actual, dev, solver="dense")

    # marginal per-iteration time: least-squares slope of wall time vs scan
    # length over 4 iteration counts x 3 repeats (utils/marginal.py); the
    # intercept absorbs dispatch latency, stderr is reported
    def _t(it):
        iters_s, _, _ = time_solve(dev, sc, dense, repeats=1, iters=it)
        return it / iters_s

    fit = measure_marginal(_t, iter_counts=(16, 48, 96, 144), repeats=3)
    roof_marginal = roofline(fit["iters_per_s"], N_CAMS, N_PTS, O_actual,
                             dev, solver="dense")

    fe_b8 = time_frontend_batch(8)
    fe_b32 = time_frontend_batch(32)
    fe_roof = frontend_roofline(fe_b32, 480, 640, dev)

    iters_cpu = _run_cpu_baseline()
    print(json.dumps({
        "metric": "ba_iterations_per_s",
        "value": round(iters_dev, 3),
        "unit": "iter/s",
        "vs_baseline": (round(iters_dev / iters_cpu, 3)
                        if iters_cpu == iters_cpu and iters_cpu > 0
                        else None),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "n_cams": N_CAMS,
        "n_landmarks": N_PTS,
        "n_obs": n_obs,
        "solver": "exact_dense_schur",
        "cpu_iters_per_s": (round(iters_cpu, 3)
                            if iters_cpu == iters_cpu else None),
        "cost_reduction": round(cost0 / max(cost, 1e-12), 1),
        # roofline: counted FLOPs/bytes per LM iteration (utils/flops.py)
        # against the card's float32 peak
        "flop_model_version": FLOP_MODEL_VERSION,
        "flops_per_iter": roof["flops_per_iter"],
        "achieved_tflops": round(roof["achieved_tflops"], 3),
        "flops_share": round(roof["flops_share"], 4),
        "arith_intensity": round(roof["arith_intensity"], 1),
        "dominant_term": roof["dominant_term"],
        "marginal_iter_per_s": round(fit["iters_per_s"], 1),
        "marginal_flops_share": round(roof_marginal["flops_share"], 4),
        "marginal_ms_per_iter": round(fit["slope_s"] * 1e3, 4),
        "marginal_ms_stderr": round(fit["slope_stderr_s"] * 1e3, 4),
        "marginal_fit_intercept_ms": round(fit["intercept_s"] * 1e3, 2),
        "marginal_fit_points": [[it, round(t, 5)] for it, t in fit["points"]],
        # batched frontend (640x480, 1000 features, 8 levels)
        "frontend_b8_ms_per_frame": round(fe_b8, 3),
        "frontend_b32_ms_per_frame": round(fe_b32, 3),
        "frontend_gflops": round(fe_roof["achieved_gflops"], 1),
        "frontend_bw_share": round(fe_roof["bw_share"], 4),
        "frontend_dominant_term": fe_roof["dominant_term"],
        **large,
    }))


if __name__ == "__main__":
    main()
