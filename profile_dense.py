"""Break one dense LM iteration down by stage on the current GPU.

    python profile_dense.py [--trace-dir DIR]

For 64 cameras / 10k landmarks and 128 cameras / 100k landmarks
(`solvers/dense_ba.py`, exact DENSE_SCHUR) it prints one JSON line each:

- the marginal time of one LM iteration (least-squares slope of solve time
  over scan lengths, `utils/marginal.py`);
- the time of each stage compiled on its own at the same shapes:
  evaluation + block assembly, the Pf build, the Q Q^T product, the
  Cholesky factor + solve;
- the card's top device kernels over a traced 5-iteration solve (XLA runs
  the solve's kernels inside CUDA command buffers, so the trace names
  kernels, not the HLO ops they came from).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import time

import numpy as np

SIZES = ((64, 10_000, 8, 16), (128, 100_000, 6, 8))


def _time(fn, *args, repeats=10):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device_time_by_op(trace_dir, top=15):
    """(top [(kernel, seconds)], busy seconds, window seconds) from the GPU
    kernel events of the newest trace under `trace_dir`."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    data = jax.profiler.ProfileData.from_file(path)
    by_op = collections.Counter()
    t_min, t_max = float("inf"), 0.0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                secs = ev.duration_ns * 1e-9
                by_op[ev.name] += secs
                t_min = min(t_min, ev.start_ns)
                t_max = max(t_max, ev.start_ns + ev.duration_ns)
    window = (t_max - t_min) * 1e-9 if t_max > t_min else 0.0
    return by_op.most_common(top), sum(by_op.values()), window


def profile(K, L, obs_per_pt, max_obs, trace_dir):
    import jax
    import jax.numpy as jnp

    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
    from bundleadjustment_tpu.solvers import LMConfig
    from bundleadjustment_tpu.solvers import dense_ba as dba
    from bundleadjustment_tpu.utils.marginal import measure_marginal

    sc = make_synthetic_scene(n_cams=K, n_pts=L, obs_per_pt=obs_per_pt,
                              pixel_noise=0.5, seed=0)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    dense, _, O = dba.densify_problem_auto(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, fixed, L,
        max_obs=max_obs)
    cams0 = jnp.asarray(sc.extr_init)
    pts0 = jnp.asarray(sc.points_init)

    def solve_time(iters):
        cfg = LMConfig(max_iters=iters, solver="dense")
        return _time(lambda: dba.dense_ba_solve(dense, cams0, pts0, cfg)[0],
                     repeats=3)

    fit = measure_marginal(solve_time, iter_counts=(5, 10, 20, 40),
                           repeats=1)

    # stages compiled on their own, at the solve's shapes
    @jax.jit
    def eval_assemble(dense, cams, pts):
        cm = dba._to_cm(dense)
        R = aa_to_rotmat(cams[:, :3])
        cost, r, Jc, Jp = dba._eval_cm(cm, R, cams[:, 3:], pts.T, True)
        return dba._assemble_cm(cm, r, Jc, Jp, lambda x: x)

    red, Vu, g_p, W = eval_assemble(dense, cams0, pts0)

    @jax.jit
    def schur_pf(dense, red, Vu, W):
        cm = dba._to_cm(dense)
        _U, _g, V = dba._damp_blocks_cm(cm, red, Vu, 1e-4)
        return dba._schur_pf(cm, W, dba._sym3_inv_cm(V))

    Pf = schur_pf(dense, red, Vu, W)
    qqt = jax.jit(dba._schur_qqt)
    S = qqt(Pf).reshape(6 * K, 6 * K)
    S = S.T @ S + 6 * K * jnp.eye(6 * K)  # an SPD system of the same size

    @jax.jit
    def cholesky(S, b):
        return jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), b)

    stages = {
        "eval_assemble": _time(eval_assemble, dense, cams0, pts0),
        "schur_pf": _time(schur_pf, dense, red, Vu, W),
        "schur_qqt": _time(qqt, Pf),
        "cholesky": _time(cholesky, S, jnp.ones(6 * K)),
    }

    cfg5 = LMConfig(max_iters=5, solver="dense")
    jax.block_until_ready(dba.dense_ba_solve(dense, cams0, pts0, cfg5))
    tdir = os.path.join(trace_dir, f"{K}c_{L}")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(dba.dense_ba_solve(dense, cams0, pts0, cfg5))
    top, busy, window = device_time_by_op(tdir)
    return {
        "K": K, "L": L, "O": O,
        "lm_iter_ms": fit["slope_s"] * 1e3,
        "lm_iter_ms_stderr": fit["slope_stderr_s"] * 1e3,
        "stage_ms": {k: v * 1e3 for k, v in stages.items()},
        "pf_bytes": int(Pf.size * Pf.dtype.itemsize),
        "trace_5iter_kernel_ms": busy * 1e3,
        "trace_5iter_window_ms": window * 1e3,
        "trace_5iter_top_ops_ms": [[n, s * 1e3] for n, s in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".traces",
        "profile_dense"))
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profile_dense: needs a GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    for K, L, obs, max_obs in SIZES:
        out = profile(K, L, obs, max_obs, args.trace_dir)
        print(json.dumps({"card": card, "device_kind": dev.device_kind,
                          **out}), flush=True)


if __name__ == "__main__":
    main()
