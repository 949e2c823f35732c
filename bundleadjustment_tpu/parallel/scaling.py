"""Scaling-efficiency harness for the distributed Schur BA.

Measures LM-iterations/s of the landmark-sharded solve on meshes of 1..D
devices over the SAME total problem (strong scaling) or proportionally
grown problems (weak scaling), and reports efficiency = speedup /
device_count.

On XLA's virtual CPU devices it validates the harness and the sharding
path; times come only from cards joined by NVLink.
"""

from __future__ import annotations

import time

import numpy as np


def psum_bytes_per_iter(n_cams: int) -> int:
    """Bytes all-reduced per LM iteration of the landmark-sharded dense
    Schur solve — a function of the CAMERA count only (landmark-side state
    never crosses devices).  Read off the compiled HLO and locked by
    tests/test_scaling.py::test_sharded_ba_psum_traffic_independent_of_landmarks:
    the reduced camera system S [6K, 6K] f32 (dominant), the 27 reduced
    camera rows [K, 27], the rhs term [K, 6], and the scalar cost."""
    K = n_cams
    return 4 * (36 * K * K + 27 * K + 6 * K + 1)


def predicted_efficiency(
    n_cams: int,
    n_landmarks: int,
    n_devices: int,
    *,
    link_gbps: float,
    qqt_tflops: float,
) -> float:
    """Analytic scaling-efficiency floor for the landmark-sharded exact
    Schur solve on D devices:

      comm/iter  = 2 * psum_bytes * (D-1)/D / link_bw   (ring all-reduce)
      compute/iter ~= QQ^T flops / D / qqt_rate          (dominant term)
      efficiency = compute / (compute + comm)

    `link_gbps` is the all-reduce bandwidth per device in GB/s and
    `qqt_tflops` the achieved rate of the QQ^T contraction in TFLOP/s; both
    are measurements of the card in use, so neither has a default.  The
    model ignores the small fixed per-iteration terms, making it a FLOOR in
    the >=100k-landmark regime."""
    K, L, D = n_cams, n_landmarks, n_devices
    comm_s = 2 * psum_bytes_per_iter(K) * (D - 1) / D / (link_gbps * 1e9)
    qqt_flops = 2 * (6 * K) ** 2 * (3 * L)
    compute_s = qqt_flops / D / (qqt_tflops * 1e12)
    return compute_s / (compute_s + comm_s)


def measure_scaling(
    n_landmarks=8192,
    n_cams=32,
    obs_per_pt=6,
    device_counts=None,
    lm_iters=5,
    pcg_iters=30,
    repeats=2,
    weak=False,
    seed=0,
    layout="dense",
    solver="dense",
):
    """Returns {"per_device": [...], "efficiency": [...], ...}.

    layout: "dense" (landmark-major engine) | "flat" (segment_sum engine).
    """
    import jax
    from jax.sharding import Mesh

    from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu.parallel import shard_problem, sharded_ba_solve
    from bundleadjustment_tpu.parallel.sharded_ba import AXIS
    from bundleadjustment_tpu.parallel.sharded_dense_ba import (
        shard_dense_problem,
        sharded_dense_ba_solve,
    )
    from bundleadjustment_tpu.solvers import LMConfig

    devs = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devs)]

    results = []
    for d in device_counts:
        L = n_landmarks * d if weak else n_landmarks
        sc = make_synthetic_scene(
            n_cams=n_cams, n_pts=L, obs_per_pt=obs_per_pt, pixel_noise=0.5,
            seed=seed,
        )
        cam_fixed = np.zeros(n_cams, bool)
        cam_fixed[0] = True
        mesh = Mesh(np.array(devs[:d]), (AXIS,))
        cfg = LMConfig(max_iters=lm_iters, solver=solver, pcg_iters=pcg_iters)

        if layout == "dense":
            prob, pts_sharded, _, _ = shard_dense_problem(
                sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                cam_fixed, sc.points_init, d,
            )

            def run():
                cams, pts, info = sharded_dense_ba_solve(
                    prob, sc.extr_init, pts_sharded, cfg, mesh
                )
                np.asarray(cams)
                return info
        else:
            sharded, _, _ = shard_problem(
                sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                cam_fixed, sc.points_init, d,
            )

            def run():
                cams, pts, info = sharded_ba_solve(sharded, sc.extr_init, cfg, mesh)
                np.asarray(cams)
                return info

        run()  # compile
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        results.append(
            {
                "devices": d,
                "landmarks": L,
                "iters_per_s": lm_iters / best,
                "wall_s": best,
            }
        )

    base = results[0]["iters_per_s"]
    for r in results:
        if weak:
            # weak scaling: constant iters/s per device is 100%
            r["efficiency"] = r["iters_per_s"] / base
        else:
            r["efficiency"] = r["iters_per_s"] / (base * r["devices"])
    return {
        "mode": "weak" if weak else "strong",
        "device_counts": device_counts,
        "results": results,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(measure_scaling(), indent=2))
