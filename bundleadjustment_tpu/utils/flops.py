"""FLOP / byte accounting for the BA solvers and the frontend — roofline
shares against the card's published peaks.

A roofline share says what fraction of the card's peak a solve achieves,
not just its iterations/s.  The counts
below follow the dense component-major engine (`solvers/dense_ba.py`)
term by term; the reference has no analogue (Ceres reports only wall time,
`ba_project/src/ba/Optimizer.cpp:116-125`).

Conventions: 1 multiply-add = 2 FLOPs; K cameras, L landmarks (padded), O
observation slots per landmark.
"""

from __future__ import annotations


# Published peaks of one card, keyed by `jax.Device.device_kind`: NVIDIA
# H100 data sheet, dense rates without sparsity, at the full power limit
# (700 W SXM, 350 W PCIe).  "fp32" is the non-tensor-core float32 rate —
# what a float32 product at HIGHEST precision runs at; "tf32" and "bf16"
# are tensor-core rates; "hbm" is device-memory bandwidth in bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5
        "bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12,
    },
    "NVIDIA H100 PCIe": {
        "bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "hbm": 2.0e12,
    },
}


def device_peaks(device) -> dict:
    """The PEAKS row of a jax device; a device not in the table raises."""
    kind = getattr(device, "device_kind", str(device))
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            "utils/flops.PEAKS with its source") from None


# FLOP-model version, reported alongside roofline numbers.  v2: resid_jac
# 420->440 and no separate cost-eval term (the LM scan reuses the trial
# point's residuals).
FLOP_MODEL_VERSION = 2


def dense_ba_iter_flops(K: int, L: int, O: int, solver: str = "dense",
                        pcg_iters: int = 0) -> dict:
    """FLOPs for ONE LM iteration of `dense_ba_solve` (component-major).

    Returns a breakdown dict with 'total'.  Terms follow dense_ba.py:

    - fused eval (one per iteration): projection, duv_dx, J_phi/Jp
      contractions, robust-cost rho — elementwise over [O, L] (~440
      FLOPs/obs counted from the unrolled component loops).  The trial
      point's REDUCED blocks (red/Vu/g_p/W) come from the SAME pass and are
      carried into the next iteration on acceptance, so there is no
      separate cost evaluation or per-iteration re-assembly;
    - block build: U/g_c one-hot reduce (21 symmetric-unique U rows + 6
      gradient rows = 27), V (6 unique), g_p (6), W (36);
    - schur (exact): G build, Pf one-hot batched matmul, S = QQ^T
      (the dominant term: 2*(6K)^2*(3L)), Cholesky (6K)^3/3, solve;
    - schur (pcg): per-CG-iteration matvec = gather + W-chain + reduce;
    - back-substitution.
    """
    OL = O * L
    br = {}
    br["resid_jac"] = 440 * OL
    # U (21 unique symmetric rows) + g_c (6 rows) via one-hot [K, O*L] matmul
    br["reduce_U"] = 2 * 27 * K * OL
    br["V_gp_W"] = (2 * 6 + 2 * 3 + 36) * OL
    # camera gather of [K,12] pose table
    br["gather_pose"] = 2 * 12 * K * OL
    if solver == "dense":
        br["schur_G"] = 2 * 54 * OL
        br["schur_Pf"] = 2 * 18 * K * OL
        br["schur_QQt"] = 2 * (6 * K) ** 2 * (3 * L)
        br["schur_chol"] = (6 * K) ** 3 // 3
        br["schur_rhs"] = 2 * 6 * K * OL + (2 * 9 + 2 * 18) * OL
    else:
        per_cg = (
            2 * 6 * K * OL  # gather dc
            + (36 + 18 + 36) * 2 * OL  # W chains + V_inv apply
            + 2 * 6 * K * OL  # reduce back
            + 2 * 36 * K  # U x
        )
        br["pcg"] = pcg_iters * per_cg + 2 * 36 * K * K  # + Minv prep
    # back-substitution: gather + W reduce + V_inv apply
    br["backsub"] = 2 * 6 * K * OL + (36 + 18) * 2 * OL
    br["total"] = sum(br.values())
    return br


def dense_ba_iter_bytes(K: int, L: int, O: int, dtype_bytes: int = 4) -> dict:
    """Approximate HBM traffic per LM iteration (reads of the big
    per-observation tensors; small K-sized tables ignored).

    Counts one read per materialized [.., O, L] tensor per consumer pass:
    problem inputs (uv 2, sigma 2, valid ~1, cam_idx 1), residuals (2),
    Jc (12), Jp (6), W (18), G (18), plus the [6K, 3L] Q read twice by the
    QQ^T matmul's operands (XLA reuses tiles; this is the upper bound).
    """
    OL = O * L
    tensors_OL = 2 + 2 + 1 + 1 + 2 + 12 + 6 + 18 + 18
    q = 2 * (6 * K) * (3 * L)
    total = dtype_bytes * (tensors_OL * OL + q)
    return {"total": total, "per_obs_tensors": dtype_bytes * tensors_OL * OL,
            "q_matrix": dtype_bytes * q}


# ---------------------------------------------------------------------------
# feature-frontend model (ops/features.py: detect_and_describe)
# ---------------------------------------------------------------------------


def _frontend_level_dims(H, W, n_levels, scale_factor, border=16):
    """Per-level (h, w) exactly as detect_and_describe computes them."""
    dims = [(H, W)]
    for lvl in range(1, n_levels):
        s = scale_factor ** lvl
        dims.append((max(int(round(H / s)), 2 * border + 8),
                     max(int(round(W / s)), 2 * border + 8)))
    return dims


def _frontend_level_allocs(n_features, n_levels, scale_factor):
    """Per-level keypoint budgets (ops/features.py:_level_allocations)."""
    inv = 1.0 / scale_factor
    weights = [inv ** i for i in range(n_levels)]
    total = sum(weights)
    alloc = [int(n_features * w / total) for w in weights]
    alloc[0] += n_features - sum(alloc)
    return [max(a, 8) for a in alloc]


def frontend_flops(H, W, n_features=1000, n_levels=8, scale_factor=1.2,
                   n_disc=709, n_bits=256) -> dict:
    """FLOPs (+ integer-op and byte estimates) for ONE frame of
    `detect_and_describe` (ops/features.py), term by term.

    Terms follow the shift-add/matmul lowering:

    - resize: two dense matmuls per level>0, [h_l,H]@[H,W] + [h_l,W]@[W,w_l]
      (the only matrix products; everything else is elementwise);
    - sobel: 2 gradients x 2 separable passes (2+3 nonzero taps, 2 FLOP/tap);
    - structure tensor: 3 products + 3-channel separable 7-tap blur;
    - harris/shi response arithmetic;
    - fast: 16 circle compares x2 polarities + 2x contiguous-9 shift-AND
      chains (integer ops, counted separately);
    - nms + top-k: 9-neighbor max + ~2 compares/element partial reduction;
    - blur: separable 7-tap over the level image;
    - orientation: [M_l, n_disc] gather + centroid moments (5 FLOP/sample);
    - brief: pattern rotation (8 FLOP/bit), 2 gathers/bit, compare+pack
      (~6 op/bit);
    - subpixel: ~20 FLOP/keypoint.

    Bytes: each full-image pass reads+writes the level plane once; the model
    counts the distinct [h_l, w_l] traversals of the fused graph (XLA fuses
    the elementwise chains, so passes ~ the number of independent
    producer/consumer groups: sobel in, 3ch blur in+out, fast in, nms,
    top-k, blur, resize in/out) — an estimate good to tens of percent,
    stated as such.
    """
    dims = _frontend_level_dims(H, W, n_levels, scale_factor)
    allocs = _frontend_level_allocs(n_features, n_levels, scale_factor)
    br = {"resize_mm": 0, "sobel": 0, "structure_blur": 0, "response": 0,
          "nms_topk": 0, "blur": 0, "orientation": 0, "brief": 0,
          "subpixel": 0}
    int_ops = 0
    bytes_ = 0
    for lvl, ((h, w), m) in enumerate(zip(dims, allocs)):
        p = h * w
        if lvl > 0:
            br["resize_mm"] += 2 * h * H * W + 2 * h * W * w
            bytes_ += 4 * (H * W + h * W + h * w)
        br["sobel"] += (4 + 6) * 2 * p  # kd(2 taps)+ks(3 taps), ix and iy
        br["structure_blur"] += 3 * p + 3 * 2 * 7 * 2 * p
        br["response"] += 12 * p
        int_ops += 128 * p  # fast compares + shift-AND chains
        br["nms_topk"] += 10 * p + 2 * p
        br["blur"] += 2 * 7 * 2 * p
        br["orientation"] += m * n_disc * 5
        br["brief"] += m * n_bits * (8 + 6)
        br["subpixel"] += 20 * m
        # ~12 fused full-plane traversals (read+write) per level
        bytes_ += 12 * 2 * 4 * p
        # gathers: orientation disc + brief endpoints
        bytes_ += 4 * m * (n_disc + 2 * n_bits)
    br["total"] = sum(br.values())
    return {**br, "int_ops": int_ops, "bytes": bytes_}


def frontend_roofline(ms_per_frame: float, H, W, device, n_features=1000,
                      n_levels=8, scale_factor=1.2) -> dict:
    """Achieved GFLOP/s and device-memory bandwidth for a measured per-frame
    time, as shares of the card's float32 and HBM peaks (the frontend runs
    at full float32 precision and is bandwidth-bound)."""
    fl = frontend_flops(H, W, n_features, n_levels, scale_factor)
    t = ms_per_frame / 1e3
    peaks = device_peaks(device)
    achieved = fl["total"] / t
    return {
        "flops_per_frame": fl["total"],
        "int_ops_per_frame": fl["int_ops"],
        "bytes_per_frame": fl["bytes"],
        "achieved_gflops": achieved / 1e9,
        "fp32_share": achieved / peaks["fp32"],
        "achieved_gbps": fl["bytes"] / t / 1e9,
        "bw_share": fl["bytes"] / t / peaks["hbm"],
        "dominant_term": max(
            ((k, v) for k, v in fl.items()
             if k not in ("total", "int_ops", "bytes")),
            key=lambda kv: kv[1],
        )[0],
    }


def roofline(iter_s: float, K: int, L: int, O: int, device,
             solver: str = "dense", pcg_iters: int = 0,
             precision: str = "fp32") -> dict:
    """Achieved TFLOP/s for a measured LM-iterations/s figure, its share of
    the card's peak at `precision` ("fp32" for the engine's HIGHEST float32
    products, "tf32"/"bf16" for tensor-core runs), the bytes share, and the
    arithmetic intensity."""
    fl = dense_ba_iter_flops(K, L, O, solver, pcg_iters)
    by = dense_ba_iter_bytes(K, L, O)
    peaks = device_peaks(device)
    achieved = fl["total"] * iter_s
    return {
        "flops_per_iter": fl["total"],
        "bytes_per_iter": by["total"],
        "arith_intensity": fl["total"] / max(by["total"], 1),
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": peaks[precision] / 1e12,
        "flops_share": achieved / peaks[precision],
        "bytes_share": by["total"] * iter_s / peaks["hbm"],
        "dominant_term": max(
            ((k, v) for k, v in fl.items() if k != "total"),
            key=lambda kv: kv[1],
        )[0],
    }
