"""Background compile warm-up: pre-seed the pipeline's jit shape buckets.

The tracking/mapping driver jits a small, enumerable family of shape
buckets (SURVEY.md §7 hard part (a): power-of-two padding keeps the family
finite).  Each first-touch bucket stalls the frame loop for its compile.
XLA compiles on several threads at once, so this module enumerates the
buckets a run will plausibly touch and compiles them on daemon threads
while the pipeline is already tracking.  Warming calls the SAME
module-level jitted callables the driver uses, with identical static
arguments, so the C++ jit cache is hit when the frame loop arrives at the
bucket.

The reference has no compile step at all (Ceres/OpenCV are AOT C++), so
cold-start wall time is part of matching it.

Execution of the dummy problems is a few ms of device time each and runs
concurrently with tracking dispatches (JAX serializes them on-stream).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

logger = logging.getLogger(__name__)


def _ba_bucket_ladder(cfg):
    """(K, L, O, iters) dense-BA buckets a run plausibly touches.

    Snapshot bucketing: K = pow2(len(window), min 8), L = pow2(landmarks),
    O = cfg.ba_max_obs_per_pt (auto-doubled when observations would drop).
    """
    ladders = []
    for K in (8, 16):
        for L in (512, 1024, 2048):
            for O in (cfg.ba_max_obs_per_pt, 2 * cfg.ba_max_obs_per_pt):
                ladders.append((K, L, O, cfg.kf_ba_iters))
    # final global BA re-solves the full map at final_ba_iters
    for L in (1024, 2048):
        ladders.append((8, L, cfg.ba_max_obs_per_pt, cfg.final_ba_iters))
        ladders.append((16, L, cfg.ba_max_obs_per_pt, cfg.final_ba_iters))
    # post-init global BA runs at max(kf_ba_iters, 15) (driver.py:907)
    it15 = max(cfg.kf_ba_iters, 15)
    if it15 != cfg.kf_ba_iters:
        for L in (512, 1024):
            ladders.append((8, L, cfg.ba_max_obs_per_pt, it15))
    return ladders


class CompileWarmer:
    """Compiles the pipeline's expected jit buckets on background threads.

    Usage: `CompileWarmer(pipe).start()` right after pipeline construction.
    `wait(timeout)` joins (used by tests); the frame loop never needs to.
    """

    def __init__(self, pipe, n_threads: int = 6):
        self.pipe = pipe
        self.n_threads = n_threads
        self._tasks = []
        self._threads = []
        self._lock = threading.Lock()
        self.compiled = 0
        self.failed = 0

    # ---------------- task construction ----------------

    def _build_tasks(self):
        pipe = self.pipe
        cfg = pipe.cfg
        import jax.numpy as jnp

        H, W = pipe.height, pipe.width
        # keypoint capacity of the DETECTOR output (sum of per-level
        # allocations), not the map store's padded max_kp — the tracking
        # jits key on the detector shape
        from bundleadjustment_tpu.ops.features import _level_allocations

        M = sum(_level_allocations(pipe.feat_cfg))
        Dw = pipe.map.desc_words
        gray = jnp.zeros((H, W), jnp.float32)
        desc = jnp.zeros((M, Dw), jnp.uint32)
        valid = jnp.zeros((M,), bool)
        K4 = jnp.asarray(pipe.K4)

        from bundleadjustment_tpu.pipeline import driver as drv
        from bundleadjustment_tpu.solvers import BAProblem, LMConfig, ba_solve
        from bundleadjustment_tpu.solvers.lm import MotionOnlyConfig

        tasks = []

        # 0. bare detection — the FIRST dispatch of any run (reference
        # frame, `driver._detect`) and the largest critical-path compile.
        # Started first so a caller that overlaps warm-up with dataset
        # loading/rendering hides part of it.
        from bundleadjustment_tpu.ops.features import detect_and_describe

        tasks.append(("detect", lambda: detect_and_describe(
            gray, pipe.feat_cfg)))

        # 1. frontend: fused detect+match (first frames / non-fused path)
        def t_frontend():
            drv._frontend_jit(
                gray, desc, valid, feat_cfg=pipe.feat_cfg,
                ratio=cfg.match_ratio)
        tasks.append(("frontend", t_frontend))

        # 2. fused tracked-frame step (detect+match+assoc+motion-only BA)
        if cfg.fused_tracking and cfg.estimation in ("ba", "pnp"):
            mcfg = MotionOnlyConfig(
                outer_iters=cfg.motion_outer, inner_iters=cfg.motion_inner,
                robust=cfg.estimation == "ba")

            def t_fused():
                drv._track_fused_jit(
                    gray, desc, valid, jnp.zeros((M, 3), jnp.float32),
                    jnp.zeros((M,), bool), jnp.zeros((6,), jnp.float32), K4,
                    feat_cfg=pipe.feat_cfg, ratio=cfg.match_ratio,
                    assoc_max=cfg.assoc_max_dist, mcfg=mcfg,
                    max_obs=cfg.max_track_obs)
            tasks.append(("track_fused", t_fused))

            if cfg.track_batch > 1:
                use_tlm = cfg.track_local_map
                N0 = 1024  # first snapshot bucket (driver._tlm_snapshot)

                def make_batch(N):
                    def t_batch():
                        drv._track_batch_jit(
                            jnp.zeros((cfg.track_batch, H, W), jnp.float32),
                            desc, valid, jnp.zeros((M, 3), jnp.float32),
                            jnp.zeros((M,), bool),
                            jnp.full((M,), N, jnp.int32),
                            jnp.zeros((N, 3), jnp.float32),
                            jnp.zeros((N, pipe.map.desc_words), jnp.uint32),
                            jnp.zeros((N,), bool),
                            jnp.zeros((6,), jnp.float32),
                            jnp.zeros((6,), jnp.float32), K4,
                            feat_cfg=pipe.feat_cfg, ratio=cfg.match_ratio,
                            assoc_max=cfg.assoc_max_dist, mcfg=mcfg,
                            max_obs=cfg.max_track_obs,
                            min_track=cfg.min_track_points,
                            pnp_guard=(cfg.pnp_translation_guard
                                       if cfg.estimation == "pnp" else None),
                            tlm=use_tlm,
                            window_px=float(cfg.track_window_px),
                            search_max=float(cfg.search_max_dist),
                            width=pipe.width, height=pipe.height)
                    return t_batch
                tasks.append(("track_batch", make_batch(N0)))
                if use_tlm:
                    # second snapshot bucket: maps cross 1024 landmarks
                    # within a few keyframes at protocol feature counts
                    tasks.append(("track_batch_4k", make_batch(4 * N0)))

        # 3. pairwise triangulation buckets (keyframe + init path)
        def make_tri(cap):
            def t():
                drv._tri_gated_jit(
                    K4, jnp.zeros(6), jnp.zeros(6),
                    jnp.zeros((cap, 2), jnp.float32),
                    jnp.zeros((cap, 2), jnp.float32),
                    jnp.ones((cap,), jnp.float32),
                    jnp.ones((cap,), jnp.float32),
                    jnp.zeros((cap,), bool))
            return t
        for cap in (128, 256, 512, 1024):
            tasks.append((f"tri_{cap}", make_tri(cap)))
        # neighbor-batch matcher buckets follow the raised minimums in
        # driver._search_in_neighbors

        # 4. neighborhood-batched triangulation (keyframes)
        def make_tri_nb(NB, P):
            def t():
                drv._tri_batch_jit(
                    K4, jnp.zeros(6), jnp.zeros((NB, 6), jnp.float32),
                    jnp.zeros((NB, P, 2), jnp.float32),
                    jnp.zeros((NB, P, 2), jnp.float32),
                    jnp.ones((NB, P), jnp.float32),
                    jnp.ones((NB, P), jnp.float32),
                    jnp.zeros((NB, P), bool))
            return t
        for NB in (4, 8, 16):
            for P in (128, 256, 512):
                tasks.append((f"tri_nb{NB}x{P}", make_tri_nb(NB, P)))

        # 5. neighborhood batched matching (search_in_neighbors): the
        # b-side uses the MAP's padded per-frame capacity, the a-side the
        # detector capacity (mirrors _search_in_neighbors exactly)
        from bundleadjustment_tpu.ops.matching import match_descriptors_batch

        Mk = pipe.map.max_kp

        def make_match_nb(NB):
            def t():
                match_descriptors_batch(
                    desc, jnp.zeros((NB, Mk, Dw), jnp.uint32),
                    valid_a=valid, valids_b=jnp.zeros((NB, Mk), bool),
                    metric="hamming", ratio=cfg.match_ratio,
                    max_dist=cfg.search_max_dist)
            return t
        for NB in (8, 16):
            tasks.append((f"match_nb{NB}", make_match_nb(NB)))

        # 6. dense-BA bucket ladder (local/global/final solves)
        from bundleadjustment_tpu.solvers.dense_ba import (
            DenseBAProblem, dense_ba_solve,
        )

        def make_dense(K, L, O, iters):
            def t():
                prob = DenseBAProblem(
                    K4=K4,
                    cam_idx=jnp.zeros((L, O), jnp.int32),
                    uv=jnp.zeros((L, O, 2), jnp.float32),
                    sigma2=jnp.ones((L, O), jnp.float32),
                    valid=jnp.zeros((L, O), bool),
                    cam_fixed=jnp.zeros((K,), bool).at[0].set(True),
                    pt_valid=jnp.zeros((L,), bool),
                )
                lmcfg = LMConfig(max_iters=iters, solver=cfg.ba_solver,
                                 pcg_iters=cfg.pcg_iters)
                dense_ba_solve(prob, jnp.zeros((K, 6), jnp.float32),
                               jnp.zeros((L, 3), jnp.float32), lmcfg)
            return t
        if cfg.ba_layout in ("auto", "dense_landmark"):
            for K, L, O, iters in _ba_bucket_ladder(cfg):
                tasks.append((f"dense_ba_{K}x{L}x{O}x{iters}",
                              make_dense(K, L, O, iters)))

        # 7. flat BA (small problems under the auto threshold) + the
        # post-solve chi2 prune that runs in the flat layout either way
        from bundleadjustment_tpu.solvers.residuals import prune_outliers_cams

        def make_flat(K, L, N, iters):
            def t():
                prob = BAProblem(
                    K4=K4,
                    cam_idx=jnp.zeros((N,), jnp.int32),
                    pt_idx=jnp.zeros((N,), jnp.int32),
                    uv=jnp.zeros((N, 2), jnp.float32),
                    sigma2=jnp.ones((N,), jnp.float32),
                    valid=jnp.zeros((N,), bool),
                    cam_fixed=jnp.zeros((K,), bool).at[0].set(True),
                    pt_fixed=jnp.zeros((L,), bool),
                )
                cams = jnp.zeros((K, 6), jnp.float32)
                pts = jnp.zeros((L, 3), jnp.float32)
                if cfg.ba_layout == "flat":
                    lmcfg = LMConfig(max_iters=iters, solver=cfg.ba_solver,
                                     pcg_iters=cfg.pcg_iters)
                    cams, pts, _ = ba_solve(prob, cams, pts, lmcfg)
                prune_outliers_cams(prob, cams, pts)
            return t
        for K, L, N in ((8, 512, 2048), (8, 1024, 4096), (8, 2048, 8192),
                        (16, 1024, 4096), (16, 2048, 8192)):
            tasks.append((f"flat_prune_{K}x{L}x{N}",
                          make_flat(K, L, N, cfg.kf_ba_iters)))

        return tasks

    # ---------------- execution ----------------

    def _worker(self):
        while True:
            with self._lock:
                if not self._tasks:
                    return
                name, task = self._tasks.pop(0)
            try:
                task()
                with self._lock:
                    self.compiled += 1
            except Exception as e:  # warm-up must never break the pipeline
                with self._lock:
                    self.failed += 1
                logger.debug("warmup task %s failed: %s", name, e)

    def start(self):
        import jax

        if jax.default_backend() == "cpu":
            # on CPU the compile threads would compete with the pipeline
            # for the same cores, compiling buckets the run may never touch
            return self
        try:
            self._tasks = self._build_tasks()
        except Exception as e:
            logger.warning("compile warm-up disabled: %s", e)
            return self
        for _ in range(min(self.n_threads, len(self._tasks))):
            th = threading.Thread(target=self._worker, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def wait(self, timeout=None):
        for th in self._threads:
            th.join(timeout)
        return self.compiled, self.failed
