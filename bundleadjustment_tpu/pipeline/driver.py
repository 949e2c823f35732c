"""Tracking / mapping pipeline driver.

The array-form re-design of the reference's `BundleAdjustment::run()` loop
(`ba_project/src/ba/BundleAdjustment.cpp:6-282`, call stack in SURVEY.md
§3.1): per-frame feature detection -> matching -> map association ->
constant-velocity prediction -> pose estimation -> keyframe decision ->
triangulation -> covisibility search/fusion -> local/global BA -> culling ->
final global BA -> trajectory + point-cloud outputs.

Division of labor:
- *device (JAX, jitted once per shape bucket)*: detection, descriptor
  matching, motion-only BA, two-view RANSAC, gated triangulation, and the
  LM/Schur bundle adjustment;
- *native C++ (mapstore)*: the branchy observation-graph mutation
  (insert / fuse / cull / covisibility);
- *Python*: thin orchestration, no per-observation loops on the hot path
  beyond graph writes.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry import np_se3
from bundleadjustment_tpu.geometry.epipolar import recover_pose_two_view
from bundleadjustment_tpu.geometry.triangulation import triangulate_gated
from bundleadjustment_tpu.mapstate import SceneMap
from bundleadjustment_tpu.ops.features import FeatureConfig, detect_and_describe
from bundleadjustment_tpu.ops.matching import (
    match_descriptors,
    match_descriptors_jit,
)
from bundleadjustment_tpu.pipeline.config import PipelineConfig
from bundleadjustment_tpu.solvers import BAProblem, LMConfig, ba_solve
from bundleadjustment_tpu.solvers.lm import MotionOnlyConfig, motion_only_ba
from bundleadjustment_tpu.solvers.residuals import (
    cams_to_Rt, prune_outliers, prune_outliers_cams,
)
from bundleadjustment_tpu.utils.precision import mm
from bundleadjustment_tpu.utils.profiling import PhaseTimer


def sample_color_bilinear(image, uv):
    """Sub-pixel color lookup (reference MapPoint.cpp:317-341).

    image: [H,W] gray in [0,1] or [H,W,3] uint8.  Returns [N,3] uint8.
    """
    h, w = image.shape[:2]
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    img = image.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None] * 255.0
    val = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    if val.shape[1] == 1:
        val = np.repeat(val, 3, axis=1)
    return np.clip(val, 0, 255).astype(np.uint8)


def sample_depth_bilinear(depth, uv):
    """Sub-pixel depth lookup; invalid (-inf / out of range) -> nan.

    Mirrors cv::getRectSubPix usage (reference Initializer.cpp:52,
    MapPoint.cpp:331): a sample is valid only if all 4 neighbors are valid.
    """
    h, w = depth.shape
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = x - x0
    fy = y - y0
    d00 = depth[y0, x0]
    d01 = depth[y0, x0 + 1]
    d10 = depth[y0 + 1, x0]
    d11 = depth[y0 + 1, x0 + 1]
    ok = np.isfinite(d00) & np.isfinite(d01) & np.isfinite(d10) & np.isfinite(d11)
    # zero out invalid corners before blending: -inf * 0 would emit nan
    # warnings even though the `ok` mask discards those samples
    d00, d01, d10, d11 = (np.where(ok, d, 0.0) for d in (d00, d01, d10, d11))
    val = (
        d00 * (1 - fx) * (1 - fy)
        + d01 * fx * (1 - fy)
        + d10 * (1 - fx) * fy
        + d11 * fx * fy
    )
    out = np.where(ok & (val > 0), val, np.nan)
    return out



def _match_prev(f, prev_desc, prev_valid, ratio):
    return match_descriptors(
        prev_desc, f.desc, valid_a=prev_valid, valid_b=f.valid,
        metric="hamming", ratio=ratio,
    )


@partial(jax.jit, static_argnames=("feat_cfg", "ratio"))
def _frontend_jit(gray, prev_desc, prev_valid, *, feat_cfg, ratio):
    """Fused detect+match: one device dispatch per tracked frame.

    Module-level (config as static args) so every pipeline instance with the
    same config shares one compilation — per-instance closures would retrace
    and recompile for each new pipeline.
    """
    f = detect_and_describe(gray, feat_cfg)
    idx, dist = _match_prev(f, prev_desc, prev_valid, ratio)
    return f, idx, dist


@partial(jax.jit, static_argnames=("ratio",))
def _match_only_jit(desc, valid, prev_desc, prev_valid, *, ratio):
    """Match pre-detected descriptors against the previous frame's.

    The predetect path's per-frame dispatch: detection already ran in the
    data-parallel batched frontend (`parallel/frontend.py`), so tracking only
    matches.  Same matcher semantics as `_match_prev`."""
    return match_descriptors(
        prev_desc, desc, valid_a=prev_valid, valid_b=valid,
        metric="hamming", ratio=ratio,
    )


@partial(jax.jit, static_argnames=("feat_cfg", "ratio", "assoc_max", "mcfg",
                                   "max_obs"))
def _track_fused_jit(gray, prev_desc, prev_valid, prev_xyz, prev_ok,
                     pred_extr, K4, *, feat_cfg, ratio, assoc_max, mcfg,
                     max_obs):
    """Fused tracked-frame step: detect + match + landmark association +
    motion-only BA in ONE dispatch.

    The association uses per-keypoint landmark state of the previous frame
    (positions + trackability mask) captured on the host at the end of the
    previous frame — so the whole per-frame device work runs without an
    intermediate host round-trip.
    """
    f = detect_and_describe(gray, feat_cfg)
    idx, dist = _match_prev(f, prev_desc, prev_valid, ratio)
    safe = jnp.clip(idx, 0, None)
    ok = (idx >= 0) & prev_ok & (dist < assoc_max)
    # honor cfg.max_track_obs like the split path (first-N truncation)
    ok = ok & (jnp.cumsum(ok) <= max_obs)
    rt, inl = motion_only_ba(
        K4,
        pred_extr[None].astype(jnp.float32),
        prev_xyz[None],
        f.xy[safe][None],
        f.sigma2[safe][None],
        ok[None],
        mcfg,
    )
    return f, idx, dist, ok, rt[0], inl[0]


@partial(jax.jit, static_argnames=("feat_cfg", "ratio",
                                   "assoc_max", "mcfg", "max_obs",
                                   "min_track", "pnp_guard", "tlm",
                                   "window_px", "search_max", "width",
                                   "height"))
def _track_batch_jit(grays, prev_desc, prev_valid, prev_xyz, prev_ok,
                     prev_sid, lm_xyz, lm_desc, lm_valid,
                     last_extr, prev_extr, K4, *, feat_cfg, ratio, assoc_max,
                     mcfg, max_obs, min_track, pnp_guard,
                     tlm=False, window_px=12.0, search_max=64.0,
                     width=640, height=480):
    """Device-resident tracking microbatch: `lax.scan` over B frames.

    Each step runs the full tracked-frame recurrence on device — constant-
    velocity prediction, detection, matching, landmark association, motion-
    only BA — and propagates the per-keypoint landmark state (position +
    trackability) to the next frame through the match permutation, exactly
    mirroring the host's observation writes for inlier associations (the map
    itself does not change across consecutive non-keyframe tracked frames:
    the only mutations are inlier kp->landmark writes and the erase of the
    previous non-keyframe, neither of which alters what the next frame can
    track).  One dispatch + one fetch per B frames instead of per frame —
    the SURVEY.md §7(d) amortization of the data-dependent keyframe sync.

    With `tlm` (track-local-map), each step adds the guided second pass of
    the per-frame path (`_track_local_map`): the batch-start snapshot of the
    well-observed landmarks (lm_xyz/lm_desc/lm_valid, frozen within a batch
    because the map only mutates at keyframes) is projected at the first-
    pass pose, descriptor-matched (ratio 0.9 + search_max) against the
    still-unassociated keypoints inside the window_px gate, and the pose is
    re-solved over the enlarged 2D-3D set; the re-solve wins when it keeps
    at least as many inliers.  prev_sid carries each keypoint's snapshot
    index so already-associated landmarks are excluded, and snapshot hits
    propagate into the next frame's trackable state like any other
    association.  (One caveat vs the per-frame path: representative
    descriptors refreshed by tracked-frame observations DURING the batch are
    not visible to the snapshot — a bounded staleness of < track_batch
    frames.)

    Results for frames after the first keyframe/tracking-loss in the batch
    are invalid (the host discards and re-runs them): a keyframe triangulates
    new landmarks and runs BA, which this scan cannot see.
    """
    from bundleadjustment_tpu.geometry import se3

    M = prev_desc.shape[0]
    N = lm_xyz.shape[0]

    def step(carry, gray):
        desc_p, valid_p, xyz_p, ok_p, sid_p, extr1, extr2 = carry
        # constant-velocity prediction (host analogue: _predict_extr)
        vel = se3.rt6_compose(extr1, se3.rt6_inverse(extr2))
        pred = se3.rt6_compose(vel, extr1)
        f = detect_and_describe(gray, feat_cfg)
        idx, dist = _match_prev(f, desc_p, valid_p, ratio)
        ok = (idx >= 0) & ok_p & (dist < assoc_max)
        ok = ok & (jnp.cumsum(ok) <= max_obs)
        safe = jnp.clip(idx, 0, None)
        rt, inl = motion_only_ba(
            K4, pred[None], xyz_p[None], f.xy[safe][None],
            f.sigma2[safe][None], ok[None], mcfg,
        )
        rt, inl = rt[0], inl[0]
        # the host's fallback rules (min associations; PnP translation jump
        # guard) decide whether observations are written — replicate them so
        # the propagated state matches the map the host will actually build
        good = jnp.sum(ok) >= min_track
        if pnp_guard is not None:
            good = good & (jnp.linalg.norm(rt[3:] - pred[3:]) < pnp_guard)
        extr = jnp.where(good, rt, pred)
        eff = ok & inl & good

        if tlm:
            # ---- guided local-map second pass (= _track_local_map) ----
            R = se3.aa_to_rotmat(extr[None, :3])[0]
            xc = mm(lm_xyz, R.T) + extr[3:]
            z = xc[:, 2]
            zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
            u = K4[0] * xc[:, 0] / zs + K4[2]
            v = K4[1] * xc[:, 1] / zs + K4[3]
            vis = (z > 0.05) & (u >= -window_px) & (u < width + window_px) \
                & (v >= -window_px) & (v < height + window_px)
            # exclude landmarks already in this frame's association set
            sid_ok = jnp.where(ok, sid_p, N)
            excl = jnp.zeros(N, bool).at[sid_ok].set(True, mode="drop")
            # keypoints still free (not matched to a tracked landmark)
            kp_assoc = jnp.zeros(M, bool).at[
                jnp.where(ok, safe, M)].set(True, mode="drop")
            kp_free = f.valid & ~kp_assoc
            cand_ok = lm_valid & vis & ~excl
            idx2, _d2 = match_descriptors(
                lm_desc, f.desc, valid_a=cand_ok, valid_b=kp_free,
                metric="hamming", ratio=0.9, max_dist=search_max,
            )
            safe2 = jnp.clip(idx2, 0, None)
            d_px2 = jnp.sum((f.xy[safe2] - jnp.stack([u, v], -1)) ** 2, -1)
            hit = (idx2 >= 0) & (d_px2 < window_px * window_px)

            # re-solve over the enlarged set
            P2 = jnp.concatenate([xyz_p, lm_xyz])
            U2 = jnp.concatenate([f.xy[safe], f.xy[safe2]])
            S2 = jnp.concatenate([f.sigma2[safe], f.sigma2[safe2]])
            V2 = jnp.concatenate([ok, hit])
            # host parity: motion_only pads to max_track_obs with first-N
            # truncation of the concatenated association list
            V2 = V2 & (jnp.cumsum(V2) <= max_obs)
            rt2, inl2 = motion_only_ba(
                K4, extr[None], P2[None], U2[None], S2[None], V2[None], mcfg,
            )
            rt2, inl2 = rt2[0], inl2[0]
            good2 = jnp.sum(V2) >= min_track
            if pnp_guard is not None:
                good2 = good2 & (jnp.linalg.norm(rt2[3:] - extr[3:])
                                 < pnp_guard)
            use2 = jnp.any(hit) & good2 & (
                jnp.sum(inl2 & V2) >= jnp.sum(ok & inl & good))
            extr = jnp.where(use2, rt2, extr)
            eff = jnp.where(use2, ok & inl2[:M], eff)
            eff_tlm = hit & inl2[M:] & use2
        else:
            hit = jnp.zeros(N, bool)
            eff_tlm = hit
            rt2 = rt
            inl2 = jnp.zeros(M + N, bool)
            use2 = jnp.asarray(False)
            idx2 = jnp.full(N, -1, jnp.int32)

        # propagate landmark state through the (injective) match permutation:
        # current keypoint j inherits prev keypoint i's landmark iff i was an
        # effective inlier association (== the host's kp_pt write rule)
        tgt = jnp.where(eff, safe, M)  # M = out-of-bounds drop slot
        xyz_n = jnp.zeros_like(xyz_p).at[tgt].set(xyz_p, mode="drop")
        ok_n = jnp.zeros_like(ok_p).at[tgt].set(eff, mode="drop")
        sid_n = jnp.full(M, N, jnp.int32).at[tgt].set(sid_p, mode="drop")
        if tlm:
            tgt2 = jnp.where(eff_tlm, jnp.clip(idx2, 0, None), M)
            xyz_n = xyz_n.at[tgt2].set(lm_xyz, mode="drop")
            ok_n = ok_n.at[tgt2].set(eff_tlm, mode="drop")
            sid_n = sid_n.at[tgt2].set(
                jnp.arange(N, dtype=jnp.int32), mode="drop")
        carry_n = (f.desc, f.valid, xyz_n, ok_n, sid_n, extr, extr1)
        out = (f.xy, f.octave, f.sigma2, f.desc, f.valid, idx, dist, ok, inl,
               rt, hit, idx2, inl2, rt2, use2)
        return carry_n, out

    init = (prev_desc, prev_valid, prev_xyz, prev_ok, prev_sid,
            last_extr.astype(jnp.float32), prev_extr.astype(jnp.float32))
    _, outs = jax.lax.scan(step, init, grays)
    return outs


@jax.jit
def _tri_batch_jit(K4, extr_a, extr_b, xa, xb, sa, sb, valid):
    """Gated triangulation vmapped over a neighbor axis (extr_a shared)."""
    return jax.vmap(
        triangulate_gated, in_axes=(None, None, 0, 0, 0, 0, 0, 0)
    )(K4, extr_a, extr_b, xa, xb, sa, sb, valid)


# pairwise gated triangulation as ONE dispatch instead of one per primitive
_tri_gated_jit = jax.jit(triangulate_gated)


def _pow2(n, minimum):
    """Smallest power-of-two bucket >= max(n, minimum) — the single place
    that defines the jit-shape bucketing policy for variable-length work."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _pad_pairs_pow2(uv1, uv2, minimum=64):
    """Pad two matched pixel sets to a shared power-of-two length (+ mask) so
    RANSAC/triangulation dispatches reuse a handful of jit shapes."""
    n = len(uv1)
    cap = _pow2(n, minimum)
    a = np.zeros((cap, 2), np.float32)
    b = np.zeros((cap, 2), np.float32)
    a[:n] = uv1
    b[:n] = uv2
    return a, b, np.arange(cap) < n


@dataclass
class FrameFeatures:
    xy: np.ndarray
    octave: np.ndarray
    sigma2: np.ndarray
    desc: np.ndarray
    valid: np.ndarray
    # device-resident copies (kept so frame-to-frame matching never bounces
    # descriptors through the host; None until first device use)
    desc_dev: object | None = None
    valid_dev: object | None = None


@dataclass
class TrackRecord:
    timestamp: float
    slot: int
    extr: np.ndarray  # world->camera rt6 at tracking time
    is_keyframe: bool
    # keyframe-relative anchoring (ORB-SLAM trajectory-output style): the
    # pose RELATIVE to the most recent keyframe at tracking time.  When
    # local/global BA later moves that keyframe, the tracked frame rides
    # along — drift corrections propagate structurally, with none of the
    # re-solve acceptance ambiguity (see _refine_trajectory's notes).
    ref_kf: int | None = None
    rel: np.ndarray | None = None  # extr o inv(kf_pose[ref_kf] at tracking)
    # inlier 2D-3D associations at tracking time (landmark ids + pixels) —
    # lets `finalize` re-track non-keyframes against the BA-refined map
    assoc_pt: np.ndarray | None = None
    assoc_uv: np.ndarray | None = None
    assoc_sig: np.ndarray | None = None
    # full keypoint set of the frame (cfg.refine_guided): lets finalize run
    # a guided re-association against the post-BA map before the re-solve
    feats: "FrameFeatures | None" = None
    assoc_kp: np.ndarray | None = None


class BundleAdjustmentPipeline:
    def __init__(self, config: PipelineConfig, K4, width, height):
        self.cfg = config
        self.K4 = np.asarray(K4, np.float32)
        self.width = width
        self.height = height
        self.map = SceneMap(
            max_frames=config.max_map_frames,
            max_points=config.max_map_points,
            max_kp=_feat_capacity(config),
            K4=self.K4,
        )
        self.feat_cfg = FeatureConfig(
            n_features=config.n_features,
            n_levels=config.n_levels,
            scale_factor=config.scale_factor,
            detector=config.detector,
        )
        self._key = jax.random.PRNGKey(config.seed)

        self.initialized = False
        self.ref_slot = None  # pre-init reference frame
        self.ref_feats: FrameFeatures | None = None
        self.last_slot = None
        self.last_feats: FrameFeatures | None = None
        self.prev_extr = None  # for constant-velocity model
        self.last_extr = None
        self.kf_counter = 0
        self.trajectory: list[TrackRecord] = []
        self.stats = {"frames": 0, "keyframes": 0, "tracking_failures": 0}
        self.timers = PhaseTimer()
        self._prev_track = None  # (xyz [M,3], trackable [M]) of last frame
        self._pending_seeds: list[int] = []  # 1-obs depth-seeded landmarks

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def detect(self, gray) -> FrameFeatures:
        with self.timers.phase("detect"):
            return self._detect(gray)

    def _detect(self, gray) -> FrameFeatures:
        f = detect_and_describe(jnp.asarray(gray), self.feat_cfg)
        fh = jax.device_get(f)
        return FrameFeatures(
            xy=fh.xy,
            octave=fh.octave,
            sigma2=fh.sigma2,
            desc=fh.desc,
            valid=fh.valid,
            desc_dev=f.desc,
            valid_dev=f.valid,
        )

    def detect_and_match(self, gray, prev: FrameFeatures):
        """Fused detect(current) + match(prev->current).

        Returns (FrameFeatures with device-resident descriptors, idx, dist).
        """
        with self.timers.phase("frontend"):
            if prev.desc_dev is None:
                prev.desc_dev = jnp.asarray(prev.desc)
                prev.valid_dev = jnp.asarray(prev.valid)
            f, idx, dist = _frontend_jit(
                jnp.asarray(gray), prev.desc_dev, prev.valid_dev,
                feat_cfg=self.feat_cfg, ratio=self.cfg.match_ratio,
            )
            # one batched device->host fetch instead of one per array
            fh, idx_h, dist_h = jax.device_get((f, idx, dist))
            feats = FrameFeatures(
                xy=fh.xy,
                octave=fh.octave,
                sigma2=fh.sigma2,
                desc=fh.desc,
                valid=fh.valid,
                desc_dev=f.desc,
                valid_dev=f.valid,
            )
            return feats, idx_h, dist_h

    def _track_fused(self, gray, prev: FrameFeatures, pred_extr):
        """Run the fused step; returns (feats, idx, dist, ok, rt6, inliers)
        as host arrays (feats keeps device-resident descriptors)."""
        with self.timers.phase("frontend"):
            if prev.desc_dev is None:
                prev.desc_dev = jnp.asarray(prev.desc)
                prev.valid_dev = jnp.asarray(prev.valid)
            xyz, okm, _ids = self._prev_track
            mcfg = MotionOnlyConfig(
                outer_iters=self.cfg.motion_outer,
                inner_iters=self.cfg.motion_inner,
                robust=self.cfg.estimation == "ba",
            )
            out = _track_fused_jit(
                jnp.asarray(gray), prev.desc_dev, prev.valid_dev,
                jnp.asarray(xyz), jnp.asarray(okm),
                jnp.asarray(pred_extr, jnp.float32),
                jnp.asarray(self.K4),
                feat_cfg=self.feat_cfg, ratio=self.cfg.match_ratio,
                assoc_max=self.cfg.assoc_max_dist, mcfg=mcfg,
                max_obs=self.cfg.max_track_obs,
            )
            f = out[0]
            fh, idx, dist, ok, rt, inl = jax.device_get(out)
            feats = FrameFeatures(
                xy=fh.xy, octave=fh.octave, sigma2=fh.sigma2,
                desc=fh.desc, valid=fh.valid,
                desc_dev=f.desc, valid_dev=f.valid,
            )
            return feats, idx, dist, ok, rt.astype(np.float64), inl

    def _tlm_snapshot(self):
        """Batch-start snapshot of the trackable (>=2-obs) landmarks for the
        in-scan guided local-map pass: (ids, xyz, desc, valid) padded to a
        power-of-two bucket.  Frozen within a tracking batch — the map only
        mutates at keyframes, which end the batch."""
        m = self.map
        cand = m.active_points()
        if len(cand):
            well = m.point_obs_counts(cand) >= 2
            cand = np.sort(cand[well])
        # x4 bucket steps from 1024: every distinct snapshot capacity is a
        # full recompile of the batch scan, so the bucket family is kept
        # tiny (1024, 4096, 16384, ...)
        N = 1024
        while N < len(cand):
            N *= 4
        xyz = np.zeros((N, 3), np.float32)
        desc = np.zeros((N, m.desc_words), np.uint32)
        valid = np.zeros(N, bool)
        n = len(cand)
        xyz[:n] = m.pt_pos[cand]
        desc[:n] = m.pt_desc[cand]
        valid[:n] = True
        return cand.astype(np.int64), xyz, desc, valid

    def _track_batch(self, grays):
        """Run the device-resident tracking microbatch over `grays`.

        Returns one precomputed tuple per input frame, shaped like the
        single-frame fused path's outputs plus the local-map second-pass
        results: (feats, matches, dists, assoc_ok, rt6, inliers, tlm_pre)
        where tlm_pre is None or a dict with the snapshot hits and the
        re-solved pose.
        """
        prev = self.last_feats
        if prev.desc_dev is None:
            prev.desc_dev = jnp.asarray(prev.desc)
            prev.valid_dev = jnp.asarray(prev.valid)
        xyz, okm, kp_ptid = self._prev_track
        mcfg = MotionOnlyConfig(
            outer_iters=self.cfg.motion_outer,
            inner_iters=self.cfg.motion_inner,
            robust=self.cfg.estimation == "ba",
        )
        use_tlm = (self.cfg.track_local_map
                   and self.cfg.estimation in ("ba", "pnp"))
        if use_tlm:
            snap_ids, lm_xyz, lm_desc, lm_valid = self._tlm_snapshot()
            # snapshot index per prev keypoint (N = "none" slot)
            sid = np.full(len(kp_ptid), len(lm_xyz), np.int32)
            has = kp_ptid >= 0
            sid[has] = np.searchsorted(snap_ids, kp_ptid[has]).astype(
                np.int32)
        else:
            snap_ids = np.zeros(0, np.int64)
            lm_xyz = np.zeros((256, 3), np.float32)
            lm_desc = np.zeros((256, self.map.desc_words), np.uint32)
            lm_valid = np.zeros(256, bool)
            sid = np.full(len(kp_ptid), 256, np.int32)
        B = len(grays)
        cap = max(int(self.cfg.track_batch), 1)
        gstack = np.stack([np.asarray(g, np.float32) for g in grays])
        if B < cap:  # pad to the compiled batch shape; padding is discarded
            gstack = np.concatenate(
                [gstack, np.repeat(gstack[-1:], cap - B, 0)]
            )
        with self.timers.phase("frontend"):
            out = _track_batch_jit(
                jnp.asarray(gstack), prev.desc_dev, prev.valid_dev,
                jnp.asarray(xyz), jnp.asarray(okm), jnp.asarray(sid),
                jnp.asarray(lm_xyz), jnp.asarray(lm_desc),
                jnp.asarray(lm_valid),
                jnp.asarray(self.last_extr, jnp.float32),
                jnp.asarray(self.prev_extr, jnp.float32),
                jnp.asarray(self.K4),
                feat_cfg=self.feat_cfg, ratio=self.cfg.match_ratio,
                assoc_max=self.cfg.assoc_max_dist, mcfg=mcfg,
                max_obs=self.cfg.max_track_obs,
                min_track=self.cfg.min_track_points,
                pnp_guard=(self.cfg.pnp_translation_guard
                           if self.cfg.estimation == "pnp" else None),
                tlm=use_tlm, window_px=float(self.cfg.track_window_px),
                search_max=float(self.cfg.search_max_dist),
                width=self.width, height=self.height,
            )
            (xy, octv, sig2, desc, valid, idx, dist, ok, inl, rt,
             hit, idx2, inl2, rt2, use2) = jax.device_get(out)
        desc_dev, valid_dev = out[3], out[4]  # device-resident [B, ...]
        pre = []
        for k in range(B):
            feats = FrameFeatures(
                xy=xy[k], octave=octv[k], sigma2=sig2[k],
                desc=desc[k], valid=valid[k],
                desc_dev=desc_dev[k], valid_dev=valid_dev[k],
            )
            tlm_pre = None
            if use_tlm:
                tlm_pre = {
                    "snap_ids": snap_ids, "hit": hit[k], "kp": idx2[k],
                    "inl2": inl2[k], "rt2": rt2[k].astype(np.float64),
                    "use2": bool(use2[k]),
                }
            pre.append((feats, idx[k], dist[k], ok[k],
                        rt[k].astype(np.float64), inl[k], tlm_pre))
        return pre

    def _can_batch_track(self):
        return (
            self.cfg.track_batch > 1
            and self.initialized
            and self.cfg.fused_tracking
            and self.cfg.estimation in ("ba", "pnp")
            and getattr(self, "_prev_track", None) is not None
        )

    def predetect_features(self, frames, mesh=None, chunk=32):
        """Data-parallel frame frontend: detect features for all frames up
        front, frame axis sharded over `mesh` (`parallel/frontend.py`).

        The reference detects inside the sequential tracking loop
        (`BundleAdjustment.cpp:79-80`); detection is frame-independent, so
        offline/mapping runs batch it across devices and the tracking loop
        consumes the results via `process_frames(..., prefeats=...)`.
        Returns a list of FrameFeatures (host arrays; device copies are
        created lazily on first match)."""
        from bundleadjustment_tpu.parallel.frontend import detect_batch_sharded

        out = []
        grays = [np.asarray(f.gray, np.float32) for f in frames]
        for s in range(0, len(grays), chunk):
            block = np.stack(grays[s:s + chunk])
            with self.timers.phase("detect"):
                f = detect_batch_sharded(block, self.feat_cfg, mesh=mesh)
                fh = jax.device_get(f)
            for k in range(block.shape[0]):
                out.append(FrameFeatures(
                    xy=fh.xy[k], octave=fh.octave[k], sigma2=fh.sigma2[k],
                    desc=fh.desc[k], valid=fh.valid[k],
                ))
        return out

    def process_frames(self, frames, timings=None, max_frames=None,
                       prefeats=None):
        """Process an iterable of FrameData with tracking microbatches.

        `prefeats`: per-frame FrameFeatures from `predetect_features` —
        disables the fused/microbatched dispatch (detection already ran) and
        tracks via the split match+estimate path.

        When `cfg.track_batch > 1` and tracking is steady, up to track_batch
        consecutive frames run as one device dispatch (`_track_batch_jit`);
        each frame's host bookkeeping then replays through `process_frame`
        with the precomputed device results.  Frames following a keyframe or
        a tracking loss inside a batch are discarded and re-run, because the
        keyframe mutates the map the batch's association chain assumed
        frozen.

        Returns the list of per-frame status strings (stops after
        "tracking-lost").  `timings`, if given, receives one attributed
        wall-time per processed frame (device batch time split across the
        frames the batch actually delivered).
        """
        import time as _time
        from collections import deque

        if prefeats is not None:
            statuses = []
            for f, pf in zip(frames, prefeats):
                if max_frames is not None and len(statuses) >= max_frames:
                    break
                t0 = _time.perf_counter()
                s = self.process_frame(f, prefeats=pf)
                if timings is not None:
                    timings.append(_time.perf_counter() - t0)
                statuses.append(s)
                if s == "tracking-lost":
                    break
            return statuses

        it = iter(frames)
        pending: deque = deque()
        drawn = 0
        exhausted = False

        def refill(n):
            nonlocal drawn, exhausted
            while (not exhausted and len(pending) < n
                   and (max_frames is None or drawn < max_frames)):
                try:
                    pending.append(next(it))
                    drawn += 1
                except StopIteration:
                    exhausted = True

        B = max(int(self.cfg.track_batch), 1)
        statuses = []
        while True:
            refill(B if self._can_batch_track() else 1)
            if not pending:
                break
            if not self._can_batch_track():
                t0 = _time.perf_counter()
                s = self.process_frame(pending.popleft())
                if timings is not None:
                    timings.append(_time.perf_counter() - t0)
                statuses.append(s)
                if s == "tracking-lost":
                    break
                continue
            chunk = [pending.popleft() for _ in range(min(B, len(pending)))]
            t0 = _time.perf_counter()
            pre = self._track_batch([f.gray for f in chunk])
            t_dev = _time.perf_counter() - t0
            consumed = 0
            for k, f in enumerate(chunk):
                t1 = _time.perf_counter()
                s = self.process_frame(f, precomputed=pre[k])
                statuses.append(s)
                consumed += 1
                if timings is not None:
                    timings.append(_time.perf_counter() - t1)
                if s != "tracked":
                    break
            # return unconsumed frames to the queue for re-processing
            for f in reversed(chunk[consumed:]):
                pending.appendleft(f)
            if timings is not None:
                # split the device batch time across delivered frames
                for j in range(consumed):
                    timings[-1 - j] += t_dev / consumed
            if statuses[-1] == "tracking-lost":
                break
        return statuses

    def _capture_track_state(self, slot, feats):
        """Host-side capture of the new last frame's per-keypoint landmark
        state (for the next frame's fused association): positions of the
        associated landmarks, the well-observed (>=2 obs) mask, and the
        landmark ids (for the batch path's local-map snapshot indexing)."""
        if not (self.cfg.fused_tracking
                and self.cfg.estimation in ("ba", "pnp")):
            self._prev_track = None
            return
        m = self.map
        M = len(feats.desc)
        kp_pt = m.kp_pt[slot, :M].astype(np.int64)
        has = kp_pt >= 0
        ok = has & (m.point_obs_counts(kp_pt) >= 2)
        xyz = np.zeros((M, 3), np.float32)
        xyz[has] = m.pt_pos[kp_pt[has]]
        ids = np.where(ok, kp_pt, -1)
        self._prev_track = (xyz, ok, ids)

    # ------------------------------------------------------------------
    # bundle adjustment wrappers
    # ------------------------------------------------------------------

    def _solve_ba(self, snap, max_iters, solver=None):
        with self.timers.phase("bundle_adjust"):
            return self._solve_ba_inner(snap, max_iters, solver)

    def _solve_ba_inner(self, snap, max_iters, solver=None):
        layout = self.cfg.ba_layout
        if layout == "auto":
            # dense_landmark once the problem is big enough to amortize the
            # regrouping; tiny problems stay on the flat engine to avoid
            # [L, max_obs] padding
            n_obs = int(np.asarray(snap.valid).sum())
            layout = ("dense_landmark"
                      if n_obs >= self.cfg.ba_layout_auto_min_obs else "flat")
        if layout == "dense_landmark":
            return self._solve_ba_dense(snap, max_iters)
        prob = BAProblem(
            K4=jnp.asarray(snap.K4),
            cam_idx=jnp.asarray(snap.cam_idx),
            pt_idx=jnp.asarray(snap.pt_idx),
            uv=jnp.asarray(snap.uv),
            sigma2=jnp.asarray(snap.sigma2),
            valid=jnp.asarray(snap.valid),
            cam_fixed=jnp.asarray(snap.cam_fixed),
            pt_fixed=jnp.zeros(snap.points.shape[0], bool),
        )
        cfg = LMConfig(
            max_iters=max_iters,
            solver=solver or self.cfg.ba_solver,
            pcg_iters=self.cfg.pcg_iters,
        )
        cams, pts, info = ba_solve(prob, jnp.asarray(snap.extr), jnp.asarray(snap.points), cfg)
        # post-solve chi2 pruning (reference Optimizer.cpp:270-277) as ONE
        # jitted dispatch; then one batched fetch
        new_valid = prune_outliers_cams(prob, cams, pts)
        cams_h, pts_h, nv_h = jax.device_get((cams, pts, new_valid))
        self.map.writeback(snap, cams_h, pts_h, nv_h)
        return info

    def _solve_ba_dense(self, snap, max_iters):
        """Dense-landmark-layout solve (solvers/dense_ba.py)."""
        from bundleadjustment_tpu.solvers.dense_ba import (
            dense_ba_solve,
            densify_problem_auto,
        )

        # auto-raise max_obs until no observation is dropped: a landmark seen
        # by more than max_obs keyframes must not silently lose constraints
        dense, dropped, max_obs = densify_problem_auto(
            snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2,
            snap.valid, snap.cam_fixed, snap.points.shape[0],
            max_obs=self.cfg.ba_max_obs_per_pt,
        )
        if dropped:
            logging.getLogger(__name__).warning(
                "dense BA: %d observations dropped at max_obs=%d "
                "(landmark observed by >%d keyframes)", dropped, max_obs,
                max_obs)
        cfg = LMConfig(max_iters=max_iters, solver=self.cfg.ba_solver,
                       pcg_iters=self.cfg.pcg_iters)
        cams, pts, info = dense_ba_solve(
            dense, jnp.asarray(snap.extr), jnp.asarray(snap.points), cfg
        )
        # chi2 prune in the flat layout for outlier writeback
        prob = BAProblem(
            K4=jnp.asarray(snap.K4),
            cam_idx=jnp.asarray(snap.cam_idx),
            pt_idx=jnp.asarray(snap.pt_idx),
            uv=jnp.asarray(snap.uv),
            sigma2=jnp.asarray(snap.sigma2),
            valid=jnp.asarray(snap.valid),
            cam_fixed=jnp.asarray(snap.cam_fixed),
            pt_fixed=jnp.zeros(snap.points.shape[0], bool),
        )
        new_valid = prune_outliers_cams(prob, cams, pts)
        cams_h, pts_h, nv_h = jax.device_get((cams, pts, new_valid))
        self.map.writeback(snap, cams_h, pts_h, nv_h)
        return info

    def _ba_mesh(self, axis):
        """Device mesh for distributed global BA: the injected
        `self.global_ba_mesh` when set (tests / multi-host drivers), else all
        local devices; None when only one device is present (the windowed
        path then uses its plain vmap form)."""
        m = getattr(self, "global_ba_mesh", None)
        if m is not None:
            if axis in m.axis_names:
                return m
            from jax.sharding import Mesh

            return Mesh(m.devices, (axis,))
        devs = jax.devices()
        if len(devs) == 1:
            return None
        from jax.sharding import Mesh

        return Mesh(np.array(devs), (axis,))

    def global_ba(self, max_iters=None):
        """Global BA over all active keyframes, routed by
        cfg.global_ba_mode (reference: the Ceres global solve is the
        pipeline's solver, Optimizer.cpp:93-160 invoked from
        BundleAdjustment.cpp:196-207,228-230 — here the distributed
        windowed/sharded engines are first-class pipeline solvers too)."""
        kfs = self.map.active_keyframes().tolist()
        if len(kfs) < 2:
            return None
        mode = self.cfg.global_ba_mode
        if mode == "windowed" and len(kfs) >= 3:
            return self._global_ba_windowed(max_iters or self.cfg.kf_ba_iters)
        snap = self.map.snapshot_problem(kfs, min_obs=2)
        if mode == "sharded":
            return self._solve_ba_sharded(snap,
                                          max_iters or self.cfg.kf_ba_iters)
        return self._solve_ba(snap, max_iters or self.cfg.kf_ba_iters)

    def _global_ba_windowed(self, max_iters):
        """Window-sharded global BA + pose-graph stitch
        (parallel/windows.py) as the pipeline's global solver."""
        from bundleadjustment_tpu.parallel.windows import (
            WINDOW_AXIS,
            windowed_global_ba,
        )

        with self.timers.phase("bundle_adjust"):
            cfg = LMConfig(max_iters=max_iters, solver=self.cfg.ba_solver,
                           pcg_iters=self.cfg.pcg_iters)
            return windowed_global_ba(
                self.map, window=self.cfg.local_window,
                stride=max(self.cfg.local_window // 2, 1),
                config=cfg, mesh=self._ba_mesh(WINDOW_AXIS),
            )

    def _solve_ba_sharded(self, snap, max_iters):
        """Landmark-sharded dense-engine solve over the device mesh
        (parallel/sharded_dense_ba.py): per-shard QQ^T Schur partials are
        psummed, everything landmark-side stays device-local."""
        from jax.sharding import Mesh

        from bundleadjustment_tpu.parallel.sharded_dense_ba import (
            AXIS,
            shard_dense_problem,
            sharded_dense_ba_solve,
        )

        with self.timers.phase("bundle_adjust"):
            mesh = self._ba_mesh(AXIS)
            if mesh is None:
                mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
            # max_obs: never silently drop a constraint — bucket the true
            # per-landmark max to a power of two for stable jit shapes
            counts = np.bincount(
                np.asarray(snap.pt_idx)[np.asarray(snap.valid)],
                minlength=snap.points.shape[0],
            )
            max_obs = _pow2(max(int(counts.max()) if counts.size else 1, 1),
                            self.cfg.ba_max_obs_per_pt)
            prob, pts_sh, shard_of, local_of = shard_dense_problem(
                snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2,
                snap.valid, snap.cam_fixed, snap.points,
                mesh.devices.size, max_obs=max_obs,
            )
            cfg = LMConfig(max_iters=max_iters, solver=self.cfg.ba_solver,
                           pcg_iters=self.cfg.pcg_iters)
            cams, pts_sh_o, info = sharded_dense_ba_solve(
                prob, jnp.asarray(snap.extr), pts_sh, cfg, mesh
            )
            pts_h = np.asarray(jax.device_get(pts_sh_o))[shard_of, local_of]
            # chi2 prune + writeback in the flat layout (same post-solve
            # semantics as the single-device engines)
            prob_flat = BAProblem(
                K4=jnp.asarray(snap.K4),
                cam_idx=jnp.asarray(snap.cam_idx),
                pt_idx=jnp.asarray(snap.pt_idx),
                uv=jnp.asarray(snap.uv),
                sigma2=jnp.asarray(snap.sigma2),
                valid=jnp.asarray(snap.valid),
                cam_fixed=jnp.asarray(snap.cam_fixed),
                pt_fixed=jnp.zeros(snap.points.shape[0], bool),
            )
            pts_dev = jnp.asarray(pts_h)
            new_valid = prune_outliers_cams(prob_flat, cams, pts_dev)
            cams_h, nv_h = jax.device_get((cams, new_valid))
            self.map.writeback(snap, cams_h, pts_h, nv_h)
            return info

    def local_ba(self, center_kf, max_iters=None):
        """Window = center + best covisible; observers of window points enter
        as fixed cameras (reference Optimizer.cpp:500-546)."""
        nbrs, _ = self.map.best_covisible(center_kf, self.cfg.local_window)
        window = [center_kf] + [int(k) for k in nbrs]
        # fixed observers: keyframes observing window points but outside the
        # window (one native pass, Optimizer.cpp:500-546 analogue)
        fixed_extra, _pts = self.map.window_closure(window)
        fixed_extra = set(int(k) for k in fixed_extra)
        fixed_mask = np.zeros(len(window), bool)
        # gauge: fix the earliest keyframe in the window (reference pins
        # frame 0 when present; otherwise fixed observers anchor the gauge)
        if not fixed_extra:
            fixed_mask[int(np.argmin(window))] = True
        snap = self.map.snapshot_problem(
            window, fixed_mask=fixed_mask, min_obs=2,
            extra_fixed_slots=sorted(fixed_extra),
        )
        return self._solve_ba(snap, max_iters or self.cfg.kf_ba_iters)

    def motion_only(self, extr0, pts3d, uv, sigma2, robust=True):
        """Single-frame motion-only BA with padding to max_track_obs."""
        M = self.cfg.max_track_obs
        n = min(len(pts3d), M)
        P = np.zeros((1, M, 3), np.float32)
        U = np.zeros((1, M, 2), np.float32)
        S = np.ones((1, M), np.float32)
        V = np.zeros((1, M), bool)
        P[0, :n] = pts3d[:n]
        U[0, :n] = uv[:n]
        S[0, :n] = sigma2[:n]
        V[0, :n] = True
        cfg = MotionOnlyConfig(
            outer_iters=self.cfg.motion_outer,
            inner_iters=self.cfg.motion_inner,
            robust=robust,
        )
        rt, inl = motion_only_ba(
            jnp.asarray(self.K4),
            jnp.asarray(extr0[None].astype(np.float32)),
            jnp.asarray(P),
            jnp.asarray(U),
            jnp.asarray(S),
            jnp.asarray(V),
            cfg,
        )
        rt_h, inl_h = jax.device_get((rt, inl))
        return rt_h[0].astype(np.float64), inl_h[0, :n]

    # ------------------------------------------------------------------
    # initialization  (reference Initializer.cpp; SURVEY §3.3)
    # ------------------------------------------------------------------

    def _init_gtdepth(self, cur_slot, cur_feats, ref_depth, matches, dists):
        """Bootstrap from the reference frame's (GT) depth map
        (reference Initializer.cpp:36-126)."""
        m = self.map
        ref = self.ref_slot
        rf = self.ref_feats
        depths = sample_depth_bilinear(ref_depth, rf.xy)
        ref_extr = m.kf_pose[ref]  # identity (world = ref camera frame)
        pose_ref = np_se3.rt6_inverse(ref_extr)
        K = self.K4
        kp_point = np.full(len(rf.xy), -1, np.int64)
        for kp in range(len(rf.xy)):
            if not rf.valid[kp] or not np.isfinite(depths[kp]):
                continue
            d = depths[kp]
            xc = np.array(
                [
                    (rf.xy[kp, 0] - K[2]) / K[0] * d,
                    (rf.xy[kp, 1] - K[3]) / K[1] * d,
                    d,
                ]
            )
            xw = np_se3.rt6_apply(pose_ref, xc)
            pt = m.add_point(xw, desc=rf.desc[kp], first_kf=self.kf_counter)
            m.add_observation(pt, ref, kp)
            m.set_point_scale_bounds(pt, np.linalg.norm(xc), rf.octave[kp],
                                     self.cfg.scale_factor, self.cfg.n_levels)
            kp_point[kp] = pt
        ref_img = getattr(self, "_ref_image", None)
        if ref_img is not None:
            created = np.nonzero(kp_point >= 0)[0]
            cols = sample_color_bilinear(ref_img, rf.xy[created])
            m.pt_color[kp_point[created]] = cols

        # associate matches to the new points and track the current frame
        assoc_pts, assoc_uv, assoc_sig, assoc_kp, assoc_pt = [], [], [], [], []
        for kp_ref, kp_cur in enumerate(matches):
            if kp_cur < 0 or kp_point[kp_ref] < 0:
                continue
            pt = kp_point[kp_ref]
            assoc_pts.append(m.pt_pos[pt])
            assoc_uv.append(cur_feats.xy[kp_cur])
            assoc_sig.append(cur_feats.sigma2[kp_cur])
            assoc_kp.append(kp_cur)
            assoc_pt.append(pt)
        if len(assoc_pts) < self.cfg.min_track_points:
            return False

        extr, inl = self.motion_only(
            ref_extr.copy(), np.asarray(assoc_pts), np.asarray(assoc_uv),
            np.asarray(assoc_sig),
        )
        m.set_pose(cur_slot, extr)
        for i, ok in enumerate(inl):
            if ok:
                m.add_observation(int(assoc_pt[i]), cur_slot, int(assoc_kp[i]))

        # triangulate matches whose ref keypoint had no depth
        # (reference Initializer.cpp:119)
        self._triangulate_pairs(ref, cur_slot, rf, cur_feats, matches,
                                exclude_with_points=True)

        m.set_keyframe(ref)
        m.set_keyframe(cur_slot)
        self.kf_counter += 2
        m.refresh_frame_points(cur_slot)
        m.update_covisibility(cur_slot, self.cfg.covis_threshold)
        m.update_covisibility(ref, self.cfg.covis_threshold)
        return True

    def _init_standard(self, cur_slot, cur_feats, matches, dists):
        """Two-view E/H bootstrap (reference Initializer.cpp:128-186)."""
        m = self.map
        ref = self.ref_slot
        rf = self.ref_feats
        pair_ref = np.nonzero(matches >= 0)[0]
        pair_cur = matches[pair_ref]
        uv1 = rf.xy[pair_ref]
        uv2 = cur_feats.xy[pair_cur]
        n = len(pair_ref)
        if n < self.cfg.min_init_matches:
            return False
        p1, p2, pv = _pad_pairs_pow2(uv1, uv2)
        res = jax.device_get(recover_pose_two_view(
            self._next_key(),
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(pv),
            jnp.asarray(self.K4), n_hyp=256,
        ))
        # reference acceptance (>100 E inliers / non-empty H decomposition,
        # SfMHelper.cpp:653-659) plus a relative-support guard for small n
        if not bool(res.ok) or int(res.n_inliers) < max(50, int(0.3 * n)):
            return False
        rel = np.asarray(res.rt6, np.float64)
        m.set_pose(cur_slot, rel)  # ref is identity; extr_cur = rel

        # triangulate inlier matches (no baseline check: Initializer.cpp:174)
        # reuse the padded pair arrays; mask = RANSAC inliers among real pairs
        inliers = np.asarray(res.inliers)[: len(p1)]
        sel = inliers & pv
        cap = len(p1)
        s1 = np.ones(cap, np.float32)
        s2 = np.ones(cap, np.float32)
        s1[:n] = rf.sigma2[pair_ref]
        s2[:n] = cur_feats.sigma2[pair_cur]
        pts, ok = _tri_gated_jit(
            jnp.asarray(self.K4),
            jnp.asarray(m.kf_pose[ref].astype(np.float32)),
            jnp.asarray(rel.astype(np.float32)),
            jnp.asarray(p1), jnp.asarray(p2),
            jnp.asarray(s1),
            jnp.asarray(s2),
            jnp.asarray(sel),
        )
        pts, ok = jax.device_get((pts, ok))
        pts, ok = pts[:n], ok[:n]
        cur_img = getattr(self, "_cur_image", None)
        cols = (
            sample_color_bilinear(cur_img, cur_feats.xy[pair_cur])
            if cur_img is not None
            else None
        )
        n_created = 0
        for i in np.nonzero(ok)[0]:
            pt = m.add_point(pts[i], desc=cur_feats.desc[pair_cur[i]],
                             first_kf=self.kf_counter)
            m.add_observation(pt, ref, int(pair_ref[i]))
            m.add_observation(pt, cur_slot, int(pair_cur[i]))
            if cols is not None:
                m.pt_color[pt] = cols[i]
            n_created += 1
        if n_created < 50:
            return False

        m.set_keyframe(ref)
        m.set_keyframe(cur_slot)
        self.kf_counter += 2
        m.refresh_frame_points(cur_slot)
        m.update_covisibility(cur_slot, self.cfg.covis_threshold)
        m.update_covisibility(ref, self.cfg.covis_threshold)
        # full BA over the two views (Initializer.cpp:182-183); two rounds with
        # chi2 pruning between them so a noisy H/E decomposition seed converges
        self.global_ba(max(self.cfg.kf_ba_iters, 15))
        self.global_ba(max(self.cfg.kf_ba_iters, 15))
        return True

    # ------------------------------------------------------------------
    # triangulation of new landmarks at keyframes
    # ------------------------------------------------------------------

    def _tri_precondition_ok(self, slot_a, slot_b):
        """Baseline / median-scene-depth >= 0.01 precondition (reference
        SfMHelper.cpp:763-771) — tiny-baseline pairs triangulate garbage."""
        m = self.map
        tracked = m.kp_pt[slot_b, : m.kf_nkp[slot_b]]
        tracked = tracked[tracked >= 0]
        if len(tracked) < 5:
            return True
        extr_b = m.kf_pose[slot_b]
        R_b = np_se3.aa_to_R(extr_b[:3])
        z = m.pt_pos[tracked].astype(np.float64) @ R_b[2] + extr_b[5]
        med_depth = float(np.median(z[z > 0])) if (z > 0).any() else np.inf
        baseline = np.linalg.norm(
            np_se3.rt6_inverse(m.kf_pose[slot_a])[3:]
            - np_se3.rt6_inverse(extr_b)[3:]
        )
        return not (np.isfinite(med_depth)
                    and baseline / max(med_depth, 1e-9) < 0.01)

    def _create_triangulated(self, slot_a, slot_b, fa, fb, pair_a, pair_b,
                             pts, ok, image=None, image_side="b",
                             recheck=False):
        """Insert accepted triangulations as landmarks (+obs, scale bounds,
        reference color).  recheck: skip pairs whose keypoints gained a
        landmark since the candidate set was collected (batched paths)."""
        m = self.map
        center_b = np_se3.rt6_inverse(m.kf_pose[slot_b])[3:]
        colors = None
        if image is not None:
            kp_xy = fa.xy[pair_a] if image_side == "a" else fb.xy[pair_b]
            colors = sample_color_bilinear(image, kp_xy)
        n = 0
        for i in np.nonzero(ok)[0]:
            if recheck and (m.kp_pt[slot_a, pair_a[i]] >= 0
                            or m.kp_pt[slot_b, pair_b[i]] >= 0):
                continue
            pt = m.add_point(pts[i], desc=fb.desc[pair_b[i]], first_kf=self.kf_counter)
            if m.add_observation(pt, slot_a, int(pair_a[i])) != 1:
                m.erase_point(pt)
                continue
            if m.add_observation(pt, slot_b, int(pair_b[i])) != 1:
                m.erase_point(pt)
                continue
            m.set_point_scale_bounds(
                pt, np.linalg.norm(pts[i] - center_b), fb.octave[pair_b[i]],
                self.cfg.scale_factor, self.cfg.n_levels,
            )
            if colors is not None:
                m.pt_color[pt] = colors[i]
            n += 1
        return n

    def _triangulate_pairs(self, slot_a, slot_b, fa, fb, matches,
                           exclude_with_points=True, image=None,
                           image_side="b"):
        """Triangulate matched keypoint pairs that lack landmarks
        (reference BundleAdjustment.cpp:166-185 -> SfMHelper.cpp:759-878)."""
        m = self.map
        pair_a = np.nonzero(matches >= 0)[0]
        pair_b = matches[pair_a]
        if exclude_with_points:
            free = (m.kp_pt[slot_a, pair_a] < 0) & (m.kp_pt[slot_b, pair_b] < 0)
            pair_a, pair_b = pair_a[free], pair_b[free]
        if len(pair_a) == 0:
            return 0
        if not self._tri_precondition_ok(slot_a, slot_b):
            return 0
        # pad the pair count to a power-of-two bucket: raw lengths would jit
        # a fresh triangulation per distinct match count (one compile per
        # neighbor per keyframe)
        n_real = len(pair_a)
        # min bucket 128: fewer distinct compiles; padding waste at this
        # size is microseconds of device time
        cap = _pow2(n_real, 128)
        xa = np.zeros((cap, 2), np.float32)
        xb = np.zeros((cap, 2), np.float32)
        sa = np.ones(cap, np.float32)
        sb = np.ones(cap, np.float32)
        xa[:n_real] = fa.xy[pair_a]
        xb[:n_real] = fb.xy[pair_b]
        sa[:n_real] = fa.sigma2[pair_a]
        sb[:n_real] = fb.sigma2[pair_b]
        pts, ok = _tri_gated_jit(
            jnp.asarray(self.K4),
            jnp.asarray(m.kf_pose[slot_a].astype(np.float32)),
            jnp.asarray(m.kf_pose[slot_b].astype(np.float32)),
            jnp.asarray(xa),
            jnp.asarray(xb),
            jnp.asarray(sa),
            jnp.asarray(sb),
            jnp.asarray(np.arange(cap) < n_real),
        )
        pts, ok = jax.device_get((pts, ok))
        pts, ok = pts[:n_real], ok[:n_real]
        return self._create_triangulated(
            slot_a, slot_b, fa, fb, pair_a, pair_b, pts, ok,
            image=image, image_side=image_side,
        )

    def _triangulate_neighbors(self, kf, feats, jobs, image=None):
        """Batched neighborhood triangulation: ONE vmapped dispatch over all
        neighbors' new-pair sets instead of one dispatch per neighbor.

        jobs: list of (nb_slot, pair_kf, pair_nb, nb_feats).  Landmark
        creation runs afterwards in neighbor order with a staleness recheck,
        matching the inline-per-neighbor semantics.
        """
        m = self.map
        jobs = [j for j in jobs
                if len(j[1]) and self._tri_precondition_ok(kf, j[0])]
        if not jobs:
            return 0
        P = _pow2(max(len(j[1]) for j in jobs), 128)
        NB = _pow2(len(jobs), 4)
        extr_b = np.zeros((NB, 6), np.float32)
        extr_b[:, :] = m.kf_pose[kf]  # dummy rows: degenerate, masked off
        xa = np.zeros((NB, P, 2), np.float32)
        xb = np.zeros((NB, P, 2), np.float32)
        sa = np.ones((NB, P), np.float32)
        sb = np.ones((NB, P), np.float32)
        vd = np.zeros((NB, P), bool)
        for bi, (nb, pa, pb, nf) in enumerate(jobs):
            k = len(pa)
            extr_b[bi] = m.kf_pose[nb]
            xa[bi, :k] = feats.xy[pa]
            xb[bi, :k] = nf.xy[pb]
            sa[bi, :k] = feats.sigma2[pa]
            sb[bi, :k] = nf.sigma2[pb]
            vd[bi, :k] = True
        pts, ok = _tri_batch_jit(
            jnp.asarray(self.K4),
            jnp.asarray(m.kf_pose[kf].astype(np.float32)),
            jnp.asarray(extr_b), jnp.asarray(xa), jnp.asarray(xb),
            jnp.asarray(sa), jnp.asarray(sb), jnp.asarray(vd),
        )
        pts, ok = jax.device_get((pts, ok))
        n = 0
        for bi, (nb, pa, pb, nf) in enumerate(jobs):
            k = len(pa)
            n += self._create_triangulated(
                kf, nb, feats, nf, pa, pb, pts[bi, :k], ok[bi, :k],
                image=image, image_side="a", recheck=True,
            )
            # pairs whose kf keypoint gained a landmark from an EARLIER
            # neighbor's job: the inline-per-neighbor code would have taken
            # the cur_only transfer branch for them — do the same here so
            # cross-neighbor observations aren't lost to the recheck
            pt_now = m.kp_pt[kf, pa]
            stale = np.nonzero((pt_now >= 0) & (m.kp_pt[nb, pb] < 0))[0]
            if len(stale):
                gate = self._transfer_gate(pt_now[stale], nb, pb[stale])
                for i in stale[gate]:
                    m.add_observation(int(pt_now[i]), nb, int(pb[i]))
        return n

    def _seed_depth_landmarks(self, slot, feats: FrameFeatures, depth):
        """RGB-D landmark seeding: backproject the keyframe's landmark-free
        keypoints through its depth map into new map points.

        The reference does exactly this once, for the bootstrap reference
        frame (`ba_project/src/ba/Initializer.cpp:36-126`: subpixel depth
        sample, K^-1 deprojection, MapPoint per keypoint).  Extending it to
        every keyframe — standard RGB-D SLAM practice — is how the pipeline
        builds ~10k-landmark maps.  Seeds start
        with one observation; they join BA once a later keyframe's
        neighborhood search transfers a second, gated observation onto them.
        """
        m = self.map
        M = len(feats.xy)
        free = (m.kp_pt[slot, :M] < 0) & feats.valid[:M]
        idx = np.nonzero(free)[0]
        if len(idx) == 0:
            return 0
        d = sample_depth_bilinear(depth, feats.xy[idx])
        ok = np.isfinite(d) & (d > 0)
        idx, d = idx[ok], d[ok]
        if len(idx) > self.cfg.depth_landmarks_max:
            # keep the finest-octave (lowest sigma) keypoints: their depth
            # samples and descriptors are the most localized
            order = np.argsort(feats.sigma2[idx], kind="stable")
            order = np.sort(order[: self.cfg.depth_landmarks_max])
            idx, d = idx[order], d[order]
        extr = m.kf_pose[slot]
        pose = np_se3.rt6_inverse(extr)
        K = self.K4
        xc = np.stack([
            (feats.xy[idx, 0] - K[2]) / K[0] * d,
            (feats.xy[idx, 1] - K[3]) / K[1] * d,
            d,
        ], -1)
        R = np_se3.aa_to_R(pose[:3])
        xw = xc @ R.T + pose[3:]
        img = getattr(self, "_cur_image", None)
        cols = sample_color_bilinear(img, feats.xy[idx]) if img is not None else None
        dist = np.linalg.norm(xc, axis=1)
        n = 0
        for i, kp in enumerate(idx):
            # first_kf=-1: exempt from the recent-point culling window — a
            # depth-seeded landmark carries direct metric evidence (unlike a
            # speculative two-view triangulation) and legitimately waits
            # several keyframes for its second, gated observation
            pt = m.add_point(xw[i], desc=feats.desc[kp], first_kf=-1)
            if m.add_observation(pt, slot, int(kp)) != 1:
                m.erase_point(pt)
                continue
            m.set_point_scale_bounds(pt, float(dist[i]), feats.octave[kp],
                                     self.cfg.scale_factor, self.cfg.n_levels)
            if cols is not None:
                m.pt_color[pt] = cols[i]
            self._pending_seeds.append(int(pt))
            n += 1
        return n

    def _densify_pending_seeds(self, slot, feats: FrameFeatures):
        """Projection-guided second observations for depth-seeded landmarks.

        Descriptor-only neighborhood matching rarely re-finds the weak
        keypoints depth seeding targets (they already failed frame-to-frame
        matching once), so 1-obs seeds would stay out of BA forever.
        Instead, project every pending seed into the NEW keyframe and search
        its landmark-free keypoints within a pixel window (ORB-SLAM2's
        Fuse()-style guided search); acceptance runs the same
        chi2/scale/view-dir cascade as every other observation transfer
        (`_transfer_gate`).  Seeds that reach 2 observations leave the
        pending set and participate in BA from the next solve on.
        """
        m = self.map
        cfg = self.cfg
        if not self._pending_seeds:
            return 0
        pend = np.asarray(self._pending_seeds, np.int64)
        # drop culled/fused seeds and ones that already reached >=2 obs
        alive = m.pt_active[pend] == 1
        pend = pend[alive]
        if len(pend):
            pend = pend[m.point_obs_counts(pend) < 2]
        if len(pend) == 0:
            self._pending_seeds = []
            return 0
        M = len(feats.xy)
        free_kp = np.nonzero((m.kp_pt[slot, :M] < 0) & feats.valid[:M])[0]
        n_added = 0
        still = []
        if len(free_kp):
            kp_xy = feats.xy[free_kp]
            K = self.K4
            extr = m.kf_pose[slot]
            R = np_se3.aa_to_R(extr[:3])
            for s in range(0, len(pend), 2048):  # chunk the [P, F] window
                blk = pend[s:s + 2048]
                X = m.pt_pos[blk].astype(np.float64)
                xc = X @ R.T + extr[3:]
                z = xc[:, 2]
                zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
                u = K[0] * xc[:, 0] / zs + K[2]
                v = K[1] * xc[:, 1] / zs + K[3]
                vis = (z > 0.05) & (u >= 0) & (u < self.width) & \
                      (v >= 0) & (v < self.height)
                sv = np.nonzero(vis)[0]
                if len(sv) == 0:
                    continue
                uv_pred = np.stack([u[sv], v[sv]], -1)
                d2 = ((uv_pred[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
                j = np.argmin(d2, axis=1)
                near = d2[np.arange(len(sv)), j] < cfg.track_window_px ** 2
                sv, j = sv[near], j[near]
                if len(sv) == 0:
                    continue
                kp = free_kp[j]
                dd = np.bitwise_count(np.bitwise_xor(
                    m.pt_desc[blk[sv]].astype(np.uint32),
                    feats.desc[kp].astype(np.uint32),
                )).sum(-1)
                okd = dd < cfg.search_max_dist
                sv, kp = sv[okd], kp[okd]
                if len(sv) == 0:
                    continue
                gate = self._transfer_gate(blk[sv], slot, kp)
                sv, kp = sv[gate], kp[gate]
                # several seeds can pick the same free keypoint: keep the
                # first per keypoint (add_observation rejects the rest)
                _, first = np.unique(kp, return_index=True)
                for i in first:
                    if m.add_observation(int(blk[sv[i]]), slot,
                                         int(kp[i])) == 1:
                        n_added += 1
        # retain seeds that are still 1-obs for future keyframes
        alive = m.pt_active[pend] == 1
        pend = pend[alive]
        if len(pend):
            pend = pend[m.point_obs_counts(pend) < 2]
        self._pending_seeds = [int(p) for p in pend]
        return n_added

    # ------------------------------------------------------------------
    # neighborhood search & fusion  (reference SfMHelper.cpp:203-496)
    # ------------------------------------------------------------------

    def _transfer_gate(self, pt_ids, kf, kp_ids):
        """Acceptance gates for transferring a landmark observation into
        keyframe `kf` at keypoints `kp_ids` — the reference's searchInNeighbors
        cascade (SfMHelper.cpp:203-496): cheirality, chi2 < 5.991 with the
        keypoint's octave sigma, distance inside the scale envelope
        [0.8 dmin, 1.2 dmax], and viewing-angle dot > 0.5."""
        m = self.map
        if len(pt_ids) == 0:
            return np.zeros(0, bool)
        X = m.pt_pos[pt_ids].astype(np.float64)
        extr = m.kf_pose[kf]
        R = np_se3.aa_to_R(extr[:3])
        center = np_se3.rt6_inverse(extr)[3:]
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        uv_kp = m.kp_xy[kf, kp_ids]
        sig2 = m.kp_sigma2[kf, kp_ids]
        chi2 = ((u - uv_kp[:, 0]) ** 2 + (v - uv_kp[:, 1]) ** 2) / np.maximum(sig2, 1e-12)
        ok = (z > 0) & (chi2 < 5.991)

        dist = np.linalg.norm(X - center, axis=1)
        dmin = m.pt_dmin[pt_ids]
        dmax = m.pt_dmax[pt_ids]
        has_env = np.isfinite(dmax) & (dmax > 0)
        ok &= ~has_env | ((dist > 0.8 * dmin) & (dist < 1.2 * dmax))

        dirs = m.point_view_dirs(pt_ids)
        cur = X - center
        n = np.linalg.norm(cur, axis=1)
        cur = cur / np.maximum(n[:, None], 1e-12)
        has_dir = np.linalg.norm(dirs, axis=1) > 0.5
        ok &= ~has_dir | (np.sum(dirs * cur, axis=1) > 0.5)
        return ok

    def search_in_neighbors(self, kf, feats: FrameFeatures):
        with self.timers.phase("search_in_neighbors"):
            return self._search_in_neighbors(kf, feats)

    def _search_in_neighbors(self, kf, feats: FrameFeatures):
        """Re-match the new keyframe against its covisibility neighborhood:
        transfer observations, fuse duplicate landmarks, triangulate new ones.

        Neighborhood = 20 best covisible + 5 best of each of those
        (SfMHelper.cpp:203-240).  Gates: descriptor distance (search_max_dist)
        and the chi2 reprojection acceptance inside triangulate/transfer.
        """
        m = self.map
        n1, _ = m.best_covisible(kf, self.cfg.neighbor_search_n1)
        neighborhood = []
        seen = {kf}
        for nb in n1:
            if int(nb) not in seen:
                neighborhood.append(int(nb))
                seen.add(int(nb))
            n2, _ = m.best_covisible(int(nb), self.cfg.neighbor_search_n2)
            for nb2 in n2:
                if int(nb2) not in seen:
                    neighborhood.append(int(nb2))
                    seen.add(int(nb2))

        if not neighborhood:
            return {"fused": 0, "transferred": 0, "triangulated": 0}

        # ONE batched matching dispatch over all neighbors (padded to a
        # power-of-two neighbor count for stable jit shapes)
        from bundleadjustment_tpu.ops.matching import match_descriptors_batch

        n_nb = len(neighborhood)
        nb_bucket = _pow2(n_nb, 8)
        descs_b = np.zeros((nb_bucket, m.max_kp, m.desc_words), np.uint32)
        valids_b = np.zeros((nb_bucket, m.max_kp), bool)
        for bi, nb in enumerate(neighborhood):
            descs_b[bi] = m.kp_desc[nb]
            valids_b[bi, : m.kf_nkp[nb]] = True
        with self.timers.phase("match"):
            idx_all, dist_all = match_descriptors_batch(
                jnp.asarray(feats.desc),
                jnp.asarray(descs_b),
                valid_a=jnp.asarray(feats.valid),
                valids_b=jnp.asarray(valids_b),
                metric="hamming",
                ratio=self.cfg.match_ratio,
                max_dist=self.cfg.search_max_dist,
            )
            idx_all = np.asarray(idx_all)

        n_fused = n_transfer = n_tri = 0
        tri_jobs = []
        for bi, nb in enumerate(neighborhood):
            nf = FrameFeatures(
                xy=m.kp_xy[nb, : m.kf_nkp[nb]],
                octave=m.kp_octave[nb, : m.kf_nkp[nb]],
                sigma2=m.kp_sigma2[nb, : m.kf_nkp[nb]],
                desc=m.kp_desc[nb, : m.kf_nkp[nb]],
                valid=np.ones(m.kf_nkp[nb], bool),
            )
            idx = idx_all[bi]
            kp_cur = np.nonzero(idx >= 0)[0]
            kp_nb = idx[kp_cur]
            pt_cur = m.kp_pt[kf, kp_cur]
            pt_nb = m.kp_pt[nb, kp_nb]
            # fuse: both have distinct landmarks -> keep the better-observed.
            # A descriptor match alone is NOT enough: on repetitive texture
            # two distinct 3-D points can look alike, and an ungated fusion
            # writes a wrong landmark that BA then fits by dragging the
            # whole window (root cause of the round-3 config-2 0.47 m ATE).
            # Gate like the reference's searchInNeighbors cascade
            # (SfMHelper.cpp:203-496): each landmark must reproject onto the
            # OTHER frame's matched keypoint within chi2/scale/view-dir.
            both = np.nonzero(
                (pt_cur >= 0) & (pt_nb >= 0) & (pt_cur != pt_nb))[0]
            if len(both):
                g_nb_in_kf = self._transfer_gate(
                    pt_nb[both], kf, kp_cur[both])
                g_cur_in_nb = self._transfer_gate(
                    pt_cur[both], nb, kp_nb[both])
                both = both[g_nb_in_kf & g_cur_in_nb]
            for i in both:
                a, b = int(pt_cur[i]), int(pt_nb[i])
                if m.point_obs_count(a) >= m.point_obs_count(b):
                    m.fuse_points(a, b)
                else:
                    m.fuse_points(b, a)
                n_fused += 1
            # transfer: neighbor has a landmark, current kp free (gated)
            nb_only = np.nonzero((pt_cur < 0) & (pt_nb >= 0))[0]
            gate = self._transfer_gate(pt_nb[nb_only], kf, kp_cur[nb_only])
            for i in nb_only[gate]:
                if m.add_observation(int(pt_nb[i]), kf, int(kp_cur[i])) == 1:
                    n_transfer += 1
            # transfer the other way (gated against the neighbor frame)
            cur_only = np.nonzero((pt_cur >= 0) & (pt_nb < 0))[0]
            gate2 = self._transfer_gate(pt_cur[cur_only], nb, kp_nb[cur_only])
            for i in cur_only[gate2]:
                if m.add_observation(int(pt_cur[i]), nb, int(kp_nb[i])) == 1:
                    n_transfer += 1
            # collect brand-new pairs; triangulated in ONE batched dispatch
            # after the loop (staleness handled by _create_triangulated)
            none_have = (pt_cur < 0) & (pt_nb < 0)
            if none_have.any():
                tri_jobs.append(
                    (nb, kp_cur[none_have], kp_nb[none_have], nf)
                )
        n_tri = self._triangulate_neighbors(
            kf, feats, tri_jobs, image=getattr(self, "_cur_image", None)
        )
        return {"fused": n_fused, "transferred": n_transfer, "triangulated": n_tri}

    # ------------------------------------------------------------------
    # per-frame tracking
    # ------------------------------------------------------------------

    def _track_local_map(self, feats, extr, assoc_pt, assoc_kp):
        """Guided matching against the projected map (track-local-map).

        Projects active landmarks into the current pose estimate, matches
        their representative descriptors to still-unassociated keypoints
        within a pixel window, and returns the enlarged association set.
        """
        m = self.map
        cfg = self.cfg
        cand = m.active_points()
        if len(cand) == 0:
            return assoc_pt, assoc_kp
        X = m.pt_pos[cand].astype(np.float64)
        R = np_se3.aa_to_R(extr[:3])
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        margin = cfg.track_window_px
        vis = (z > 0.05) & (u >= -margin) & (u < self.width + margin) & \
              (v >= -margin) & (v < self.height + margin)
        vis &= ~np.isin(cand, assoc_pt)
        cand_vis = cand[vis]
        uv_vis = np.stack([u[vis], v[vis]], -1)
        # same BA-constrainability gate as the primary association path
        well = np.array(
            [m.point_obs_count(int(p)) >= 2 for p in cand_vis], bool
        ) if len(cand_vis) else np.zeros(0, bool)
        cand = cand_vis[well]
        if len(cand) == 0:
            return assoc_pt, assoc_kp
        uv_pred = uv_vis[well]

        kp_free = feats.valid.copy()
        kp_free[assoc_kp] = False
        # pad candidates to a power-of-two bucket for stable jit shapes
        n_cand = len(cand)
        nb = _pow2(n_cand, 64)
        desc_pad = np.zeros((nb, m.desc_words), np.uint32)
        desc_pad[:n_cand] = m.pt_desc[cand]
        valid_a = np.zeros(nb, bool)
        valid_a[:n_cand] = True
        idx, dist = match_descriptors_jit(
            jnp.asarray(desc_pad),
            jnp.asarray(feats.desc),
            valid_a=jnp.asarray(valid_a),
            valid_b=jnp.asarray(kp_free),
            metric="hamming",
            ratio=0.9,
            max_dist=cfg.search_max_dist,
        )
        idx = np.asarray(idx)[:n_cand]
        hit = idx >= 0
        if not hit.any():
            return assoc_pt, assoc_kp
        # window gate: predicted projection near the matched keypoint
        d_px = np.linalg.norm(feats.xy[idx[hit]] - uv_pred[hit], axis=1)
        keep = d_px < cfg.track_window_px
        new_pt = cand[hit][keep]
        new_kp = idx[hit][keep]
        return (
            np.concatenate([assoc_pt, new_pt.astype(np.int64)]),
            np.concatenate([assoc_kp, new_kp.astype(np.int64)]),
        )

    def _reproj_gate(self, extr, assoc_pt, assoc_kp, feats):
        """Cheirality + chi2 < 5.991 acceptance of 2D-3D associations against
        a pose estimate (the reference's pruneCorrespondences criterion,
        Optimizer.cpp:6-79, applied before observation writes)."""
        if len(assoc_pt) == 0:
            return np.zeros(0, bool)
        X = self.map.pt_pos[assoc_pt].astype(np.float64)
        R = np_se3.aa_to_R(extr[:3])
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        uv = feats.xy[assoc_kp]
        sig2 = np.maximum(feats.sigma2[assoc_kp], 1e-12)
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sig2
        return (z > 0) & (chi2 < 5.991)

    def _predict_extr(self):
        """Constant-velocity model (reference SfMHelper.cpp:894-972)."""
        if self.prev_extr is None:
            return self.last_extr.copy()
        vel = np_se3.rt6_compose(self.last_extr, np_se3.rt6_inverse(self.prev_extr))
        return np_se3.rt6_compose(vel, self.last_extr)

    def _estimate_pose(self, cur_feats, assoc_pt, assoc_kp, pred_extr, matches):
        """Dispatch on cfg.estimation (reference SfMHelper.cpp:124-153)."""
        cfg = self.cfg
        m = self.map
        if cfg.estimation in ("ba", "pnp"):
            if len(assoc_pt) < cfg.min_track_points:
                return pred_extr, np.zeros(len(assoc_pt), bool)
            pts3d = m.pt_pos[assoc_pt]
            uv = cur_feats.xy[assoc_kp]
            sig = cur_feats.sigma2[assoc_kp]
            extr, inl = self.motion_only(
                pred_extr, pts3d, uv, sig, robust=(cfg.estimation == "ba")
            )
            if cfg.estimation == "pnp":
                # translation jump guard (SfMHelper.cpp:76-80)
                if np.linalg.norm(extr[3:] - pred_extr[3:]) >= cfg.pnp_translation_guard:
                    return pred_extr, np.zeros(len(assoc_pt), bool)
            return extr, inl
        elif cfg.estimation == "essential_or_homography":
            lf = self.last_feats
            pair_last = np.nonzero(matches >= 0)[0]
            pair_cur = matches[pair_last]
            n = len(pair_last)
            if n < 30:
                return pred_extr, np.zeros(len(assoc_pt), bool)
            p1, p2, pv = _pad_pairs_pow2(lf.xy[pair_last],
                                         cur_feats.xy[pair_cur])
            res = jax.device_get(recover_pose_two_view(
                self._next_key(),
                jnp.asarray(p1),
                jnp.asarray(p2),
                jnp.asarray(pv),
                jnp.asarray(self.K4),
                n_hyp=256,
            ))
            if not bool(res.ok):
                # recovery failed (E-path <= 100 inliers / empty H decomposition):
                # keep the constant-velocity prediction, write no observations
                # (reference SfMHelper.cpp:144-146, 653-659)
                return pred_extr, np.zeros(len(assoc_pt), bool)
            rel = np.asarray(res.rt6, np.float64)
            # scale the unit translation with the constant-velocity prior
            # (monocular 2-view scale is unobservable)
            pred_rel = np_se3.rt6_compose(pred_extr, np_se3.rt6_inverse(self.last_extr))
            scale = np.linalg.norm(pred_rel[3:])
            rel[3:] *= scale if scale > 1e-9 else 1.0
            extr = np_se3.rt6_compose(rel, self.last_extr)
            # gate observation writes with the chi2 reprojection test against
            # the recovered pose — the reference prunes every association via
            # the optimizer's chi2 pass; ungated writes poison the map
            inl = self._reproj_gate(extr, assoc_pt, assoc_kp, cur_feats)
            return extr, inl
        raise ValueError(f"unknown estimation {cfg.estimation!r}")

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def process_frame(self, frame, precomputed=None, prefeats=None):
        """Process one FrameData.  Returns a status string.

        `precomputed` (from `_track_batch`) carries this frame's device
        results — (feats, matches, dists, assoc_ok, rt6, inliers) — so the
        host bookkeeping replays without a per-frame dispatch.

        `prefeats` (from `predetect_features`) carries this frame's features
        from the data-parallel batched frontend; the frame's tracking then
        only matches + estimates (split path)."""
        cfg = self.cfg
        m = self.map
        # fused detect+match against the frame we will match anyway (last
        # frame when tracking, reference frame when awaiting init): one
        # device dispatch instead of two
        prev = self.last_feats if self.initialized else self.ref_feats
        fused_rt = fused_inl = assoc_ok = pred_extr = tlm_pre = None
        if precomputed is not None:
            pred_extr = self._predict_extr()
            (feats, matches, dists, assoc_ok, fused_rt, fused_inl,
             tlm_pre) = precomputed
        elif prefeats is not None:
            feats = prefeats
            if prev is not None:
                with self.timers.phase("frontend"):
                    if prev.desc_dev is None:
                        prev.desc_dev = jnp.asarray(prev.desc)
                        prev.valid_dev = jnp.asarray(prev.valid)
                    if feats.desc_dev is None:
                        feats.desc_dev = jnp.asarray(feats.desc)
                        feats.valid_dev = jnp.asarray(feats.valid)
                    idx, dist = _match_only_jit(
                        feats.desc_dev, feats.valid_dev,
                        prev.desc_dev, prev.valid_dev,
                        ratio=cfg.match_ratio,
                    )
                    matches, dists = jax.device_get((idx, dist))
            else:
                matches = dists = None
        elif (self.initialized and cfg.fused_tracking
                and cfg.estimation in ("ba", "pnp")
                and getattr(self, "_prev_track", None) is not None):
            # fully-fused tracked frame: detect + match + associate +
            # motion-only BA in one dispatch
            pred_extr = self._predict_extr()
            feats, matches, dists, assoc_ok, fused_rt, fused_inl = (
                self._track_fused(frame.gray, prev, pred_extr)
            )
        elif prev is not None:
            feats, matches, dists = self.detect_and_match(frame.gray, prev)
        else:
            feats = self.detect(frame.gray)
            matches = dists = None
        self._cur_image = frame.rgb if frame.rgb is not None else frame.gray
        slot = m.add_frame(
            frame.timestamp,
            np.zeros(6),
            feats.xy,
            feats.octave,
            feats.sigma2,
            feats.desc,
            gt_pose44=frame.gt_cam_to_world,
        )
        self.stats["frames"] += 1

        if not self.initialized:
            if self.ref_slot is None:
                self.ref_slot = slot
                self.ref_feats = feats
                self._ref_depth = frame.depth
                self._ref_image = self._cur_image
                return "ref"
            n_matches = int((matches >= 0).sum())
            if n_matches <= cfg.min_init_matches:
                # too few matches: keep the reference, skip this frame
                # (reference only resets after a FAILED initialization
                # attempt, BundleAdjustment.cpp:96-109)
                m.erase_frame(slot)
                return "await-init"
            if cfg.init_type == "gtdepth":
                ok = self._init_gtdepth(slot, feats, self._ref_depth, matches, dists)
            else:
                ok = self._init_standard(slot, feats, matches, dists)
            if ok:
                self.initialized = True
                self._last_kf_slot = slot
                self.last_slot = slot
                self.last_feats = feats
                self._capture_track_state(slot, feats)
                self.last_extr = m.kf_pose[slot].copy()
                self.prev_extr = m.kf_pose[self.ref_slot].copy()
                self.trajectory.append(
                    TrackRecord(m.kf_timestamp[self.ref_slot], self.ref_slot,
                                m.kf_pose[self.ref_slot].copy(), True)
                )
                self.trajectory.append(
                    TrackRecord(frame.timestamp, slot, self.last_extr.copy(), True)
                )
                self.stats["keyframes"] += 2
                return "initialized"
            # failed bootstrap: reset with current as reference
            # (reference BundleAdjustment.cpp:104-109)
            m.erase_frame(self.ref_slot)
            # drop landmarks orphaned by the failed attempt (gtdepth creates
            # points before it can fail; standard may create some before the
            # created-count check)
            for pt in m.active_points():
                if m.point_obs_count(int(pt)) == 0:
                    m.erase_point(int(pt))
            self.ref_slot = slot
            self.ref_feats = feats
            self._ref_depth = frame.depth
            self._ref_image = self._cur_image
            return "ref-reset"

        # ---- tracking path ----
        n_matches = max(int((matches >= 0).sum()), 1)

        # associate current keypoints to landmarks through last-frame matches
        # (reference BundleAdjustment.cpp:129-146, desc gate)
        pair_last = np.nonzero(matches >= 0)[0]
        pair_cur = matches[pair_last]
        lp = m.kp_pt[self.last_slot, pair_last]
        has_pt = (lp >= 0) & (dists[pair_last] < cfg.assoc_max_dist)
        if assoc_ok is not None:
            # fused path: the association (incl. the >=2-observations gate)
            # was evaluated on device from the state captured last frame
            ok_idx = np.nonzero(assoc_ok)[0]
            assoc_pt = m.kp_pt[self.last_slot, ok_idx].astype(np.int64)
            assoc_kp = matches[ok_idx].astype(np.int64)
        else:
            assoc_pt = lp[has_pt].astype(np.int64)
            assoc_kp = pair_cur[has_pt].astype(np.int64)
            # only track against landmarks that bundle adjustment can
            # constrain: 1-observation points (partner frame erased before a
            # second view confirmed them) are never BA-refined and poison
            # motion-only BA
            well_obs = (
                m.point_obs_counts(assoc_pt) >= 2
                if len(assoc_pt) else np.zeros(0, bool)
            )
            assoc_pt = assoc_pt[well_obs]
            assoc_kp = assoc_kp[well_obs]

        # the keyframe/failure ratio is the *association* ratio, computed
        # before pose estimation (reference BundleAdjustment.cpp:129-161)
        assoc_ratio = int(has_pt.sum()) / n_matches
        if assoc_ratio <= cfg.tracking_fail_ratio:
            self.stats["tracking_failures"] += 1
            return "tracking-lost"

        if pred_extr is None:
            pred_extr = self._predict_extr()
        if fused_rt is not None:
            # pose estimate already computed inside the fused dispatch
            if len(assoc_pt) < cfg.min_track_points:
                extr, inl = pred_extr, np.zeros(len(assoc_pt), bool)
            else:
                extr, inl = fused_rt, fused_inl[ok_idx]
                if cfg.estimation == "pnp" and np.linalg.norm(
                        extr[3:] - pred_extr[3:]) >= cfg.pnp_translation_guard:
                    extr, inl = pred_extr, np.zeros(len(assoc_pt), bool)
            if (tlm_pre is not None and tlm_pre["use2"]
                    and len(assoc_pt) >= cfg.min_track_points):
                # the batch scan's in-device local-map second pass won:
                # adopt its enlarged association set and re-solved pose
                hit = np.nonzero(tlm_pre["hit"])[0]
                Mkp = len(feats.desc)
                assoc_pt = np.concatenate(
                    [assoc_pt, tlm_pre["snap_ids"][hit]])
                assoc_kp = np.concatenate(
                    [assoc_kp, tlm_pre["kp"][hit].astype(np.int64)])
                inl = np.concatenate(
                    [tlm_pre["inl2"][:Mkp][ok_idx],
                     tlm_pre["inl2"][Mkp:][hit]])
                extr = tlm_pre["rt2"]
        else:
            extr, inl = self._estimate_pose(
                feats, assoc_pt, assoc_kp, pred_extr, matches
            )

        # second pass: guided matching against the projected local map, then
        # re-estimate (track-local-map; beyond the reference's last-frame-only
        # association — see PipelineConfig.track_local_map).  The batch path
        # already ran this inside the scan (tlm_pre above).
        if (cfg.track_local_map and cfg.estimation in ("ba", "pnp")
                and precomputed is None):
            assoc_pt2, assoc_kp2 = self._track_local_map(feats, extr, assoc_pt, assoc_kp)
            if len(assoc_pt2) > len(assoc_pt):
                extr2, inl2 = self._estimate_pose(
                    feats, assoc_pt2, assoc_kp2, extr, matches
                )
                if inl2.sum() >= inl.sum():
                    extr, inl = extr2, inl2
                    assoc_pt, assoc_kp = assoc_pt2, assoc_kp2

        m.set_pose(slot, extr)

        # write inlier associations into the map
        for i in np.nonzero(inl)[0]:
            m.add_observation(int(assoc_pt[i]), slot, int(assoc_kp[i]))
        # maintain representative descriptors of the landmarks that gained an
        # observation (reference recomputes on every addObservation,
        # MapPoint.cpp:51-61 -> computeDescriptor :202-252)
        m.refresh_point_descriptors(assoc_pt[np.nonzero(inl)[0]])

        inl_idx = np.nonzero(inl)[0]
        # keyframe-relative anchor: the most recent keyframe at this moment
        ref_kf = getattr(self, "_last_kf_slot", None)
        rel = (np_se3.rt6_compose(extr, np_se3.rt6_inverse(m.kf_pose[ref_kf]))
               if ref_kf is not None and m.kf_active[ref_kf] else None)
        self.trajectory.append(
            TrackRecord(
                frame.timestamp, slot, extr.copy(), False,
                ref_kf=ref_kf, rel=rel,
                assoc_pt=assoc_pt[inl_idx].copy(),
                assoc_uv=feats.xy[assoc_kp[inl_idx]].copy(),
                assoc_sig=feats.sigma2[assoc_kp[inl_idx]].copy(),
                # host-only copy: keeping desc_dev refs alive per frame
                # would pin ~150 KB of HBM per tracked frame
                feats=(FrameFeatures(
                    xy=feats.xy, octave=feats.octave, sigma2=feats.sigma2,
                    desc=feats.desc, valid=feats.valid)
                    if cfg.refine_guided else None),
                assoc_kp=(assoc_kp[inl_idx].copy()
                          if cfg.refine_guided else None),
            )
        )

        is_keyframe = assoc_ratio <= cfg.keyframe_ratio
        if cfg.track_local_map and not is_keyframe:
            # guided tracking keeps assoc_ratio high even as the local map
            # decays (the reference's ratio alone starves keyframe
            # creation): also trigger on inlier-count decay vs the last
            # keyframe and on a maximum interval (ORB-SLAM NeedNewKeyFrame
            # analogue; round-5 sweep diagnosis)
            n_inl_now = int(np.sum(inl))
            self._frames_since_kf = getattr(self, "_frames_since_kf", 0) + 1
            ref = getattr(self, "_kf_ref_inliers", None)
            if ref is not None and n_inl_now < cfg.kf_ref_decay * ref:
                is_keyframe = True
            elif self._frames_since_kf >= cfg.kf_max_interval:
                is_keyframe = True
        if is_keyframe:
            m.set_keyframe(slot)
            self.kf_counter += 1
            self.stats["keyframes"] += 1
            self.trajectory[-1].is_keyframe = True
            # reference inlier count for the keyframe-need decay criterion
            self._kf_ref_inliers = max(int(np.sum(inl)),
                                       cfg.min_track_points)
            self._frames_since_kf = 0
            self._last_kf_slot = slot

            m.cull_recent_points(
                self.kf_counter, cfg.cull_point_window, cfg.cull_point_min_obs
            )
            self._triangulate_pairs(self.last_slot, slot, self.last_feats,
                                    feats, matches,
                                    image=self._cur_image, image_side="b")
            m.update_covisibility(slot, cfg.covis_threshold)
            # depth seeding runs BEFORE the neighborhood search so the
            # search's gated transfers cover the new seeds too; pending
            # (1-obs) seeds from earlier keyframes first get their guided
            # projection chance at this frame's free keypoints
            if cfg.depth_landmarks:
                self._densify_pending_seeds(slot, feats)
                if frame.depth is not None:
                    self._seed_depth_landmarks(slot, feats, frame.depth)
            self.search_in_neighbors(slot, feats)
            # one batched descriptor-refresh pass over everything the
            # neighborhood search touched (fuses, transfers, triangulations)
            m.refresh_frame_points(slot)
            m.update_covisibility(slot, cfg.covis_threshold)
            if cfg.local_ba:
                self.local_ba(slot)
            else:
                self.global_ba()
            if cfg.cull_frames:
                m.cull_redundant_keyframes(
                    cfg.cull_kf_redundancy, cfg.cull_kf_min_other
                )

        # bookkeeping: erase the previous frame if it never became a keyframe
        # (reference BundleAdjustment.cpp:215-219)
        if self.last_slot is not None and not m.kf_is_keyframe[self.last_slot]:
            m.erase_frame(self.last_slot)
        self.prev_extr = self.last_extr
        self.last_extr = m.kf_pose[slot].copy()
        self.last_slot = slot
        self.last_feats = feats
        self._capture_track_state(slot, feats)
        return "keyframe" if is_keyframe else "tracked"

    def finalize(self):
        """Final global BA (3 outer rounds) — reference
        BundleAdjustment.cpp:228-233 — plus a non-keyframe trajectory
        refinement pass the reference lacks: every tracked (non-key) frame is
        re-solved by batched motion-only BA against the BA-refined landmarks
        using its stored 2D-3D associations."""
        for _ in range(self.cfg.final_ba_outer):
            self.global_ba(self.cfg.final_ba_iters)
        # two rounds: the second guided re-association projects the map at
        # the ROUND-1-refined poses, catching landmarks the noisy
        # tracking-time pose pushed outside the search window
        self._refine_trajectory()
        if self.cfg.refine_guided:
            self._refine_trajectory()

    def _refine_trajectory(self):
        m = self.map
        # a 2-keyframe (especially planar) map has BA gauge ambiguities that
        # the final solve can wander along; re-tracking non-keyframes against
        # such a map follows the wander.  Only refine against maps with
        # enough keyframes to be well-constrained.
        if len(m.active_keyframes()) < 3:
            return
        recs = [
            r for r in self.trajectory
            if not r.is_keyframe and r.assoc_pt is not None and len(r.assoc_pt) >= self.cfg.min_track_points
        ]
        if not recs:
            return
        n_orig = {}  # id(rec) -> count of ORIGINAL (tracking-time) entries
        if self.cfg.refine_guided:
            # guided re-association against the post-final-BA map: the
            # tracking-time inlier list is sparse (last-frame matches only)
            # and its geometry caps the re-solve accuracy; projecting the
            # refined landmarks into each stored frame recovers the full
            # constraint set (round-3 VERDICT #6)
            for rec in recs:
                if rec.feats is None or rec.assoc_kp is None:
                    continue
                live = m.pt_active[rec.assoc_pt] == 1
                ap = rec.assoc_pt[live].astype(np.int64)
                ak = rec.assoc_kp[live].astype(np.int64)
                ap2, ak2 = self._track_local_map(
                    rec.feats, self._record_extr(rec), ap, ak)
                if len(ap2) > len(ap):
                    # the guided additions sit AFTER the original prefix
                    n_orig[id(rec)] = len(ap)
                    rec.assoc_pt = ap2
                    rec.assoc_kp = ak2
                    rec.assoc_uv = rec.feats.xy[ak2].copy()
                    rec.assoc_sig = rec.feats.sigma2[ak2].copy()
        M = self.cfg.max_track_obs
        B = len(recs)
        P = np.zeros((B, M, 3), np.float32)
        U = np.zeros((B, M, 2), np.float32)
        S = np.ones((B, M), np.float32)
        V = np.zeros((B, M), bool)
        # ORIG marks tracking-time constraints: the guided re-association
        # matches landmarks within a pixel window AT the stored pose with a
        # permissive ratio, so its additions are biased evidence — they
        # strengthen the SOLVE but must not judge the acceptance
        ORIG = np.zeros((B, M), bool)
        E0 = np.zeros((B, 6), np.float32)
        for b, rec in enumerate(recs):
            live = np.nonzero(m.pt_active[rec.assoc_pt] == 1)[0]
            if len(live) > M:
                # the guided re-association can exceed the padded capacity;
                # keep the finest-octave (lowest-sigma) constraints rather
                # than silently truncating to the head (which would bias
                # toward tracking-time associations and compute the inlier
                # ratio over an arbitrary prefix)
                order = np.argsort(rec.assoc_sig[live], kind="stable")
                live = np.sort(live[order[:M]])
            n = len(live)
            ids = rec.assoc_pt[live]
            P[b, :n] = m.pt_pos[ids]
            U[b, :n] = rec.assoc_uv[live]
            S[b, :n] = rec.assoc_sig[live]
            V[b, :n] = True
            ORIG[b, :n] = live < n_orig.get(id(rec), len(rec.assoc_pt))
            E0[b] = self._record_extr(rec)
        # pad batch to a bucket for stable jit shapes
        Bb = 8
        while Bb < B:
            Bb *= 2
        pad = Bb - B
        if pad:
            P = np.concatenate([P, np.zeros((pad, M, 3), np.float32)])
            U = np.concatenate([U, np.zeros((pad, M, 2), np.float32)])
            S = np.concatenate([S, np.ones((pad, M), np.float32)])
            V = np.concatenate([V, np.zeros((pad, M), bool)])
            E0 = np.concatenate([E0, np.zeros((pad, 6), np.float32)])
        cfg = MotionOnlyConfig(
            outer_iters=self.cfg.motion_outer, inner_iters=self.cfg.motion_inner
        )
        rt, inl = motion_only_ba(
            jnp.asarray(self.K4), jnp.asarray(E0), jnp.asarray(P),
            jnp.asarray(U), jnp.asarray(S), jnp.asarray(V), cfg,
        )
        rt = np.asarray(rt, np.float64)
        inl = np.asarray(inl)

        def huber_cost(extr, b):
            R = np_se3.aa_to_R(extr[:3])
            xc = P[b] @ R.T + extr[3:]
            z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
            u = self.K4[0] * xc[:, 0] / z + self.K4[2]
            v = self.K4[1] * xc[:, 1] / z + self.K4[3]
            r2 = ((u - U[b, :, 0]) ** 2 + (v - U[b, :, 1]) ** 2) / np.maximum(S[b], 1e-12)
            d = 2.4477
            nrm = np.sqrt(np.maximum(r2, 1e-20))
            rho = np.where(nrm <= d, 0.5 * r2, d * (nrm - 0.5 * d))
            rho = np.where(xc[:, 2] > 1e-6, rho, 1e4)
            return float(np.sum(np.where(V[b], rho, 0.0)))

        def chi2_inlier_count(extr, b, mask=None):
            """chi2 < 5.991 inliers of record b's constraints at `extr` —
            the same criterion motion_only_ba prunes with."""
            R = np_se3.aa_to_R(extr[:3])
            xc = P[b] @ R.T + extr[3:]
            z = xc[:, 2]
            zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
            u = self.K4[0] * xc[:, 0] / zs + self.K4[2]
            v = self.K4[1] * xc[:, 1] / zs + self.K4[3]
            chi2 = ((u - U[b, :, 0]) ** 2 + (v - U[b, :, 1]) ** 2) \
                / np.maximum(S[b], 1e-12)
            sel = V[b] if mask is None else (V[b] & mask)
            return int(np.sum(sel & (chi2 < 5.991) & (z > 1e-6)))

        # displacement guard: a legitimate post-BA correction moves a frame
        # by at most a few frame-steps of motion; larger jumps mean the
        # stored constraint set is stale (landmarks moved in BA / starved
        # association stretches) and the re-solve slid to a consistent-but-
        # wrong optimum.  Scale the guard to the trajectory's own motion
        # (reference analogue: the PnP translation sanity guard,
        # ba_project/src/ba/SfMHelper.cpp:76-80).
        centers = np.asarray([
            np_se3.rt6_to_mat44(np_se3.rt6_inverse(self._record_extr(r)))[:3, 3]
            for r in self.trajectory
        ])
        steps = np.linalg.norm(np.diff(centers, axis=0), axis=1)
        # floor the guard with an absolute term scaled to the scene: for
        # stationary / rotation-dominant trajectories median(steps) ~ 0 and a
        # pure multiple would reject every legitimate sub-millimeter
        # correction.  Scale = 1% of the median camera-to-landmark range.
        if V.any():
            rng = np.linalg.norm(P[V] - centers.mean(axis=0), axis=1)
            eps = 0.01 * float(np.median(rng))
        else:
            eps = 1e-3
        guard = max(3.0 * float(np.median(steps)), eps) if len(steps) else np.inf
        for b, rec in enumerate(recs):
            # accept the re-solve only if (a) a majority of its constraints
            # are chi2 inliers at the refined pose — an absolute floor alone
            # lets a wrong pose win by fitting 10 of N stale points, (b) it
            # lowers the robust cost on the same constraints, and (c) the
            # camera center moves less than the displacement guard — UNLESS
            # the evidence is overwhelming: with a guided re-association
            # against the post-final-BA map, a pose supported by >=80% chi2
            # inliers over >=3x min_track constraints is trustworthy at any
            # displacement (round-4 diagnosis: tracked tails drift by many
            # frame-steps relative to the BA-refined keyframes, and the
            # guard vetoed exactly the large corrections that fix them)
            n_constr = int(V[b].sum())
            n_inl = int(inl[b].sum())
            if n_inl < max(self.cfg.min_track_points, 0.5 * n_constr):
                continue
            extr_cur = self._record_extr(rec)
            c_old = np_se3.rt6_to_mat44(np_se3.rt6_inverse(extr_cur))[:3, 3]
            c_new = np_se3.rt6_to_mat44(np_se3.rt6_inverse(rt[b]))[:3, 3]
            strong = (n_inl >= 3 * self.cfg.min_track_points
                      and n_inl >= 0.8 * n_constr)
            disp = np.linalg.norm(c_new - c_old)
            # strong evidence relaxes the guard 10x instead of removing it:
            # a stale-but-self-consistent constraint set (repetitive
            # texture, fused/moved landmarks) can re-solve confidently to a
            # wrong pose at ANY displacement; bounding the correction keeps
            # that failure mode local while still accepting the many-frame-
            # step drift corrections the override exists for
            if disp > guard and not (strong and disp <= 10.0 * guard):
                continue
            # refine ONLY demonstrably broken poses, judged on the ORIGINAL
            # (tracking-time) constraints.  Three round-5 diagnoses shaped
            # this: (a) lower Huber cost is trivially satisfied by the
            # re-solve; (b) full-set inlier counts are rigged — the guided
            # re-association matched new landmarks within a pixel window AT
            # the stored pose, so the re-solve wins by centering its own
            # biased additions; (c) even original-set inlier IMPROVEMENT
            # cannot arbitrate when the stored pose already explains its
            # constraints — on forward trajectories drift is chi2-
            # UNOBSERVABLE (drifted tails score 0.94-0.99 inlier fraction)
            # and the re-solve then has no information to do better, only
            # map bias to import (measured: it degraded good online
            # trajectories 2-8x).  A pose is refinable when its original-
            # constraint inlier fraction is genuinely broken (< 0.75 —
            # BA moved the landmarks out from under a drifted pose, which
            # is exactly the observable-drift rescue case) AND the re-solve
            # strictly improves that count.
            n_live_orig = int(np.sum(V[b] & ORIG[b]))
            if n_live_orig < self.cfg.min_track_points:
                continue
            n_old_orig = chi2_inlier_count(extr_cur, b, mask=ORIG[b])
            if n_old_orig >= 0.75 * n_live_orig:
                continue  # pose already explains its evidence: nothing to fix
            n_new_orig = chi2_inlier_count(rt[b], b, mask=ORIG[b])
            if n_new_orig <= n_old_orig:
                continue
            if huber_cost(rt[b], b) < huber_cost(extr_cur, b):
                rec.extr = rt[b]
                # keep the keyframe anchor coherent with the refined pose
                if (rec.ref_kf is not None
                        and self.map.kf_active[rec.ref_kf]):
                    rec.rel = np_se3.rt6_compose(
                        rt[b],
                        np_se3.rt6_inverse(self.map.kf_pose[rec.ref_kf]))
                else:
                    rec.rel = None

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def _record_extr(self, rec):
        """The record's CURRENT best pose: keyframes read the (BA-refined)
        map; tracked frames ride their reference keyframe via the stored
        relative transform (ORB-SLAM trajectory-output semantics) — BA
        corrections to keyframes propagate to the frames tracked against
        them structurally, with no re-solve needed."""
        if rec.is_keyframe and self.map.kf_active[rec.slot]:
            return self.map.kf_pose[rec.slot]
        if (rec.rel is not None and rec.ref_kf is not None
                and self.map.kf_active[rec.ref_kf]):
            return np_se3.rt6_compose(rec.rel,
                                      self.map.kf_pose[rec.ref_kf])
        return rec.extr

    def trajectory_cam_to_world(self, smooth=True):
        """(timestamps, cam->world 4x4) for every tracked frame.

        smooth=False returns the CAUSAL trajectory (tracked frames at their
        raw tracking-time poses, keyframes refreshed from the map) — the
        `ate_online` metric's definition; the default applies the
        keyframe-anchored segment interpolation below.

        Keyframe poses are refreshed from the (BA-refined) map.  Tracked
        frames ride their keyframes with SEGMENT-INTERPOLATED world
        corrections: the correction observed at the previous keyframe (via
        the stored relative transform) and the one observed at the NEXT
        keyframe (its BA-refined pose vs its tracking-time pose — exactly
        the drift accumulated over the segment) are blended linearly in
        time.  This distributes inter-keyframe drift corrections across
        the segment instead of leaving each segment's tail uncorrected;
        corrections are small, so axis-angle+translation interpolation is
        adequate.  (ORB-SLAM outputs keyframe-relative poses; the
        interpolation is the natural refinement of that.)
        """
        n = len(self.trajectory)
        act = [r.is_keyframe and self.map.kf_active[r.slot]
               for r in self.trajectory]
        if not smooth:
            ts = np.asarray([r.timestamp for r in self.trajectory])
            mats = np.asarray([
                np_se3.rt6_to_mat44(np_se3.rt6_inverse(
                    self.map.kf_pose[r.slot] if act[i] else r.extr))
                for i, r in enumerate(self.trajectory)
            ])
            return ts, mats
        next_kf = [None] * n
        nk = None
        for i in range(n - 1, -1, -1):
            if act[i]:
                nk = i
            next_kf[i] = nk
        prev_kf = [None] * n
        pk = None
        for i in range(n):
            if act[i]:
                pk = i
            prev_kf[i] = pk
        ts, mats = [], []
        for i, rec in enumerate(self.trajectory):
            if act[i]:
                extr = self.map.kf_pose[rec.slot]
            else:
                # correction at the previous anchor: prefer the stored rel
                # (exact — captures mid-run BA updates of the reference
                # keyframe up to this record's moment); when that keyframe
                # was CULLED, fall back to the surviving previous ACTIVE
                # keyframe record's creation-baseline correction (culling
                # must not strip tracked frames of their drift correction)
                w_a = None
                if (rec.rel is not None and rec.ref_kf is not None
                        and self.map.kf_active[rec.ref_kf]):
                    kfA_r = np_se3.rt6_compose(
                        np_se3.rt6_inverse(rec.rel), rec.extr)
                    w_a = np_se3.rt6_compose(
                        np_se3.rt6_inverse(kfA_r),
                        self.map.kf_pose[rec.ref_kf])
                elif prev_kf[i] is not None:
                    prec = self.trajectory[prev_kf[i]]
                    w_a = np_se3.rt6_compose(
                        np_se3.rt6_inverse(prec.extr),
                        self.map.kf_pose[prec.slot])
                if w_a is None:
                    extr = rec.extr
                else:
                    w = w_a
                    j = next_kf[i]
                    p = prev_kf[i]
                    if j is not None and p is not None:
                        nrec = self.trajectory[j]
                        w_b = np_se3.rt6_compose(
                            np_se3.rt6_inverse(nrec.extr),
                            self.map.kf_pose[nrec.slot])
                        span = nrec.timestamp - self.trajectory[p].timestamp
                        if span > 1e-9:
                            s = np.clip(
                                (rec.timestamp
                                 - self.trajectory[p].timestamp) / span,
                                0.0, 1.0)
                            w = (1.0 - s) * w_a + s * w_b
                    extr = np_se3.rt6_compose(rec.extr, w)
            ts.append(rec.timestamp)
            mats.append(np_se3.rt6_to_mat44(np_se3.rt6_inverse(extr)))
        return np.asarray(ts), np.asarray(mats)

    def map_points(self):
        ids = self.map.active_points()
        return self.map.pt_pos[ids].copy()

    def map_points_colored(self):
        ids = self.map.active_points()
        return self.map.pt_pos[ids].copy(), self.map.pt_color[ids].copy()

    def run(self, dataset, predetect=False, mesh=None):
        """Full pipeline over an iterable of FrameData (microbatched tracking
        when cfg.track_batch > 1; see process_frames).

        predetect=True: run the data-parallel batched frontend over all
        frames first (frame axis sharded over `mesh` when given), then track
        with per-frame match+estimate dispatches only."""
        if predetect:
            frames = []
            for i, frame in enumerate(dataset):
                if i >= self.cfg.max_frames:
                    break
                frames.append(frame)
            pf = self.predetect_features(frames, mesh=mesh)
            statuses = self.process_frames(frames, prefeats=pf)
            if self.cfg.verbose:
                for i, status in enumerate(statuses):
                    print(f"[{i:4d}] {status}")
        elif self.cfg.track_batch > 1 and not self.cfg.verbose:
            timings = []
            statuses = self.process_frames(
                dataset, timings=timings, max_frames=self.cfg.max_frames)
            # steady-state rate: median over tracked frames after the first
            # ten (those carry the first compiles)
            tracked = [t for t, st in zip(timings[10:], statuses[10:])
                       if st == "tracked"]
            if tracked:
                self.stats["steady_fps"] = 1.0 / float(np.median(tracked))
        else:
            for i, frame in enumerate(dataset):
                if i >= self.cfg.max_frames:
                    break
                status = self.process_frame(frame)
                if self.cfg.verbose:
                    print(f"[{i:4d}] {status}  kfs={self.stats['keyframes']} "
                          f"pts={len(self.map.active_points())}")
                if status == "tracking-lost":
                    break
        self.finalize()
        self.stats["phase_times"] = self.timers.report()
        return self.stats


def _feat_capacity(config: PipelineConfig):
    """Upper bound on per-frame keypoints after per-level allocation rounding."""
    return config.n_features + 16 * config.n_levels
