"""Batched descriptor matching: all-pairs distances + knn-2 ratio test.

Array-form replacement for FLANN knn matching + Lowe ratio + uniqueness
cross-check (reference `ba_project/src/ba/FeatureProcessor.cpp:39-95`):

- float descriptors: squared-L2 via one matrix product (|a|^2 + |b|^2 - 2 a.b);
- binary descriptors (ORB-style, packed uint32 words): XOR + popcount over
  the [M1, M2] pairs, which XLA fuses with the top-2 reduction.

The ratio test keeps a match when best < ratio * second-best
(`FeatureProcessor.cpp:51-59`, ratio 0.7), and uniqueness keeps only the
lowest-distance query per train index (`:61-76` keeps the first seen; keeping
the best is strictly stronger) — implemented as a segment-min scatter, no
loops.  Everything is fixed-shape and mask-based: invalid keypoints (padding)
carry +inf distance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bundleadjustment_tpu.utils.precision import HIGHEST

DEFAULT_RATIO = 0.7  # reference FeatureProcessor.cpp:53


def l2_distance_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Squared L2 distances [M1, M2].  Invalid rows/cols -> +inf."""
    a2 = jnp.sum(desc_a * desc_a, axis=-1, keepdims=True)
    b2 = jnp.sum(desc_b * desc_b, axis=-1, keepdims=True)
    d = a2 + b2.T - 2.0 * jnp.dot(desc_a, desc_b.T, precision=HIGHEST,
                                  preferred_element_type=jnp.float32)
    d = jnp.maximum(d, 0.0)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, jnp.inf)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, jnp.inf)
    return d


def _popcount32(x):
    """Vectorized popcount on uint32."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def hamming_distance_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Hamming distances [M1, M2] for packed-uint32 descriptors [Mi, W]."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    d = jnp.sum(_popcount32(x), axis=-1).astype(jnp.float32)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, jnp.inf)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, jnp.inf)
    return d


def _top2_rows(d):
    """(best_val, best_idx, second_val) per row of a distance matrix."""
    best_idx = jnp.argmin(d, axis=1)
    m2 = d.shape[1]
    best_val = jnp.min(d, axis=1)
    masked = jnp.where(
        jax.nn.one_hot(best_idx, m2, dtype=bool), jnp.inf, d
    )
    second_val = jnp.min(masked, axis=1)
    return best_val, best_idx, second_val


def match_descriptors(
    desc_a,
    desc_b,
    valid_a=None,
    valid_b=None,
    metric="l2",
    ratio=DEFAULT_RATIO,
    max_dist=None,
    cross_check=True,
):
    """knn-2 matching with Lowe ratio and uniqueness filtering.

    Args:
      desc_a: [M1, D] query descriptors (float) or [M1, W] packed uint32.
      desc_b: [M2, D] train descriptors.
      valid_a, valid_b: optional keypoint validity masks (padding).
      metric: "l2" (squared-L2 compared with squared thresholds) or "hamming".
      ratio: Lowe ratio on *distances* (applied in the metric's natural units:
        sqrt for L2 to match the reference's L2-norm ratio semantics).
      max_dist: optional absolute distance gate (natural units).
      cross_check: keep only the best query per train index.

    Returns:
      match_idx: [M1] int32 — index into B, or -1.
      match_dist: [M1] float32 — distance in natural units (inf if unmatched).
    """
    if metric == "l2":
        d = l2_distance_matrix(desc_a, desc_b, valid_a, valid_b)
        to_natural = jnp.sqrt
    elif metric == "hamming":
        d = hamming_distance_matrix(desc_a, desc_b, valid_a, valid_b)
        to_natural = lambda x: x
    else:
        raise ValueError(f"unknown metric {metric!r}")

    best, idx, second = _top2_rows(d)
    best_n = to_natural(best)
    second_n = to_natural(jnp.where(jnp.isinf(second), jnp.finfo(jnp.float32).max, second))
    ok = jnp.isfinite(best_n) & (best_n < ratio * second_n)
    if max_dist is not None:
        ok = ok & (best_n <= max_dist)

    if cross_check:
        m2 = d.shape[1]
        # segment-min of best distance per train index
        big = jnp.finfo(jnp.float32).max
        per_train_best = jax.ops.segment_min(
            jnp.where(ok, best_n, big), idx, num_segments=m2
        )
        is_best_for_train = ok & (best_n <= per_train_best[idx])
        # tie-break duplicates deterministically: lowest query index wins
        m1 = d.shape[0]
        qidx = jnp.arange(m1, dtype=jnp.int32)
        first_q = jax.ops.segment_min(
            jnp.where(is_best_for_train, qidx, m1), idx, num_segments=m2
        )
        ok = is_best_for_train & (first_q[idx] == qidx)

    match_idx = jnp.where(ok, idx, -1).astype(jnp.int32)
    match_dist = jnp.where(ok, best_n, jnp.inf)
    return match_idx, match_dist


match_descriptors_jit = functools.partial(
    jax.jit, static_argnames=("metric", "ratio", "max_dist", "cross_check")
)(match_descriptors)


@functools.partial(
    jax.jit, static_argnames=("metric", "ratio", "max_dist", "cross_check")
)
def match_descriptors_batch(
    desc_a,
    descs_b,
    valid_a=None,
    valids_b=None,
    metric="hamming",
    ratio=DEFAULT_RATIO,
    max_dist=None,
    cross_check=True,
):
    """Match ONE query set against a BATCH of train sets in one dispatch.

    desc_a: [M1, D]; descs_b: [B, M2, D]; valids_b: [B, M2].
    Returns (idx [B, M1], dist [B, M1]).  Used by the keyframe neighborhood
    search (reference SfMHelper.cpp:203-496 re-matches against ~25 neighbor
    frames — one vmapped call instead of 25 dispatches).
    """
    def one(db, vb):
        return match_descriptors(
            desc_a, db, valid_a=valid_a, valid_b=vb, metric=metric,
            ratio=ratio, max_dist=max_dist, cross_check=cross_check,
        )

    return jax.vmap(one)(descs_b, valids_b)
