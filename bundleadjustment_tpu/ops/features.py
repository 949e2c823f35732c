"""Batched multi-scale feature detection + oriented binary descriptors.

Array-form replacement for the reference's OpenCV feature frontend
(`ba_project/src/ba/FeatureProcessor.cpp`): SURF detect/describe (`:16-21,
213-241`), Harris (`:118-156`) and Shi-Tomasi (`:158-211`) corners.  Instead
of patented SURF we implement an ORB-style pipeline (per BASELINE.json's
north star): FAST-16 corners gated + ranked by Harris response over a
1.2-scale pyramid (8 levels — matching the reference's 8 SURF octaves and the
1.2^octave scale model baked into MapPoint distance bounds,
`src/model/MapPoint.cpp:7-27`), intensity-centroid orientation, and a
rotation-steered 256-bit BRIEF descriptor packed into 8 uint32 words.

Everything is expressed as fused elementwise ops + convolutions + top_k on
static shapes, so XLA compiles it without host round-trips; a
whole frame batch runs per device via vmap.  Keypoint counts are fixed per
level (padding + validity masks), the XLA answer to OpenCV's dynamic vectors.

The descriptor *pattern* is generated from a seeded Gaussian sampler (the
original BRIEF recipe) — descriptors only ever match against descriptors
produced by this same module, so no learned pattern table is needed.
"""

from __future__ import annotations

import functools
import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.utils.precision import mm


class FeatureConfig(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0 / 255.0
    harris_k: float = 0.04
    detector: str = "fast_harris"  # "fast_harris" | "harris" | "shi_tomasi"
    border: int = 16  # keep-out border for orientation/descriptor windows
    topk: str = "approx"  # "approx" uses lax.approx_max_k — a partial-
    #   reduction top-k where the backend has one (~0.95 recall, immaterial
    #   for corner selection; exact elsewhere); "exact" forces the full sort


class Features(NamedTuple):
    xy: jnp.ndarray  # [M, 2] level-0 pixel coordinates (x, y)
    response: jnp.ndarray  # [M]
    octave: jnp.ndarray  # [M] int32 pyramid level
    angle: jnp.ndarray  # [M] radians
    sigma2: jnp.ndarray  # [M] scale variance = scale_factor^(2*octave)
    desc: jnp.ndarray  # [M, 8] uint32 packed 256-bit descriptors
    valid: jnp.ndarray  # [M] bool


# ---------------------------------------------------------------------------
# fixed tables (host-side constants)
# ---------------------------------------------------------------------------

# FAST-16 Bresenham circle of radius 3 (dy, dx), clockwise
_FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)


def _brief_pattern(n_bits=256, patch=31, seed=1234):
    """Seeded Gaussian BRIEF sampling pattern [n_bits, 4] = (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    lim = patch // 2 - 2
    return np.clip(pts, -lim, lim).astype(np.float32)


_BRIEF = _brief_pattern()


def _disc_offsets(radius=15):
    """Offsets (dy, dx) within a disc + centroid weights for orientation."""
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    mask = (ys * ys + xs * xs) <= radius * radius
    return ys[mask].astype(np.int32), xs[mask].astype(np.int32)


_ORI_DY, _ORI_DX = _disc_offsets()


def _gauss_kernel(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------


def _corr1d(img, kernel, axis):
    """1D cross-correlation with zero 'same' padding along `axis`.

    Emitted as shifted static slices + weighted adds instead of
    `lax.conv_general_dilated`: for these tiny taps the shift-add form fuses
    into the surrounding elementwise graph.  Bitwise semantics match the
    conv path: correlation (no kernel flip), zero padding."""
    k = np.asarray(kernel, np.float32)
    # even-length kernels would slice past the padded extent, and an
    # all-zero kernel would silently return None at trace time
    assert k.shape[0] % 2 == 1, f"kernel length must be odd, got {k.shape[0]}"
    r = (k.shape[0] - 1) // 2
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    xp = jnp.pad(img, pad)
    out = jnp.zeros_like(img)
    for i in range(k.shape[0]):
        if k[i] == 0.0:
            continue
        out = out + float(k[i]) * jax.lax.slice_in_dim(xp, i, i + n, axis=axis)
    return out


def _sep_conv(img, kernel):
    """Separable 2D correlation (same zero padding) on [H, W] or [B, H, W]."""
    out = _corr1d(img, kernel, axis=img.ndim - 1)
    return _corr1d(out, kernel, axis=img.ndim - 2)


def gaussian_blur(img, sigma=2.0, radius=3):
    return _sep_conv(img, _gauss_kernel(sigma, radius))


def _sobel(img):
    """Sobel gradients (Ix, Iy) via separable shift-add correlations."""
    kd = [-1.0, 0.0, 1.0]
    ks = [1.0, 2.0, 1.0]
    ix = _corr1d(_corr1d(img, kd, axis=1), ks, axis=0)
    iy = _corr1d(_corr1d(img, kd, axis=0), ks, axis=1)
    return ix, iy


def harris_response(img, k=0.04, window_sigma=1.5):
    """Harris corner response map (and Shi-Tomasi min-eigenvalue map)."""
    ix, iy = _sobel(img)
    g = _gauss_kernel(window_sigma, 3)
    # one batched separable conv over the 3 structure-tensor channels
    # instead of three dispatch chains
    s = _sep_conv(jnp.stack([ix * ix, iy * iy, ix * iy]), g)
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    harris = det - k * tr * tr
    # min eigenvalue = tr/2 - sqrt((tr/2)^2 - det)
    half = 0.5 * tr
    shi = half - jnp.sqrt(jnp.maximum(half * half - det, 0.0))
    return harris, shi


def fast_corners(img, threshold):
    """FAST-16 corner mask: >= 9 contiguous circle pixels brighter/darker.

    The 16 circle comparisons are packed into one uint32 code per pixel and
    the contiguous-9 test runs as 8 shift-AND rounds on the circularly
    extended code (bit i survives round k iff bits i..i+k are all set) —
    24 full-width integer ops instead of 256 boolean AND/OR passes.
    """
    shifted = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _FAST_CIRCLE]
    )  # [16, H, W]
    bright = shifted > (img + threshold)[None]
    dark = shifted < (img - threshold)[None]

    def contiguous9(m):
        code = jnp.zeros(img.shape, jnp.uint32)
        for i in range(16):
            code = code | (m[i].astype(jnp.uint32) << np.uint32(i))
        y = code | (code << np.uint32(16))  # circular extension
        for _ in range(8):
            y = y & (y >> np.uint32(1))
        return (y & np.uint32(0xFFFF)) != 0

    return contiguous9(bright) | contiguous9(dark)


@functools.lru_cache(maxsize=256)
def _resize_mat(dst, src):
    """[dst, src] linear-resize weight matrix, identical to what
    `jax.image.resize(..., "linear")` applies along one axis (computed once
    per shape pair by resizing an identity; lru-cached host-side — bounded
    and thread-safe, unlike the former hand-rolled dict).

    Pinned to the CPU backend: this runs eagerly at trace time, so on the
    default device every distinct shape pair would compile a device program
    of its own."""
    cpu = jax.devices("cpu")[0]
    with jax.ensure_compile_time_eval(), jax.default_device(cpu):
        eye = jnp.eye(src, dtype=jnp.float32)
        return np.asarray(jax.image.resize(eye, (dst, src), "linear"))


def _resize_linear(img, h_out, w_out):
    """Linear image resize as two small matrix products.

    The same linear map `jax.image.resize` applies, expressed as
    [h_out, H] @ img @ [W, w_out] instead of gathers.  Full float32
    precision keeps the interpolation exact (a TF32 or bf16 product would
    quantize the image)."""
    wh = jnp.asarray(_resize_mat(h_out, img.shape[0]))
    ww = jnp.asarray(_resize_mat(w_out, img.shape[1]))
    return mm(mm(wh, img), ww.T)


def _nms3(score):
    """3x3 non-maximum suppression mask."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return score >= neigh


def orientation_angles(img_blur, ys, xs):
    """Intensity-centroid orientation at integer keypoint locations.

    ORB's m01/m10 moments over a radius-15 disc, via gathers on the blurred
    image (one [M, n_disc] gather).
    """
    H, W = img_blur.shape
    yy = jnp.clip(ys[:, None] + _ORI_DY[None, :], 0, H - 1)
    xx = jnp.clip(xs[:, None] + _ORI_DX[None, :], 0, W - 1)
    patch = img_blur[yy, xx]  # [M, n_disc]
    m10 = jnp.sum(patch * _ORI_DX[None, :], axis=1)
    m01 = jnp.sum(patch * _ORI_DY[None, :], axis=1)
    return jnp.arctan2(m01, m10)


def brief_descriptors(img_blur, ys, xs, angles):
    """Rotation-steered BRIEF-256, packed to [M, 8] uint32."""
    H, W = img_blur.shape
    ca, sa = jnp.cos(angles), jnp.sin(angles)  # [M]
    px1, py1 = _BRIEF[:, 0], _BRIEF[:, 1]
    px2, py2 = _BRIEF[:, 2], _BRIEF[:, 3]

    def rot(px, py):
        rx = ca[:, None] * px[None] - sa[:, None] * py[None]
        ry = sa[:, None] * px[None] + ca[:, None] * py[None]
        return rx, ry

    r1x, r1y = rot(px1, py1)
    r2x, r2y = rot(px2, py2)
    x1 = jnp.clip(jnp.round(xs[:, None] + r1x).astype(jnp.int32), 0, W - 1)
    y1 = jnp.clip(jnp.round(ys[:, None] + r1y).astype(jnp.int32), 0, H - 1)
    x2 = jnp.clip(jnp.round(xs[:, None] + r2x).astype(jnp.int32), 0, W - 1)
    y2 = jnp.clip(jnp.round(ys[:, None] + r2y).astype(jnp.int32), 0, H - 1)
    bits = (img_blur[y1, x1] < img_blur[y2, x2]).astype(jnp.uint32)  # [M, 256]
    bits = bits.reshape(bits.shape[0], 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# per-level detection
# ---------------------------------------------------------------------------


def _detect_level(img, n_keep, cfg: FeatureConfig):
    """Detect top-n_keep corners on one pyramid level.

    Returns (ys, xs, responses, angles, desc, valid) with static length n_keep.
    """
    H, W = img.shape
    harris, shi = harris_response(img, cfg.harris_k)
    if cfg.detector == "fast_harris":
        gate = fast_corners(img, cfg.fast_threshold)
        score = jnp.where(gate, harris, -jnp.inf)
    elif cfg.detector == "harris":
        score = harris
    elif cfg.detector == "shi_tomasi":
        score = shi
    else:
        raise ValueError(f"unknown detector {cfg.detector!r}")

    score = jnp.where(_nms3(score), score, -jnp.inf)
    # border keep-out
    b = cfg.border
    ys_g, xs_g = jnp.mgrid[0:H, 0:W]
    inb = (ys_g >= b) & (ys_g < H - b) & (xs_g >= b) & (xs_g < W - b)
    score = jnp.where(inb, score, -jnp.inf)

    flat = score.reshape(-1)
    if cfg.topk == "approx":
        # partial-reduction top-k; corner selection tolerates its ~0.95
        # recall — missing the 950th-best corner costs nothing downstream
        vals, idx = jax.lax.approx_max_k(flat, n_keep)
    else:
        vals, idx = jax.lax.top_k(flat, n_keep)
    ys = idx // W
    xs = idx % W
    valid = jnp.isfinite(vals) & (vals > 0)

    # sub-pixel refinement: 1D quadratic fit on the raw response surface
    # (the cv::cornerSubPix analogue, reference FeatureProcessor.cpp:203;
    # integer keypoints would alias a global sub-pixel image shift into a
    # systematic per-frame pose bias)
    resp = harris if cfg.detector != "shi_tomasi" else shi
    ym = jnp.clip(ys - 1, 0, H - 1)
    yp = jnp.clip(ys + 1, 0, H - 1)
    xm = jnp.clip(xs - 1, 0, W - 1)
    xp = jnp.clip(xs + 1, 0, W - 1)
    c = resp[ys, xs]
    dxn = resp[ys, xp] - resp[ys, xm]
    dxd = 2.0 * (2.0 * c - resp[ys, xp] - resp[ys, xm])
    dyn = resp[yp, xs] - resp[ym, xs]
    dyd = 2.0 * (2.0 * c - resp[yp, xs] - resp[ym, xs])
    off_x = jnp.clip(dxn / jnp.where(jnp.abs(dxd) < 1e-12, 1e-12, dxd), -0.5, 0.5)
    off_y = jnp.clip(dyn / jnp.where(jnp.abs(dyd) < 1e-12, 1e-12, dyd), -0.5, 0.5)
    xs_f = xs.astype(jnp.float32) + off_x
    ys_f = ys.astype(jnp.float32) + off_y

    blur = gaussian_blur(img)
    angles = orientation_angles(blur, ys, xs)
    desc = brief_descriptors(blur, ys, xs, angles)
    return ys_f, xs_f, vals, angles, desc, valid


def _level_allocations(cfg: FeatureConfig):
    """Per-level keypoint budget, geometric in 1/scale like ORB."""
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv**i for i in range(cfg.n_levels)])
    alloc = np.floor(cfg.n_features * weights / weights.sum()).astype(int)
    alloc[0] += cfg.n_features - alloc.sum()
    return [max(int(a), 8) for a in alloc]


@partial(jax.jit, static_argnames=("cfg",))
def detect_and_describe(image, cfg: FeatureConfig = FeatureConfig()):
    """Full pyramid detection on one grayscale image [H, W] in [0, 1].

    Returns Features with M = sum of per-level allocations (>= cfg.n_features),
    xy in level-0 pixel coordinates.  vmap over a leading batch axis for
    multi-frame batches; shapes are static per (H, W, cfg).
    """
    H, W = image.shape
    allocs = _level_allocations(cfg)
    outs = []
    img_l = image
    for lvl in range(cfg.n_levels):
        scale = cfg.scale_factor**lvl
        if lvl > 0:
            h_l = max(int(round(H / scale)), 2 * cfg.border + 8)
            w_l = max(int(round(W / scale)), 2 * cfg.border + 8)
            img_l = _resize_linear(image, h_l, w_l)
        ys, xs, resp, ang, desc, valid = _detect_level(img_l, allocs[lvl], cfg)
        xy0 = jnp.stack([xs, ys], -1) * scale
        octave = jnp.full(allocs[lvl], lvl, jnp.int32)
        sigma2 = jnp.full(allocs[lvl], scale * scale, jnp.float32)
        outs.append((xy0, resp, octave, ang, sigma2, desc, valid))

    xy = jnp.concatenate([o[0] for o in outs])
    resp = jnp.concatenate([o[1] for o in outs])
    octv = jnp.concatenate([o[2] for o in outs])
    ang = jnp.concatenate([o[3] for o in outs])
    sig = jnp.concatenate([o[4] for o in outs])
    desc = jnp.concatenate([o[5] for o in outs])
    valid = jnp.concatenate([o[6] for o in outs])
    resp = jnp.where(valid, resp, -jnp.inf)
    return Features(xy=xy, response=resp, octave=octv, angle=ang, sigma2=sig, desc=desc, valid=valid)


def detect_batch(images, cfg: FeatureConfig = FeatureConfig()):
    """vmapped detection over a frame batch [B, H, W]."""
    return jax.vmap(lambda im: detect_and_describe(im, cfg))(images)
