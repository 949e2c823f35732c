import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.ops.features import (
    FeatureConfig,
    detect_and_describe,
    fast_corners,
    harris_response,
)
from bundleadjustment_tpu.ops.matching import match_descriptors


def checkerboard(h=120, w=160, sq=16):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // sq) + (xs // sq)) % 2).astype(np.float32)


def textured_image(rng, h=120, w=160):
    """Smooth random texture with strong corners."""
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    return img


def test_fast_detects_isolated_square_corners():
    # isolated bright squares on black -> L-corners, the canonical FAST case
    # (checkerboard X-junctions are NOT FAST corners: arcs alternate 4-4-4-4)
    img = np.zeros((96, 96), np.float32)
    for y0, x0 in [(16, 16), (16, 60), (60, 16), (60, 60)]:
        img[y0 : y0 + 20, x0 : x0 + 20] = 1.0
    mask = np.asarray(fast_corners(jnp.asarray(img), 0.2))
    assert mask.sum() >= 8  # corners (and near-corner ring pixels) fire
    # uniform region has no corners
    flat = np.asarray(fast_corners(jnp.full((64, 64), 0.5, jnp.float32), 0.2))
    assert flat.sum() == 0


def test_harris_peaks_at_corners():
    img = checkerboard()
    h, shi = harris_response(jnp.asarray(img))
    h = np.asarray(h)
    # interior corner point (16,16) should beat an edge midpoint (16, 8)
    assert h[16, 16] > h[16, 8]
    assert np.asarray(shi).max() > 0


def test_detect_and_describe_shapes(rng):
    img = textured_image(rng)
    cfg = FeatureConfig(n_features=300, n_levels=4)
    feats = detect_and_describe(jnp.asarray(img), cfg)
    m = feats.xy.shape[0]
    assert m >= 300
    assert feats.desc.shape == (m, 8)
    assert feats.desc.dtype == jnp.uint32
    v = np.asarray(feats.valid)
    assert v.sum() > 50
    xy = np.asarray(feats.xy)[v]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 160).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 120).all()


def test_descriptors_match_under_translation(rng):
    """Features of a translated image match back to the original."""
    base = textured_image(rng, 160, 200)
    dx, dy = 6, 4
    shifted = np.roll(base, (dy, dx), axis=(0, 1))
    cfg = FeatureConfig(n_features=400, n_levels=3)
    fa = detect_and_describe(jnp.asarray(base), cfg)
    fb = detect_and_describe(jnp.asarray(shifted), cfg)
    idx, dist = match_descriptors(
        fa.desc, fb.desc, valid_a=fa.valid, valid_b=fb.valid,
        metric="hamming", ratio=0.8, max_dist=64.0,
    )
    idx = np.asarray(idx)
    matched = np.nonzero(idx >= 0)[0]
    assert len(matched) > 30
    # matched keypoints should be displaced by ~(dx, dy)
    xa = np.asarray(fa.xy)[matched]
    xb = np.asarray(fb.xy)[idx[matched]]
    disp = xb - xa
    med = np.median(disp, axis=0)
    np.testing.assert_allclose(med, [dx, dy], atol=1.5)


def test_alternative_detectors(rng):
    """harris / shi_tomasi paths (reference FeatureProcessor.cpp:118-211) —
    unlike the reference, ours still produce matchable descriptors."""
    img = textured_image(rng)
    for det in ("harris", "shi_tomasi"):
        cfg = FeatureConfig(n_features=200, n_levels=2, detector=det)
        f = detect_and_describe(jnp.asarray(img), cfg)
        v = np.asarray(f.valid)
        assert v.sum() > 30, det
        idx, _ = match_descriptors(
            f.desc, f.desc, valid_a=f.valid, valid_b=f.valid,
            metric="hamming", ratio=0.9, cross_check=False,
        )
        idx = np.asarray(idx)
        # self-matching maps each valid keypoint to itself
        sel = np.nonzero(v)[0]
        assert (idx[sel] == sel).mean() > 0.95, det


def test_detect_batch_jit_consistency(rng):
    img = textured_image(rng)
    cfg = FeatureConfig(n_features=200, n_levels=3)
    f1 = detect_and_describe(jnp.asarray(img), cfg)
    f2 = detect_and_describe(jnp.asarray(img), cfg)
    np.testing.assert_array_equal(np.asarray(f1.xy), np.asarray(f2.xy))
    np.testing.assert_array_equal(np.asarray(f1.desc), np.asarray(f2.desc))


def test_fast_corners_bitpack_matches_naive():
    """The packed shift-AND contiguous-9 test must equal the naive
    16-start x 9-AND scan."""
    import jax.numpy as jnp
    from bundleadjustment_tpu.ops.features import _FAST_CIRCLE, fast_corners

    rng = np.random.default_rng(7)
    img = rng.random((48, 64)).astype(np.float32)
    thr = 0.08

    shifted = np.stack(
        [np.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _FAST_CIRCLE]
    )
    bright = shifted > img[None] + thr
    dark = shifted < img[None] - thr

    def naive9(m):
        m2 = np.concatenate([m, m[:8]], axis=0)
        out = np.zeros_like(m[0])
        for s in range(16):
            run = m2[s].copy()
            for j in range(1, 9):
                run &= m2[s + j]
            out |= run
        return out

    expect = naive9(bright) | naive9(dark)
    got = np.asarray(fast_corners(jnp.asarray(img), thr))
    np.testing.assert_array_equal(got, expect)


def test_shift_add_conv_matches_lax_conv():
    """The shift-add separable correlation (the frontend's lowering) must be
    numerically identical to the `lax.conv_general_dilated` formulation it
    replaced (zero 'same' padding, no kernel flip)."""
    import jax
    from bundleadjustment_tpu.ops.features import _gauss_kernel, _sep_conv, _sobel

    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.random((97, 130)).astype(np.float32))
    k = _gauss_kernel(2.0, 3)

    def ref_sep(img, kernel):
        kk = jnp.asarray(kernel)
        r = (kk.shape[0] - 1) // 2
        img4 = img[None, None]
        kx = kk.reshape(1, 1, 1, -1)
        ky = kk.reshape(1, 1, -1, 1)
        out = jax.lax.conv_general_dilated(img4, kx, (1, 1), [(0, 0), (r, r)])
        out = jax.lax.conv_general_dilated(out, ky, (1, 1), [(r, r), (0, 0)])
        return out[0, 0]

    np.testing.assert_allclose(
        np.asarray(_sep_conv(img, k)), np.asarray(ref_sep(img, k)),
        atol=1e-6,
    )
    # Sobel antisymmetric tap: correlation (not flipped convolution)
    ix, iy = _sobel(img)
    ramp = jnp.asarray(np.tile(np.arange(20, dtype=np.float32), (20, 1)))
    ix_r, _ = _sobel(ramp)
    # interior gradient of a unit x-ramp under [-1,0,1]x[1,2,1] is +8
    assert np.allclose(np.asarray(ix_r)[5:-5, 5:-5], 8.0)
    assert np.asarray(ix).shape == img.shape and np.asarray(iy).shape == img.shape


def test_matmul_resize_matches_jax_image_resize():
    """The cached-weight matmul resize must reproduce
    `jax.image.resize(..., "linear")` (same antialiased triangle weights)."""
    import jax
    from bundleadjustment_tpu.ops.features import _resize_linear

    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.random((480, 640)).astype(np.float32))
    for (h, w) in [(400, 533), (231, 309), (134, 179)]:
        got = np.asarray(_resize_linear(img, h, w))
        want = np.asarray(jax.image.resize(img, (h, w), "linear"))
        np.testing.assert_allclose(got, want, atol=1e-4)
