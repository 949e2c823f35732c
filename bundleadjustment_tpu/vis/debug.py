"""Debug visualizations: keypoint and match overlays.

The reference has compile-time DISPLAY_COLOR / DISPLAY_DEPTH /
DISPLAY_MATCHES toggles opening OpenCV windows
(`ba_project/src/ba/BundleAdjustment.h:16-18`); headless equivalent: PNG
writers for keypoint overlays and side-by-side match visualizations.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(gray_or_rgb):
    img = np.asarray(gray_or_rgb)
    if img.ndim == 2:
        g = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        return np.stack([g, g, g], -1)
    return img.astype(np.uint8)


def _draw_point(img, x, y, color, r=2):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    img[max(0, y - r) : min(h, y + r + 1), max(0, x - r) : min(w, x + r + 1)] = color


def _draw_line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_keypoints(image, xy, valid=None, color=(0, 255, 0)):
    """Keypoint overlay -> RGB uint8 array."""
    img = _to_rgb(image).copy()
    xy = np.asarray(xy)
    if valid is None:
        valid = np.ones(len(xy), bool)
    for i in np.nonzero(valid)[0]:
        _draw_point(img, xy[i, 0], xy[i, 1], color)
    return img


def draw_matches(image_a, xy_a, image_b, xy_b, matches, max_draw=200,
                 seed=0):
    """Side-by-side match visualization (DISPLAY_MATCHES analogue).

    matches: [Ma] index into b or -1.  Returns RGB uint8 [H, Wa+Wb, 3].
    """
    a = _to_rgb(image_a)
    b = _to_rgb(image_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    rng = np.random.default_rng(seed)
    matched = np.nonzero(np.asarray(matches) >= 0)[0]
    if len(matched) > max_draw:
        matched = rng.choice(matched, max_draw, replace=False)
    for i in matched:
        j = matches[i]
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        x0, y0 = xy_a[i]
        x1, y1 = xy_b[j][0] + off, xy_b[j][1]
        _draw_line(canvas, x0, y0, x1, y1, color)
        _draw_point(canvas, x0, y0, color)
        _draw_point(canvas, x1, y1, color)
    return canvas


def save_png(path, rgb):
    from bundleadjustment_tpu.data.png import write_png

    write_png(path, np.asarray(rgb, np.uint8))
