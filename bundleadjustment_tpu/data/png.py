"""Minimal PNG codec on the standard library (zlib) and numpy.

Enough of the format for RGB-D datasets: reads non-interlaced images of
8-bit grey, grey+alpha, RGB and RGBA and of 16-bit grey and RGB, with all
five row filters; writes 8-bit grey/RGB/RGBA and 16-bit grey images
(unfiltered rows, zlib-compressed).  `read_png` hands the decoding to
Pillow where it is installed and gives the same arrays either way.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (palette images, type 3, are not supported)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        yield tag, body
        pos += 12 + length


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9) -> [height, stride] uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftypes, filt = data[:, 0], data[:, 1:].astype(np.int32)
    bad = np.flatnonzero(ftypes > 4)
    if bad.size:
        raise ValueError(f"PNG row {bad[0]}: unknown filter type "
                         f"{ftypes[bad[0]]}")
    if ftypes.max(initial=0) >= 3:
        return _unfilter_wavefront(ftypes, filt, bpp)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        cur = filt[y]
        if ftypes[y] == 1:  # Sub: running sum along each byte lane
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftypes[y] == 2:  # Up
            cur = (cur + prev) & 0xFF
        out[y] = cur
        prev = cur
    return out


def _unfilter_wavefront(ftypes, filt, bpp):
    """All five filters at once, over anti-diagonals of pixels.

    Pixel (y, x) depends on its left (y, x-1), upper (y-1, x) and upper-left
    (y-1, x-1) neighbours only, so every pixel of the diagonal y + x = t
    can be reconstructed together once diagonals t-1 and t-2 are: H + W - 1
    vectorised steps in place of one Python step per byte of the Average
    and Paeth rows that adaptive encoders (libpng, OpenCV) write."""
    height = len(ftypes)
    width = filt.shape[1] // bpp
    # pixels sorted by diagonal; `bounds[t]:bounds[t + 1]` is diagonal t
    y, x = np.divmod(np.arange(height * width), width)
    order = np.argsort(y + x, kind="stable")
    bounds = np.searchsorted((y + x)[order], np.arange(height + width))
    y, x = y[order], x[order]
    # reconstruction with a zero row above and a zero column to the left,
    # flattened: pixel (y, x) sits at (y + 1) * (width + 1) + x + 1
    at_all = (y + 1) * (width + 1) + x + 1
    left_all, up_all = at_all - 1, at_all - width - 1
    filt_all = filt.reshape(height * width, bpp)[order]
    ft_all = ftypes.astype(np.intp)[y][:, None]
    rec = np.zeros(((height + 1) * (width + 1), bpp), np.int32)
    zero = np.zeros((1, bpp), np.int32)
    for s, e in zip(bounds[:-1], bounds[1:]):
        a, b, c = rec[left_all[s:e]], rec[up_all[s:e]], rec[up_all[s:e] - 1]
        db, da = a - c, b - c  # Paeth: |p - a|, |p - b|, |p - c|
        pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ft_all[s:e], (zero, a, b, (a + b) >> 1, paeth))
        rec[at_all[s:e]] = (filt_all[s:e] + pred) & 0xFF
    rec = rec.reshape(height + 1, width + 1, bpp)[1:, 1:]
    return rec.reshape(height, width * bpp).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] or [H, W, C] array (uint8, or uint16 at 16 bit)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(
            f"unsupported PNG: colour type {ctype} at bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return img.reshape(height, width, ch) if ch > 1 else img.reshape(height, width)


# (bit depth, Pillow mode) pairs that Pillow decodes to the same array as
# `decode_png`
_PIL_SAME = {(8, "L"): np.uint8, (8, "LA"): np.uint8, (8, "RGB"): np.uint8,
             (8, "RGBA"): np.uint8, (16, "I;16"): np.uint16}


def read_png(path) -> np.ndarray:
    """Read a PNG file like `decode_png`.  Where Pillow is installed, its C
    decoder does the work: the numpy wavefront takes ~0.1 s for a 640x480
    image of Paeth rows, which a tracker at tens of frames/s cannot
    afford."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        from PIL import Image
    except ImportError:
        return decode_png(data)
    if data.startswith(_SIGNATURE) and len(data) > 24:
        with Image.open(io.BytesIO(data)) as im:
            dtype = _PIL_SAME.get((data[24], im.mode))  # IHDR bit depth
            if dtype is not None:
                return np.asarray(im, dtype)
    return decode_png(data)


def encode_png(img) -> bytes:
    """uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W] -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth = 0, 8
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        ctype, depth = (2 if img.shape[2] == 3 else 6), 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
    else:
        raise ValueError(
            f"cannot encode {img.dtype} array of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
