"""The stdlib PNG codec (`data/png.py`): round trips and all five row
filters, checked against a reference filter encoder written here."""

import struct
import sys
import zlib

import numpy as np
import pytest

from bundleadjustment_tpu.data.png import decode_png, encode_png, read_png, write_png


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "grey16"])
def test_round_trip(kind, rng, tmp_path):
    if kind == "grey8":
        img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    elif kind == "rgb8":
        img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    path = tmp_path / "img.png"
    write_png(path, img)
    back = read_png(path)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    """Forward PNG filter of one row of bytes (spec §9.2)."""
    out = []
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
        out.append((row[x] - pred) & 0xFF)
    return bytes([ftype] + out)


def _png_with_filter(img, ftype):
    """8-bit RGBA image -> PNG whose row y uses filter `ftype` (an int) or
    `ftype[y]` (a sequence, as adaptive encoders write)."""
    h, w, _ = img.shape
    ftypes = [ftype] * h if isinstance(ftype, int) else list(ftype)
    rows = img.reshape(h, -1).tolist()
    prev = [0] * (4 * w)
    raw = b""
    for r, f in zip(rows, ftypes):
        raw += _filter_row(f, r, prev, 4)
        prev = r

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_decodes_each_filter_type(ftype, rng):
    img = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_png_with_filter(img, ftype)), img)


@pytest.mark.parametrize("shape", [(6, 17), (19, 5)], ids=["wide", "tall"])
def test_decodes_mixed_filters(shape, rng):
    img = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
    ftypes = rng.integers(0, 5, shape[0]).tolist()
    np.testing.assert_array_equal(decode_png(_png_with_filter(img, ftypes)), img)


@pytest.mark.parametrize("kind", ["grey8", "rgba8", "grey16"])
def test_read_png_same_without_pillow(kind, rng, tmp_path, monkeypatch):
    if kind == "grey8":
        img = rng.integers(0, 256, (12, 7), dtype=np.uint8)
    elif kind == "rgba8":
        img = rng.integers(0, 256, (12, 7, 4), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (12, 7), dtype=np.uint16)
    path = tmp_path / "img.png"
    write_png(path, img)
    with_pillow = read_png(path)  # Pillow's decoder where it is installed
    monkeypatch.setitem(sys.modules, "PIL", None)  # import now fails
    without = read_png(path)
    for back in (with_pillow, without):
        assert back.dtype == img.dtype and back.shape == img.shape
        np.testing.assert_array_equal(back, img)


def test_rejects_unsupported_input():
    with pytest.raises(ValueError):
        decode_png(b"not a png")
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))
