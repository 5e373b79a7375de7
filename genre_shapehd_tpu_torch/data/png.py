"""PNG read/write with the standard library's ``zlib`` and numpy.

Supports what the test photos and masks and the ShapeNet renderings
use: 8- and 16-bit grayscale, RGB and RGBA, non-interlaced, all five row
filter types (a file with Average or Paeth rows decodes by
anti-diagonals, see :func:`_unfilter_diagonals`; the writer can filter
its rows as libpng does).  Arrays are (H, W) or (H, W, C), uint8 or
uint16, in R, G, B(, A) order; 16-bit samples are stored big-endian.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor, elementwise on int16 arrays."""
    da, db = a - c, b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    ftypes = rows[:, 0]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftypes.max()}")
    if (ftypes >= 3).any():
        return _unfilter_diagonals(rows[:, 1:], ftypes, bpp)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, row = ftypes[y], rows[y, 1:]
        if ftype == 0:
            cur = row
        elif ftype == 1:        # Sub: running sum per channel, mod 256
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0,
                             dtype=np.uint64) & 0xFF).astype(
                np.uint8).reshape(-1)
        else:                   # Up
            cur = row + prev
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_diagonals(rows: np.ndarray, ftypes: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters (Average and Paeth predict from the
    left pixel, so a row is sequential): pixel (y, x) needs (y, x-1),
    (y-1, x) and (y-1, x-1), so each anti-diagonal y + x = t is decoded
    at once from the two before it, H + W - 1 steps of numpy over at
    most H pixels.  ``out[t + 2, y + 1]`` holds pixel (y, t - y); row 0,
    the two first diagonals and every x < 0 stay zero, the filters' edge
    values."""
    h = rows.shape[0]
    w = rows.shape[1] // bpp
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    filt = np.zeros((h + w, h, bpp), np.int16)
    filt[ys + xs, ys] = rows.reshape(h, w, bpp)
    out = np.zeros((h + w + 2, h + 1, bpp), np.int16)
    ft = ftypes.astype(np.intp)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h - 1, t) + 1
        a = out[t + 1, lo + 1:hi + 1]            # left
        b = out[t + 1, lo:hi]                    # up
        c = out[t, lo:hi]                        # up-left
        pred = np.choose(ft[lo:hi], (zero[:hi - lo], a, b, (a + b) >> 1,
                                     _paeth(a, b, c)))
        out[t + 2, lo + 1:hi + 1] = (filt[t, lo:hi] + pred) & 0xFF
    return out[2 + ys + xs, 1 + ys].astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth not in (8, 16) or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    nbytes = depth // 8                  # the filters work on bytes
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * nbytes,
                    ch * nbytes)
    if nbytes == 2:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Each row of ``rows`` (H, stride) uint8 under filter ``filters``
    (0-4), or under the one that libpng's default heuristic picks
    (``"adaptive"``: the least sum of the bytes' magnitudes as signed
    values); returns the (H, 1 + stride) filtered rows."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1),
                     x - _paeth(a, b, c)]) & 0xFF         # (5, H, stride)
    if filters == "adaptive":
        cost = np.minimum(cand, 256 - cand).sum(axis=2)    # (5, H)
        ftypes = cost.argmin(axis=0)
    else:
        ftypes = np.full(len(rows), int(filters))
    chosen = cand[ftypes, np.arange(len(rows))]
    return np.concatenate([ftypes[:, None], chosen], 1).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filters=0) -> None:
    """Write a uint8 or uint16 (H, W) or (H, W, 3|4) image; other dtypes
    are written as uint8.  ``filters``: the rows' filter type, 0 (none,
    the default) to 4 (Paeth), or ``"adaptive"``, libpng's choice row by
    row, as renderers that write through libpng do."""
    depth = 16 if img.dtype == np.uint16 else 8
    img = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).view(np.uint8)
    raw = _filter_rows(rows, ch * depth // 8, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2, 4: 6}[ch], 0,
                       0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
