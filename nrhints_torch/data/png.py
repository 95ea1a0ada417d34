"""Minimal PNG reader and writer (numpy + zlib), for machines without an
image library.

The reader takes 8-bit, non-interlaced images of colour types gray (0),
RGB (2), gray + alpha (4) and RGBA (6), with the five row filters of the
format (None, Sub, Up, Average, Paeth).  Anything else raises with the
reason.  The writer stores 8-bit gray, RGB or RGBA rows
under filter None.  ``data/parser.py`` reads every PNG of a scene with this
reader, and the port writes every PNG it makes with this writer.
"""
from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _sheared(S: np.ndarray) -> np.ndarray:
    """The [H, W, bpp] view of a sheared [H + W + 1, H + 1, bpp] array in
    which pixel (y, x) is ``S[y + x + 1, y + 1]``."""
    n, h1, bpp = S.shape
    s0, s1, s2 = S.strides
    return np.lib.stride_tricks.as_strided(S[1:, 1:], shape=(h1 - 1, n - h1, bpp), strides=(s0 + s1, s0, s2))


def _unfilter(filters: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of an image -> its bytes, uint8 [H, W * bpp].

    ``filters`` [H] holds each row's filter type, ``data`` [H, W * bpp] its
    filtered bytes.  A byte's prediction reads the pixel to its left (a),
    above (b) and above-left (c), all already undone, so the pixels of one
    anti-diagonal (y + x = d) depend only on the two diagonals before it.
    The image is sheared so that diagonal d is row d + 1 of ``S``
    (``S[y + x + 1, y + 1]`` = pixel (y, x); row 0 and column 0, and every
    cell off the image, stay 0 as the format's borders do), and each step
    undoes one whole diagonal with numpy: H + W - 1 steps an image."""
    H, W = data.shape[0], data.shape[1] // bpp
    S = np.zeros((H + W + 1, H + 1, bpp), np.int16)
    raw = np.zeros_like(S)
    _sheared(raw)[...] = data.reshape(H, W, bpp)
    masks = [(filters == k).astype(np.int16)[:, None] for k in range(5)]
    counts = [np.concatenate([[0], np.cumsum(m[:, 0])]) for m in masks]
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        a, b, c = S[d, lo + 1:hi + 1], S[d, lo:hi], S[max(d - 1, 0), lo:hi]
        pred = np.zeros_like(a)
        if counts[1][hi] > counts[1][lo]:
            pred += masks[1][lo:hi] * a
        if counts[2][hi] > counts[2][lo]:
            pred += masks[2][lo:hi] * b
        if counts[3][hi] > counts[3][lo]:
            pred += masks[3][lo:hi] * ((a + b) >> 1)
        if counts[4][hi] > counts[4][lo]:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred += masks[4][lo:hi] * np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred += raw[d + 1, lo + 1:hi + 1]
        np.bitwise_and(pred, 0xFF, out=S[d + 1, lo + 1:hi + 1])
    return _sheared(S).astype(np.uint8).reshape(H, W * bpp)


def read_png(path) -> np.ndarray:
    """Read a PNG -> uint8 [H, W] (gray) or [H, W, C] (C = 2, 3 or 4)."""
    buf = pathlib.Path(path).read_bytes()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        ctype = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise NotImplementedError(f"{path}: PNG of bit depth {depth}, colour type {color} (8-bit gray, RGB, "
                                  "gray-alpha and RGBA only)")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    bpp = _CHANNELS[color]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {H * (stride + 1)}")
    raw = raw.reshape(H, stride + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {raw[:, 0].max()} is not one of 0-4")
    img = _unfilter(raw[:, 0], raw[:, 1:], bpp)
    return img if bpp == 1 else img.reshape(H, W, bpp)


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, 1|3|4] as an 8-bit PNG, every row under
    filter None."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    color = 0 if img.ndim == 2 else {3: 2, 4: 6}.get(img.shape[-1]) if img.ndim == 3 else None
    if color is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1|3|4], got {img.shape}")
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], axis=1)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    pathlib.Path(path).write_bytes(
        _SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )
