"""Minimal OpenEXR scanline reader and writer (port of
``nrhints_tpu/data/exr.py``, numpy + zlib).

The subset of OpenEXR 2.0 that point-light captures and Blender renders
use: single-part scanline images (no tiles, deep data or multi-part),
compression NONE (0), ZIPS (2, one line a chunk) and ZIP (3, 16 lines a
chunk), whose zlib deflate runs over a byte interleave and a delta
predictor, and channel types HALF (1), FLOAT (2) and UINT (0) at xy
sampling 1.  Anything else raises with the reason.  The writer lets tests
round-trip the reader and lets users convert a dataset.
"""
from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_COMPRESSION_NAMES = {
    0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
    5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB",
}


def _read_cstring(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> list:
    """chlist attribute -> [(name, pixel_type, x_sampling, y_sampling)]."""
    chans = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_cstring(data, pos)
        ptype, xs, ys = struct.unpack_from("<i4xii", data, pos)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def _zip_reconstruct(raw: bytes) -> np.ndarray:
    """Undo the EXR ZIP predictor + byte interleave (ImfZip decompress)."""
    t = np.frombuffer(raw, np.uint8).astype(np.int64)
    # Delta predictor: t[i] += t[i-1] - 128 (running, i.e. cumulative).
    if t.size > 1:
        t[1:] -= 128
        t = np.cumsum(t) % 256
    # Interleave: first half -> even output bytes, second half -> odd.
    n = t.size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _zip_deconstruct(raw: np.ndarray) -> bytes:
    """EXR ZIP pre-pass for compression (ImfZip compress)."""
    n = raw.size
    half = (n + 1) // 2
    tmp = np.empty(n, np.int64)
    tmp[:half] = raw[0::2]
    tmp[half:] = raw[1::2]
    if n > 1:
        tmp[1:] = (tmp[1:] - tmp[:-1] + 128) % 256
    return tmp.astype(np.uint8).tobytes()


def read_exr(path) -> np.ndarray:
    """Read an EXR image -> float32 [H, W, C] (C from the channel list;
    R,G,B[,A] are reordered to RGB[A], other layouts keep file order)."""
    buf = pathlib.Path(path).read_bytes()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file (bad magic {magic:#x})")
    if version & 0x200:
        raise NotImplementedError(f"{path}: tiled EXR is not supported")
    if version & (0x800 | 0x1000):
        raise NotImplementedError(f"{path}: deep/multi-part EXR not supported")

    # --- header attributes -------------------------------------------------
    pos = 8
    attrs: Dict[str, bytes] = {}
    while True:
        if buf[pos] == 0:  # empty attribute name terminates the header
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        _atype, pos = _read_cstring(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = buf[pos : pos + size]
        pos += size

    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"])
    W, H = xmax - xmin + 1, ymax - ymin + 1

    if compression not in _LINES_PER_CHUNK:
        raise NotImplementedError(
            f"{path}: EXR compression "
            f"{_COMPRESSION_NAMES.get(compression, compression)} not supported "
            "(NONE/ZIPS/ZIP only); re-export or convert to .npy"
        )
    for name, ptype, xs, ys in channels:
        if ptype not in _PIXEL_DTYPES:
            raise NotImplementedError(f"{path}: channel {name} pixel type {ptype}")
        if (xs, ys) != (1, 1):
            raise NotImplementedError(f"{path}: subsampled channel {name}")

    lines_per_chunk = _LINES_PER_CHUNK[compression]
    n_chunks = -(-H // lines_per_chunk)
    pos += 8 * n_chunks  # line-offset table (chunks follow in order anyway)

    ch_dtypes = [_PIXEL_DTYPES[p] for _, p, _, _ in channels]
    ch_sizes = [dt.itemsize for dt in ch_dtypes]
    per_line = W * sum(ch_sizes)

    planes = {name: np.empty((H, W), np.float32) for name, _, _, _ in channels}
    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        data = buf[pos : pos + size]
        pos += size
        row0 = y - ymin
        nlines = min(lines_per_chunk, H - row0)
        expect = per_line * nlines
        if compression and size < expect:
            data = _zip_reconstruct(zlib.decompress(data)).tobytes()
        if len(data) != expect:
            raise ValueError(
                f"{path}: chunk at y={y} has {len(data)} bytes, expected {expect}"
            )
        rows = np.frombuffer(data, np.uint8).reshape(nlines, per_line)
        off = 0
        for (name, _, _, _), dt, cs in zip(channels, ch_dtypes, ch_sizes):
            block = np.ascontiguousarray(rows[:, off : off + W * cs])
            planes[name][row0 : row0 + nlines] = (
                block.view(dt).reshape(nlines, W).astype(np.float32)
            )
            off += W * cs

    names = [c[0] for c in channels]
    if set(names) >= {"R", "G", "B"}:
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:  # grayscale / arbitrary layouts: keep file (alphabetical) order
        order = names
    return np.stack([planes[n] for n in order], axis=-1)


def write_exr(path, img: np.ndarray, compression: str = "zip",
              pixel_type: str = "half") -> None:
    """Write [H, W, 1|3|4] float data as a scanline EXR.

    ``compression``: "none" | "zips" | "zip"; ``pixel_type``: "half" |
    "float".  Channel naming: 1->Y, 3->RGB, 4->RGBA (stored alphabetically
    as the format requires)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}.get(C)
    if names is None:
        raise ValueError(f"unsupported channel count {C}")
    comp = {"none": 0, "zips": 2, "zip": 3}[compression]
    ptype, dt = {"half": (1, np.dtype("<f2")), "float": (2, np.dtype("<f4"))}[
        pixel_type
    ]

    sorted_idx = sorted(range(C), key=lambda i: names[i])
    chlist = b""
    for i in sorted_idx:
        chlist += names[i].encode() + b"\x00" + struct.pack("<i4xii", ptype, 1, 1)
    chlist += b"\x00"

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data
        )

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = struct.pack("<ii", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([comp]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_chunk = _LINES_PER_CHUNK[comp]
    n_chunks = -(-H // lines_per_chunk)
    chunks = []
    for c in range(n_chunks):
        row0 = c * lines_per_chunk
        nlines = min(lines_per_chunk, H - row0)
        rows = []
        for r in range(row0, row0 + nlines):
            for i in sorted_idx:
                rows.append(np.ascontiguousarray(img[r, :, i]).astype(dt).tobytes())
        raw = b"".join(rows)
        data = raw
        if comp:
            packed = zlib.compress(
                _zip_deconstruct(np.frombuffer(raw, np.uint8)), 6
            )
            if len(packed) < len(raw):  # spec: store raw when zip doesn't help
                data = packed
        chunks.append(struct.pack("<ii", row0, len(data)) + data)

    offset = len(header) + 8 * n_chunks
    table = b""
    for ch in chunks:
        table += struct.pack("<Q", offset)
        offset += len(ch)
    pathlib.Path(path).write_bytes(header + table + b"".join(chunks))
