"""PNG export without a canvas.

Counterpart of ``blackhole_simulation_tpu/app/screenshot.py``: a PNG
writer with no dependencies (zlib-compressed 8-bit RGB or RGBA) and a
reader for the files it writes. Input is a host array, (H, W, 3|4) float
in [0, 1] or uint8; callers move a tensor off the device
(``.cpu().numpy()``) before they write it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img) -> bytes:
    """(H, W, 3|4) float [0,1] or uint8 -> PNG bytes."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    if arr.dtype != np.uint8:
        arr = (np.clip(arr.astype(np.float64), 0.0, 1.0) * 255.0 + 0.5).astype(
            np.uint8
        )
    h, w, c = arr.shape
    color_type = 2 if c == 3 else 6

    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def save_png(img, path: str) -> str:
    """Write the image to ``path``; returns the path."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def load_png_rgb(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests: handles only the files this
    module writes (8-bit RGB/RGBA, filter 0, one IDAT)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat = 8, b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert depth == 8, "only 8-bit supported"
            c = {2: 3, 6: 4}[color]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    for y in range(h):
        line = raw[y * stride : (y + 1) * stride]
        assert line[0] == 0, "only filter 0 supported"
        rows.append(np.frombuffer(line[1:], np.uint8).reshape(w, c))
    return np.stack(rows)
