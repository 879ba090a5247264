# A copy of gem_tpu/utils/image.py (the port reads nothing under gem_tpu/).
"""Dependency-free image writers for orthomosaic export.

The reference publishes/saves per-keyframe orthomosaic images through
cv_bridge (ElevationMap.cpp:130-132, orthomosaic_saving_dir).  Here: a PNG
encoder on stdlib zlib, plus PPM for quick dumps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray):
    """rgb: (H, W, 3) uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal reader for files write_png produced (round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = 0
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = 1 + w * 3
    rows = [np.frombuffer(raw[i * stride + 1:(i + 1) * stride], np.uint8)
            for i in range(h)]
    return np.stack(rows).reshape(h, w, 3)


def write_ppm(path: str, rgb: np.ndarray):
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())
