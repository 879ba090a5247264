# A copy of gem_tpu/io/pcd.py (the port reads nothing under gem_tpu/).
"""PCD point-cloud export, parity with the reference's savePCDFile products.

The reference dumps the accumulated visual cloud / per-submap clouds with
pcl::io::savePCDFile (src/ElevationMapping.cpp:430-476).  Fields follow the
live `Anypoint` layout (PointXYZRGBICT.hpp:26-58): xyz + packed rgb +
intensity + covariance + travers.  Binary and ASCII writers; a tiny reader
for round-trip tests.  (A C++ fast path lives in native/, used when built.)
"""

from __future__ import annotations

import numpy as np

_FIELDS = ("x", "y", "z", "rgb", "intensity", "covariance", "travers")


def _header(n: int, binary: bool) -> str:
    return "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS x y z rgb intensity covariance travers",
        "SIZE 4 4 4 4 4 4 4",
        "TYPE F F F F F F F",
        "COUNT 1 1 1 1 1 1 1",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
        "",
    ])


def save_pcd(path: str, x, y, z, color_packed, intensity, variance, traver,
             valid=None, binary: bool = True):
    """Write a compacted PCD; `color_packed` is int32 0xRRGGBB (PCL packs rgb
    as a float-bitcast the same way)."""
    arrs = [np.asarray(a).reshape(-1) for a in
            (x, y, z, color_packed, intensity, variance, traver)]
    if valid is not None:
        m = np.asarray(valid).reshape(-1)
        arrs = [a[m] for a in arrs]
    n = len(arrs[0])
    rgb_f = np.asarray(arrs[3], np.uint32).view(np.float32)
    data = np.stack([arrs[0], arrs[1], arrs[2], rgb_f,
                     arrs[4], arrs[5], arrs[6]], axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(_header(n, binary).encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
    return n


def load_pcd(path: str) -> dict:
    """Minimal reader for the files save_pcd writes (round-trip tests)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode()
            header.append(line.strip())
            if line.startswith("DATA"):
                break
        meta = {k: v for k, *v in (h.split() for h in header if h)}
        n = int(meta["POINTS"][0])
        binary = meta["DATA"][0] == "binary"
        fields = meta["FIELDS"]
        if binary:
            data = np.frombuffer(f.read(n * len(fields) * 4),
                                 np.float32).reshape(n, len(fields))
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, len(fields))
    out = {name: data[:, i].copy() for i, name in enumerate(fields)}
    if "rgb" in out:
        out["rgb"] = out["rgb"].view(np.uint32).astype(np.int32)
    return out
