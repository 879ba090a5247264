# A copy of gem_tpu/native/__init__.py (the port reads nothing under
# gem_tpu/), building its library beside the CUDA one instead of in place,
# with the re-stitch's first-fit schedule added.
"""ctypes bindings for the C++ runtime library (gem_native.cpp).

Builds `libgem_native_<hash>.so` with g++ at first use into
`build/gem_tpu_torch/` at the repository root, next to the CUDA library
that `kernels/_build.py` makes, never into the package directory; the name
carries a hash of the source and flags, so an edit rebuilds.  Every entry
point has a NumPy fallback so the framework works without a compiler
(`available()` reports which path is active).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from gem_tpu_torch.kernels._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "gem_native.cpp")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgem_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """g++ into a temporary name, then an atomic rename: processes that
    build at once each finish with a whole library."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
                        _SRC], check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_float
    lib.gem_voxel_filter.restype = ctypes.c_int
    lib.gem_voxel_filter.argtypes = [f32p, ctypes.c_void_p, ctypes.c_int,
                                     c, c, c, c, c, c, c,
                                     f32p, ctypes.c_void_p, ctypes.c_int]
    lib.gem_dedup_cells.restype = ctypes.c_int
    lib.gem_dedup_cells.argtypes = [f32p, f32p, f32p, ctypes.c_void_p,
                                    ctypes.c_int, c, i32p, ctypes.c_int]
    lib.gem_write_pcd.restype = ctypes.c_int
    lib.gem_write_pcd.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int,
                                  ctypes.c_int]
    lib.gem_read_pcd_info.restype = ctypes.c_int
    lib.gem_read_pcd_info.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.gem_read_pcd_data.restype = ctypes.c_int
    lib.gem_read_pcd_data.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int,
                                      ctypes.c_int]
    lib.gem_prefetcher_create.restype = ctypes.c_int
    lib.gem_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                          ctypes.c_int, ctypes.c_int]
    lib.gem_prefetcher_size.restype = ctypes.c_long
    lib.gem_prefetcher_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gem_prefetcher_copy.restype = ctypes.c_int
    lib.gem_prefetcher_copy.argtypes = [ctypes.c_int, ctypes.c_int, u8p,
                                        ctypes.c_long]
    lib.gem_prefetcher_destroy.restype = None
    lib.gem_prefetcher_destroy.argtypes = [ctypes.c_int]
    lib.gem_first_fit_rounds.restype = ctypes.c_int
    lib.gem_first_fit_rounds.argtypes = [i32p, ctypes.c_int, ctypes.c_int,
                                         i32p, i32p,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------


def voxel_filter(points, intensity=None, leaf=0.2,
                 crop=((-1e9, 1e9), (-1e9, 1e9), (-1e9, 1e9))):
    """Voxel-grid centroid downsample + crop (the reference's VoxelGrid
    pre-filter chain, filter_kitti.launch).  Returns (points, intensity)."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    inten = None if intensity is None else \
        np.ascontiguousarray(intensity, np.float32)
    lib = _load()
    (x0, x1), (y0, y1), (z0, z1) = crop
    if lib is not None:
        out = np.empty_like(pts)
        out_i = np.empty(n, np.float32)
        m = lib.gem_voxel_filter(
            pts, None if inten is None else inten.ctypes.data_as(ctypes.c_void_p),
            n, leaf, x0, x1, y0, y1, z0, z1, out,
            out_i.ctypes.data_as(ctypes.c_void_p), n)
        return out[:m], (None if inten is None else out_i[:m])
    # NumPy fallback
    inside = ((pts[:, 0] >= x0) & (pts[:, 0] <= x1)
              & (pts[:, 1] >= y0) & (pts[:, 1] <= y1)
              & (pts[:, 2] >= z0) & (pts[:, 2] <= z1)
              & ~np.isnan(pts).any(axis=1))
    pts = pts[inside]
    inten_f = None if inten is None else inten[inside]
    keys = np.floor(pts / leaf).astype(np.int64)
    _, first, inv, counts = np.unique(
        keys, axis=0, return_index=True, return_inverse=True,
        return_counts=True)
    sums = np.zeros((len(first), 3), np.float64)
    np.add.at(sums, inv, pts)
    out = (sums / counts[:, None]).astype(np.float32)
    if inten_f is None:
        return out, None
    isum = np.zeros(len(first), np.float64)
    np.add.at(isum, inv, inten_f)
    return out, (isum / counts).astype(np.float32)


def dedup_cells(x, y, variance, valid=None, resolution=0.1):
    """Indices of the min-variance record per quantized cell (the
    GridUtilHash replacement used at submap export)."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    var = np.ascontiguousarray(variance, np.float32)
    n = len(x)
    lib = _load()
    if lib is not None:
        v = None if valid is None else \
            np.ascontiguousarray(valid, np.uint8)
        kept = np.empty(n, np.int32)
        m = lib.gem_dedup_cells(
            x, y, var,
            None if v is None else v.ctypes.data_as(ctypes.c_void_p),
            n, resolution, kept, n)
        return np.sort(kept[:m])
    mask = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    qx = np.ceil(x / resolution).astype(np.int64)
    qy = np.ceil(y / resolution).astype(np.int64)
    key = qx * (2 ** 32) + qy
    order = np.lexsort((var, key))
    order = order[mask[order]]
    k_sorted = key[order]
    firsts = np.concatenate([[True], k_sorted[1:] != k_sorted[:-1]])
    return np.sort(order[firsts])


def first_fit_rounds(pairs):
    """The first-fit round schedule of `global_map/loop_closure.py`
    `schedule_rounds`: each pair ((n, 2) slots >= 0, in order) goes to the
    lowest round in which neither of its slots is used yet.  Returns (each
    pair's round (n,) int32, its lane, its place among the round's pairs
    (n,) int32, the number of rounds, the most pairs in one round)."""
    pairs = np.ascontiguousarray(pairs, np.int32).reshape(-1, 2)
    n = len(pairs)
    slots = int(pairs.max()) + 1 if n else 0
    lib = _load()
    if lib is not None:
        rnd = np.empty(n, np.int32)
        lane = np.empty(n, np.int32)
        n_rounds, max_lanes = ctypes.c_int(0), ctypes.c_int(0)
        if lib.gem_first_fit_rounds(pairs, n, slots, rnd, lane,
                                    ctypes.byref(n_rounds),
                                    ctypes.byref(max_lanes)) != 0:
            raise ValueError("first_fit_rounds: slots must be >= 0")
        return rnd, lane, n_rounds.value, max_lanes.value
    # Python fallback: one round bitmask per slot, a pair's round the
    # lowest bit clear in both of its slots' masks
    if n and pairs.min() < 0:
        raise ValueError("first_fit_rounds: slots must be >= 0")
    used = [0] * slots
    count: list = []      # pairs per round so far
    rnd, lane = [], []
    for i, j in pairs.tolist():
        m = used[i] | used[j]
        bit = ~m & (m + 1)
        used[i] |= bit
        used[j] |= bit
        r = bit.bit_length() - 1
        if r == len(count):
            count.append(0)
        rnd.append(r)
        lane.append(count[r])
        count[r] += 1
    return (np.asarray(rnd, np.int32), np.asarray(lane, np.int32),
            len(count), max(count, default=0))


class FramePrefetcher:
    """Background-thread file prefetcher (sequential access).

    Wraps the C++ ring-buffer loader; falls back to synchronous reads.
    Usage: `for i in range(len(pf)): data = pf[i]` — bytes of each file.
    """

    def __init__(self, paths, ring: int = 4):
        self.paths = [os.fspath(p) for p in paths]
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.gem_prefetcher_create(
                arr, len(self.paths), ring)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> bytes:
        if idx < 0 or idx >= len(self.paths):
            raise IndexError(idx)
        if self._handle is not None:
            size = self._lib.gem_prefetcher_size(self._handle, idx)
            if size == -2:
                # ring is forward-only; backward access falls back to a
                # direct read instead of deadlocking
                with open(self.paths[idx], "rb") as f:
                    return f.read()
            if size < 0:
                raise IndexError(idx)
            buf = np.empty(max(size, 1), np.uint8)
            got = self._lib.gem_prefetcher_copy(self._handle, idx, buf, size)
            if got != size:
                raise IOError(f"prefetch copy failed ({got})")
            return buf[:size].tobytes()
        with open(self.paths[idx], "rb") as f:
            return f.read()

    def close(self):
        if self._handle is not None:
            self._lib.gem_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
