"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each of `gem_tpu_torch/csrc/*.cu` compiles to an object, one nvcc per
source, all started together; the objects link into ONE shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC --fmad=false -c <source>
    nvcc -shared <objects>

`--fmad=false` keeps every a*b+c a rounded product plus a rounded sum, as
in the plain PyTorch versions: the plane-fit epilogue picks its eigenvector
by float equality and `acos` near 1 amplifies one ULP of its argument to
~3e-4 rad of slope.  No `--use_fast_math` (it would swap in approximate
division, sqrt and acos).

The library lands in `build/gem_tpu_torch/` at the repository root, named
by a hash of the sources and flags, and is built at first use: nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gem_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C entry points: (argtypes); each returns cudaGetLastError() as an int
_SIGNATURES = {
    # ids, ids are int64, sum_vals, min_vals, max_vals, sums, mins, maxs,
    # n (points per robot), num_segments, robots, n_sum, n_min, n_max,
    # stream, kernels launched (out)
    "gem_segment_stats_sorted": (_P, _I, _P, _P, _P, _P, _P, _P, _L, _I,
                                 _I, _I, _I, _I, _P, ctypes.POINTER(_I)),
    # offsets, h, v, inten, colf, elev0, var0, out, ncell, robots,
    # invalid_elevation, min_variance, mahalanobis_threshold,
    # with_lowest, with_color, stream
    "gem_fuse_stream_aggregate": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _F, _F, _F, _I, _I, _P),
    # elevation, start, slope, rough, traver, normal_z, count, L, robots,
    # offset table (host float[40]), invalid_elevation,
    # invalid_traversability, 1/slope_critical, 1/rough_critical,
    # feature_min_neighbors, stream
    "gem_plane_fit_features": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _F,
                               _F, _F, _F, _F, _P),
    # the conditional nodes of utils/control.py (csrc/graph_cond.cu):
    # stream (out)
    "gem_graph_stream_create": (ctypes.POINTER(_P),),
    # capturing stream, device bool, negate, body stream
    "gem_graph_if_begin": (_P, _P, _I, _P),
    # body stream, the body's kernel/copy/fill nodes (out)
    "gem_graph_if_end": (_P, ctypes.POINTER(_L)),
    # cudaGraph_t, nodes, conditional nodes, kernel/copy/fill nodes (out)
    "gem_graph_count_nodes": (_P, ctypes.POINTER(_L), ctypes.POINTER(_L),
                              ctypes.POINTER(_L)),
    # the tracer's stamp (utils/observability.py): stream, ring (int64),
    # row counter (int64), rows, columns, column, advance
    "gem_trace_stamp": (_P, _P, _P, _L, _I, _I, _I),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libgem_tpu_torch_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the library if this source hash is not built yet.
    Returns (path, seconds spent compiling; 0.0 when already built)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out[:-3]}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tag}.{os.path.basename(src)[:-3]}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            for _, other in jobs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{obj}:\n{log}")
    tmp = f"{tag}.so.tmp"
    proc = subprocess.run([nvcc, "-shared", "-o", tmp,
                           *(obj for obj, _ in jobs)],
                          capture_output=True, text=True)
    for obj, _ in jobs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's types declared."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_tensors(name, tensors, dtypes) -> None:
    """Raise unless every tensor is contiguous, of its dtype, and on the
    first one's device: what a kernel's raw pointers assume."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} tensors on "
                             f"{dev}, got {t.dtype} on {t.device}")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
