// K1: per-cell aggregate rows of the streaming fuse.
//
// Replaces gem_tpu/kernels/fuse_stream.py::_kernel_fact (the Pallas TPU
// kernel behind `fuse_stream`, GEM_FUSE_PASSA=fact) and computes the same
// 16-row contract documented in gem_tpu_torch/kernels/fuse_stream.py.
//
// What bounds it on the card: memory.  Per frame it reads each sorted point
// once (h, v and, with color, intensity and packed color: 8-16 bytes) and
// each cell's prior and run offset (16 bytes), and writes 64 bytes per cell;
// at the L=1000 flagship that is ~66 MB of output against ~2-4 MB of
// points, so the 16-row store dominates.  There is no arithmetic worth
// counting.
//
// Design: the TPU kernel built one-hot matrices because the TPU has no
// scatter; on the GPU each cell owns the contiguous run of its points in the
// (cell, -h) sorted stream, so ONE THREAD PER CELL walks its run in sorted
// order and keeps every statistic in registers: no atomics, no shared
// memory, deterministic sums in sorted order.  The start row (the run's
// first point) gives the anchor before the walk, so the gate, the gated
// sums, the colored-inlier argmin and the outlier payload all come out of a
// single pass.  Output rows are stored stat-major, (16, ncell), so the
// stores of a warp are coalesced.  Load imbalance (a dense cell serializes
// its thread) is the known cost of this first, simple version.
//
// Packed RGB travels as float32, exact below 2^24; it is never narrowed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStats = 16;
constexpr int kBlock = 256;

__device__ __forceinline__ bool has_color(float colf, float inten) {
  const int c = static_cast<int>(colf);
  return (((c >> 16) & 0xFF) * ((c >> 8) & 0xFF) * (c & 0xFF)) != 0 &&
         inten != 0.0f;
}

__global__ void fuse_stream_aggregate_kernel(
    const int64_t* __restrict__ offsets, const float* __restrict__ h,
    const float* __restrict__ v, const float* __restrict__ inten,
    const float* __restrict__ colf, const float* __restrict__ elev0,
    const float* __restrict__ var0, float* __restrict__ out, int ncell,
    float invalid_elevation, float min_variance, float mahalanobis,
    int with_lowest, int with_color) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int64_t lo = offsets[c];
  const int64_t hi = offsets[c + 1];

  float st_h = 0.f, st_v = 0.f, st_n = 0.f, W = 0.f, WH = 0.f, st_out = 0.f;
  float oc_n = 0.f, oc_v = 0.f, oc_c = 0.f, oc_i = 0.f, low = 0.f;
  float vc = INFINITY, col_min = INFINITY, int_min = INFINITY;

  if (hi > lo) {
    st_h = h[lo];
    st_v = v[lo];
    st_n = 1.f;
    const float e0 = elev0[c];
    const bool empty = e0 == invalid_elevation;
    const float anchor_e = empty ? st_h : e0;
    const float anchor_v =
        empty ? fmaxf(st_v, min_variance) : fmaxf(var0[c], min_variance);
    const float band = mahalanobis * sqrtf(anchor_v);
    for (int64_t i = lo; i < hi; ++i) {
      const float hp = h[i];
      const float vp = v[i];
      const bool inl = fabsf(hp - anchor_e) <= band;
      if (inl) {
        const float w = 1.0f / fmaxf(vp, 1e-9f);
        W += w;
        WH += w * hp;
      }
      if (with_color) {
        const float cp = colf[i];
        const float ip = inten[i];
        const bool hc = has_color(cp, ip);
        if (i == lo && !inl && hc) {
          oc_n = 1.f;
          oc_v = vp;
          oc_c = cp;
          oc_i = ip;
        }
        if (inl && hc) {
          // min v; at an exact v tie, color and intensity are each min'd
          // on their own (the JAX kernel's tie-set semantics)
          if (vp < vc) {
            vc = vp;
            col_min = cp;
            int_min = ip;
          } else if (vp == vc) {
            col_min = fminf(col_min, cp);
            int_min = fminf(int_min, ip);
          }
        }
      }
      if (i == lo && !inl) st_out = 1.f;
    }
    if (with_lowest) low = h[hi - 1] + 3.0f * v[hi - 1];
  }

  const float rows[kStats] = {st_h, st_v,  st_n, 0.f,  W,       WH,
                              st_out, oc_n, oc_v, oc_c, oc_i,   low,
                              vc,   col_min, int_min, INFINITY};
#pragma unroll
  for (int k = 0; k < kStats; ++k) out[static_cast<int64_t>(k) * ncell + c] = rows[k];
}

}  // namespace

extern "C" int gem_fuse_stream_aggregate(
    const void* offsets, const void* h, const void* v, const void* inten,
    const void* colf, const void* elev0, const void* var0, void* out,
    int ncell, float invalid_elevation, float min_variance,
    float mahalanobis, int with_lowest, int with_color, void* stream) {
  if (ncell > 0) {
    const int grid = (ncell + kBlock - 1) / kBlock;
    fuse_stream_aggregate_kernel<<<grid, kBlock, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offsets), static_cast<const float*>(h),
        static_cast<const float*>(v), static_cast<const float*>(inten),
        static_cast<const float*>(colf), static_cast<const float*>(elev0),
        static_cast<const float*>(var0), static_cast<float*>(out), ncell,
        invalid_elevation, min_variance, mahalanobis, with_lowest,
        with_color);
  }
  return static_cast<int>(cudaGetLastError());
}
