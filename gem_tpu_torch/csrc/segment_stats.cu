// K3: per-segment sums, mins and maxs over pre-sorted segment ids.
//
// Replaces gem_tpu/kernels/pallas_scatter.py::_kernel (the Pallas TPU
// kernel behind `pallas_segment_stats` / `segment_stats_sorted`, reached
// through `fuse(backend="pallas")`).  For every segment c it computes
//
//   sums[f, c] = sum of sum_vals[f, i] over the points i of segment c
//   mins[f, c] = min of min_vals[f, i]   (+inf when c has no point)
//   maxs[f, c] = max of max_vals[f, i]   (-inf when c has no point)
//
// Inputs are column-major (F, N) float32 in the order of the sorted ids;
// pad lanes hold num_segments and are dropped.  The wrapper
// (gem_tpu_torch/kernels/segment_stats.py) passes the per-segment run
// offsets, offsets[c] = first sorted position with id >= c, from
// torch.searchsorted over the sorted ids.
//
// What bounds it on the card: memory.  Each point's F values are read
// once and each segment's F outputs written once; at the L=1000 flagship
// the (F, 10^6) outputs (4 MB per column) outweigh a 131072-point frame's
// inputs, and there is no arithmetic worth counting.
//
// Design: the TPU kernel turned the scatter into a one-hot MXU matmul over
// a window of cells, because the TPU has no scatter atomics, and carried
// partial windows from one sequential grid step to the next.  On the GPU
// each segment owns a contiguous run of the sorted stream, so ONE THREAD
// PER SEGMENT walks its run: no window (so no spill and no fallback), no
// atomics, no shared memory, and sums in sorted order, deterministic from
// run to run.  Stores are stat-major, (F, S), so a warp's stores coalesce.
// Load imbalance (a dense segment serializes its thread) is the known
// cost of this first, simple version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void segment_stats_kernel(
    const int64_t* __restrict__ offsets, const float* __restrict__ sum_vals,
    const float* __restrict__ min_vals, const float* __restrict__ max_vals,
    float* __restrict__ sums, float* __restrict__ mins,
    float* __restrict__ maxs, int64_t n, int num_segments, int n_sum,
    int n_min, int n_max) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_segments) return;
  const int64_t lo = offsets[c];
  const int64_t hi = offsets[c + 1];
  const int64_t s = num_segments;

  for (int f = 0; f < n_sum; ++f) {
    const float* col = sum_vals + f * n;
    float acc = 0.f;
    for (int64_t i = lo; i < hi; ++i) acc += col[i];
    sums[f * s + c] = acc;
  }
  for (int f = 0; f < n_min; ++f) {
    const float* col = min_vals + f * n;
    float acc = INFINITY;
    for (int64_t i = lo; i < hi; ++i) acc = fminf(acc, col[i]);
    mins[f * s + c] = acc;
  }
  for (int f = 0; f < n_max; ++f) {
    const float* col = max_vals + f * n;
    float acc = -INFINITY;
    for (int64_t i = lo; i < hi; ++i) acc = fmaxf(acc, col[i]);
    maxs[f * s + c] = acc;
  }
}

}  // namespace

extern "C" int gem_segment_stats_sorted(
    const void* offsets, const void* sum_vals, const void* min_vals,
    const void* max_vals, void* sums, void* mins, void* maxs, int64_t n,
    int num_segments, int n_sum, int n_min, int n_max, void* stream) {
  if (num_segments > 0) {
    const int grid = (num_segments + kBlock - 1) / kBlock;
    segment_stats_kernel<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offsets),
        static_cast<const float*>(sum_vals),
        static_cast<const float*>(min_vals),
        static_cast<const float*>(max_vals), static_cast<float*>(sums),
        static_cast<float*>(mins), static_cast<float*>(maxs), n,
        num_segments, n_sum, n_min, n_max);
  }
  return static_cast<int>(cudaGetLastError());
}
