// K3: per-segment sums, mins and maxs over pre-sorted segment ids.
//
// Replaces gem_tpu/kernels/pallas_scatter.py::_kernel (the Pallas TPU
// kernel behind `pallas_segment_stats` / `segment_stats_sorted`, reached
// through `fuse(backend="pallas")`).  For every segment c < S it computes
//
//   sums[f, c] = sum of sum_vals[f, i] over the points i of segment c
//   mins[f, c] = min of min_vals[f, i]   (+inf when c has no point)
//   maxs[f, c] = max of max_vals[f, i]   (-inf when c has no point)
//
// Inputs are (F, N) float32 columns in the order of the sorted ids (int32 or
// int64); pad lanes hold ids >= S and are dropped.  F may be 0 for a role.
//
// What bounds it on the card: memory.  Each point's F values and id are
// read once and each segment's F outputs written once; at the L=1000
// flagship the (F, 10^6) outputs (4 MB per column) outweigh a 131072-point
// frame's inputs, and there is no arithmetic worth counting.
//
// Design: the TPU kernel turned the scatter into a one-hot MXU matmul over
// a window of cells, because the TPU has no scatter atomics.  Here every
// block OWNS a range of kBlockSegs consecutive segments, and so every run of
// sorted points whose id lies there: a run never crosses an owner, no
// atomics are needed, and each run is reduced in one fixed order, so the
// results are the same from run to run.
//  * No offsets array: two warps find the block's first and last point with
//    a 32-way search over the sorted ids (four rounds of one load per lane
//    at 10^6 points), where the first version searched once per segment.
//  * One pass for up to kMaxCols columns of any kinds (a call of
//    `fuse_pallas` has one to three): the ids are read and scanned once,
//    and the block's barriers are paid once.
//  * Point-parallel: the block's points are cut into kWarps equal parts by
//    position, so a dense range (the cells next to the sensor) is shared by
//    all its warps.  A warp walks its part 256 points at a time, 8
//    consecutive ones per lane; each lane finds run heads by comparing each
//    id with the one before and folds its runs, and a segmented shuffle
//    scan joins the runs that cross lanes; the lane where a run ends folds
//    it into the block's accumulator rows in shared memory.  A run that
//    crosses into a later warp's part is owned by the warp where it starts;
//    the later warp reduces its share apart and one thread of the block
//    folds these carries in warp order.
//  * Every output written once: the accumulator rows start at the identity
//    (0, +inf, -inf), so empty segments need no separate fill; the block
//    stores its rows with coalesced stores.  Outputs are stat-major, (F, S).
//  * Owners are bound to segment ranges, not to tiles of points, so the
//    writes of long empty stretches (the ~10^5-cell gaps before the first
//    and after the last occupied cell of a frame) spread over the grid
//    instead of falling to the tile that holds the run after the gap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockSegs = 2048;  // segments owned by one block
constexpr int kWarps = 8;         // warps per block
constexpr int kItems = 8;         // consecutive points per lane and step
constexpr int kMaxCols = 4;       // columns reduced in one pass
constexpr unsigned kAll = 0xffffffffu;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

// the columns of one pass: source (N,) and result (S,) rows, and the kind
// of reduction of each
struct Columns {
  const float* src[kMaxCols];
  float* dst[kMaxCols];
  int kind[kMaxCols];
};

__device__ __forceinline__ long long min64(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float identity(int kind) {
  return kind == kSum ? 0.0f : (kind == kMin ? INFINITY : -INFINITY);
}

__device__ __forceinline__ float combine(int kind, float a, float b) {
  return kind == kSum ? a + b : (kind == kMin ? fminf(a, b) : fmaxf(a, b));
}

// First position i in [0, n) with ids[i] >= x (n if none), found by the
// whole warp: each round, 32 lanes probe 32 points that cut the interval
// into 33 parts, and the interval shrinks to the part holding the answer.
template <typename Id>
__device__ long long lower_bound_warp(const Id* __restrict__ ids,
                                      long long n, long long x, int lane) {
  long long lo = 0, hi = n;   // ids[lo - 1] < x <= ids[hi]
  while (lo < hi) {
    const long long len = hi - lo;
    const long long p = lo + len * (lane + 1) / 33;   // lo <= p < hi
    const unsigned ge =
        __ballot_sync(kAll, static_cast<long long>(ids[p]) >= x);
    if (ge == 0) {
      lo = __shfl_sync(kAll, p, 31) + 1;
    } else {
      const int f = __ffs(ge) - 1;
      hi = __shfl_sync(kAll, p, f);
      if (f > 0) lo = __shfl_sync(kAll, p, f - 1) + 1;
    }
  }
  return lo;
}

// The pass's columns over a warp's points [a, b), whose ids lie in [seg0,
// seg0 + kBlockSegs), into the block's accumulator rows acc[c].  Points at
// the start whose id is `skip` belong to a run that began in an earlier
// warp's part: they are reduced apart into carry[c] (the identity if there
// is none) for the block to fold in order.
// The warp takes 32 * kItems points a step, kItems consecutive ones per
// lane.  A lane folds its items run by run: a run that starts and ends among
// them is complete and goes to `acc` at once; its first and last runs may
// continue into the lanes beside it.  A segmented shuffle scan over the
// lanes' last runs then carries each run's partial to the lane where it
// ends, which folds it into `acc` (combined with what earlier steps left
// there, for a run that crosses steps).
template <int C, typename Id>
__device__ __forceinline__ void reduce_part(
    const Id* __restrict__ ids, const Columns& cols, long long a,
    long long b, long long seg0, int skip, float (*acc)[kBlockSegs],
    float (&carry)[C], int lane) {
  int kind[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kind[c] = cols.kind[c];
    carry[c] = identity(kind[c]);
  }
  for (long long base = a; base < b; base += 32 * kItems) {
    const long long i0 = base + static_cast<long long>(lane) * kItems;
    int first_id = -1, last_id = -1;
    float first_v[C], last_v[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      first_v[c] = last_v[c] = identity(kind[c]);
    bool several = false;   // more than one run among the lane's items
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k;
      if (i < b) {
        const int id = static_cast<int>(ids[i] - seg0);
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = cols.src[c][i];
        if (id == skip) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            carry[c] = combine(kind[c], carry[c], v[c]);
        } else if (last_id < 0) {
          first_id = last_id = id;
#pragma unroll
          for (int c = 0; c < C; ++c) last_v[c] = v[c];
        } else if (id == last_id) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            last_v[c] = combine(kind[c], last_v[c], v[c]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (several)   // started and ended here: complete
              acc[c][last_id] = combine(kind[c], acc[c][last_id], last_v[c]);
            else
              first_v[c] = last_v[c];
            last_v[c] = v[c];
          }
          several = true;
          last_id = id;
        }
      }
    }
    if (!several) {
#pragma unroll
      for (int c = 0; c < C; ++c) first_v[c] = last_v[c];
    }
    // segmented inclusive scan of the lanes' last runs: ids are sorted, so a
    // lane `off` to the left whose last run has the same id is joined to
    // this one by lanes that hold nothing else
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int oid = __shfl_up_sync(kAll, last_id, off);
      const bool join = lane >= off && oid == last_id;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float o = __shfl_up_sync(kAll, last_v[c], off);
        if (join) last_v[c] = combine(kind[c], o, last_v[c]);
      }
    }
    const int prev_id = __shfl_up_sync(kAll, last_id, 1);
    const int next_first = __shfl_down_sync(kAll, first_id, 1);
    const bool head = several && lane > 0 && prev_id == first_id;
    const bool tail = last_id >= 0 && (lane == 31 || next_first != last_id);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float prev_v = __shfl_up_sync(kAll, last_v[c], 1);
      // the first run ends here, after what the lanes before carry
      if (several)
        acc[c][first_id] = combine(
            kind[c], acc[c][first_id],
            head ? combine(kind[c], prev_v, first_v[c]) : first_v[c]);
      if (tail)
        acc[c][last_id] = combine(kind[c], acc[c][last_id], last_v[c]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      carry[c] = combine(kind[c], carry[c],
                         __shfl_down_sync(kAll, carry[c], off));
  }
}

template <int C, typename Id>
__global__ void __launch_bounds__(kWarps * 32)
segment_stats_kernel(const Id* __restrict__ ids, int64_t n, int num_segments,
                     const Columns cols) {
  __shared__ long long bounds[2];
  __shared__ float acc[C][kBlockSegs];
  __shared__ float carry_v[C][kWarps];
  __shared__ int carry_id[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long s = num_segments;
  const long long seg0 = static_cast<long long>(blockIdx.x) * kBlockSegs;
  const long long seg1 = min64(seg0 + kBlockSegs, s);
  const int nseg = static_cast<int>(seg1 - seg0);
  if (warp < 2) {
    const long long b = lower_bound_warp(ids, n, warp == 0 ? seg0 : seg1,
                                         lane);
    if (lane == 0) bounds[warp] = b;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float init = identity(cols.kind[c]);
    for (int k = threadIdx.x; k < nseg; k += blockDim.x) acc[c][k] = init;
  }
  __syncthreads();
  // the block's points, cut into kWarps equal parts by position
  const long long a = bounds[0], len = bounds[1] - bounds[0];
  const long long wa = a + len * warp / kWarps;
  const long long wb = a + len * (warp + 1) / kWarps;
  // the id of the point before the part, if the block holds it: a run that
  // began there is an earlier warp's
  const int skip = (wa > a && wa < wb)
                       ? static_cast<int>(ids[wa - 1] - seg0) : -1;
  float carry[C];
  reduce_part<C>(ids, cols, wa, wb, seg0, skip, acc, carry, lane);
  if (lane == 0) {
    carry_id[warp] = skip;
#pragma unroll
    for (int c = 0; c < C; ++c) carry_v[c][warp] = carry[c];
  }
  __syncthreads();
  // runs that cross parts: one thread folds every carry in warp order.  Two
  // carries of one id need not be neighbours (a block of fewer than kWarps
  // points leaves parts empty between them), so no two threads may fold
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const int id = carry_id[w];
      if (id >= 0) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c][id] = combine(cols.kind[c], acc[c][id], carry_v[c][w]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int k = threadIdx.x; k < nseg; k += blockDim.x)
      cols.dst[c][seg0 + k] = acc[c][k];
}

}  // namespace

extern "C" int gem_segment_stats_sorted(
    const void* ids, int ids_int64, const void* sum_vals,
    const void* min_vals, const void* max_vals, void* sums, void* mins,
    void* maxs, int64_t n, int num_segments, int n_sum, int n_min,
    int n_max, void* stream, int* launched) {
  *launched = 0;
  if (num_segments <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (num_segments + kBlockSegs - 1) / kBlockSegs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](const Columns& cols, int ncols) {
    const int32_t* i32 = static_cast<const int32_t*>(ids);
    const int64_t* i64 = static_cast<const int64_t*>(ids);
    const dim3 g(grid), b(kWarps * 32);
    switch (ncols * 2 + (ids_int64 ? 1 : 0)) {
      case 2: segment_stats_kernel<1><<<g, b, 0, st>>>(i32, n, num_segments, cols); break;
      case 3: segment_stats_kernel<1><<<g, b, 0, st>>>(i64, n, num_segments, cols); break;
      case 4: segment_stats_kernel<2><<<g, b, 0, st>>>(i32, n, num_segments, cols); break;
      case 5: segment_stats_kernel<2><<<g, b, 0, st>>>(i64, n, num_segments, cols); break;
      case 6: segment_stats_kernel<3><<<g, b, 0, st>>>(i32, n, num_segments, cols); break;
      case 7: segment_stats_kernel<3><<<g, b, 0, st>>>(i64, n, num_segments, cols); break;
      case 8: segment_stats_kernel<4><<<g, b, 0, st>>>(i32, n, num_segments, cols); break;
      default: segment_stats_kernel<4><<<g, b, 0, st>>>(i64, n, num_segments, cols); break;
    }
    ++*launched;
  };
  // every column, in role order; one launch per kMaxCols of them
  const float* src[3] = {static_cast<const float*>(sum_vals),
                         static_cast<const float*>(min_vals),
                         static_cast<const float*>(max_vals)};
  float* dst[3] = {static_cast<float*>(sums), static_cast<float*>(mins),
                   static_cast<float*>(maxs)};
  const int count[3] = {n_sum, n_min, n_max};
  Columns cols;
  int ncols = 0;
  for (int role = 0; role < 3; ++role) {
    for (int f = 0; f < count[role]; ++f) {
      cols.src[ncols] = src[role] + f * n;
      cols.dst[ncols] = dst[role] + static_cast<int64_t>(f) * num_segments;
      cols.kind[ncols] = role;
      if (++ncols == kMaxCols) {
        launch(cols, ncols);
        ncols = 0;
      }
    }
  }
  if (ncols > 0) launch(cols, ncols);
  return static_cast<int>(cudaGetLastError());
}
