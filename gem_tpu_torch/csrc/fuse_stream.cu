// K1: per-cell aggregate rows of the streaming fuse.
//
// Replaces gem_tpu/kernels/fuse_stream.py::_kernel_fact (the Pallas TPU
// kernel behind `fuse_stream`, GEM_FUSE_PASSA=fact) and computes the same
// 16-row contract documented in gem_tpu_torch/kernels/fuse_stream.py.
//
// What bounds it on the card: memory.  Per frame it reads each sorted point
// that lies in a cell once (h, v and, with color, intensity and packed
// color: 8-16 bytes), each cell's run offset (8 bytes) and the priors of
// the cells that hold points, and writes 64 bytes per cell.  At the L=1000
// flagship the 64 MB of rows outweigh a 131072-point frame; a 4M-point
// frame adds half as much again.  There is no arithmetic worth counting.
//
// Design: the TPU kernel built one-hot matrices because the TPU has no
// scatter; on the GPU each cell owns the contiguous run of its points in the
// (cell, -h) sorted stream.  A block OWNS a tile of kTile consecutive cells,
// one thread each, and so the one contiguous range of points whose runs
// they are: no run crosses an owner, no atomics are needed, and every sum
// is taken in an order fixed by the input, so two launches agree bitwise.
// LiDAR density falls with range: most tiles hold short runs, while the
// tiles next to the sensor hold runs of hundreds of points.  So a tile
// takes one of two passes, decided by one barrier vote:
//  * Short runs (every run of the tile at most kShortRun points): each
//    thread walks its own cell's run in sorted order and stores its 16
//    rows.  A near-empty tile costs little more than its stores.
//  * Long runs: the work is spread by points, not cells.
//    - Prologue, one thread per cell: the run bounds go to shared memory;
//      an occupied cell's start row (the run's first point) and end row
//      give every selection row (0-3, 6-11), stored at once, and the
//      gate's anchor and band, kept in shared memory.
//    - Point pass: the tile's points are cut into up to kWarps equal parts
//      by position, one per warp, at most kItems * 32 points per part
//      (fewer parts for fewer points: an idle warp costs nothing).  A warp
//      walks its part kItems * 32 points at a time, kItems consecutive
//      ones per lane read as one float4 per column where the columns are
//      16-byte aligned (coalesced).  A lane finds its points' cells by a
//      binary search over the tile's run bounds, gates each point against
//      its cell's anchor and folds its runs: the gated weight sums W and
//      WH, and the colored-inlier candidate (min v; at an exact v tie
//      color and intensity are each min'd on their own, which is
//      associative and commutative).  A segmented shuffle scan joins the
//      runs that cross lanes; the lane where a run ends folds it into the
//      block's accumulators in shared memory.  A run that crosses into a
//      later warp's part is owned by the warp where it starts; the later
//      warp reduces its share apart and one thread folds these carries in
//      warp order.  This is the pattern of K3 (csrc/segment_stats.cu).
//    - Epilogue, one thread per cell: the five reduced rows (4, 5, 12-14).
// Every row is stored stat-major, (16, ncell), so a block's stores are
// coalesced.  The block is capped at 64 registers a thread, so that four
// blocks share an SM: the short-run tiles, most of a frame, need the
// occupancy to keep their stores in flight.
//
// Packed RGB travels as float32, exact below 2^24; it is never narrowed.
//
// Robot axis: the grid is (tiles of one robot's ncell cells, R).  Block
// (t, r) owns cells [256t, 256t + 256) of robot r: it reads robot r's row
// of the (R, ncell + 1) offsets, which are absolute into the flat point
// arrays, and its priors at r * ncell, and writes rows into the (R, 16,
// ncell) output at r * 16 * ncell.  Tiles never hold two robots' cells, and
// robot r's points start at r * P_pad with P_pad a multiple of kItems, so
// the float4 alignment test and the per-warp cut see each robot's runs
// exactly as a launch for that robot alone does: robot r's rows are
// bitwise its single launch's.  R = 1 is the single launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStats = 16;
constexpr int kTile = 256;          // cells per block, one thread each
constexpr int kWarps = kTile / 32;  // warps per block
constexpr int kItems = 4;           // consecutive points per lane and step
constexpr int kShortRun = 16;       // runs a thread walks on its own
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool has_color(float colf, float inten) {
  const int c = static_cast<int>(colf);
  return (((c >> 16) & 0xFF) * ((c >> 8) & 0xFF) * (c & 0xFF)) != 0 &&
         inten != 0.0f;
}

// What a run reduces: the gated sums and the colored inlier candidate.
// The identity is (0, 0, +inf, +inf, +inf).
struct Acc {
  float w, wh, vc, cm, im;
};

__device__ __forceinline__ Acc identity() {
  return {0.0f, 0.0f, INFINITY, INFINITY, INFINITY};
}

template <bool kColor>
__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  Acc r = {a.w + b.w, a.wh + b.wh, INFINITY, INFINITY, INFINITY};
  if (kColor) {
    if (a.vc < b.vc) {
      r.vc = a.vc; r.cm = a.cm; r.im = a.im;
    } else if (b.vc < a.vc) {
      r.vc = b.vc; r.cm = b.cm; r.im = b.im;
    } else {
      r.vc = a.vc; r.cm = fminf(a.cm, b.cm); r.im = fminf(a.im, b.im);
    }
  }
  return r;
}

// One point's share: its weight and weighted height if it passes the gate,
// and itself as the colored candidate if it is also colored.
template <bool kColor>
__device__ __forceinline__ Acc point(float hp, float vp, float cp, float ip,
                                     float anchor, float band) {
  const bool inl = fabsf(hp - anchor) <= band;
  const float w = 1.0f / fmaxf(vp, 1e-9f);
  Acc x = {inl ? w : 0.0f, inl ? w * hp : 0.0f, INFINITY, INFINITY,
           INFINITY};
  if (kColor && inl && has_color(cp, ip)) {
    x.vc = vp; x.cm = cp; x.im = ip;
  }
  return x;
}

template <bool kColor>
__device__ __forceinline__ Acc shfl_up(const Acc& a, int off) {
  Acc r = {__shfl_up_sync(kAll, a.w, off), __shfl_up_sync(kAll, a.wh, off),
           INFINITY, INFINITY, INFINITY};
  if (kColor) {
    r.vc = __shfl_up_sync(kAll, a.vc, off);
    r.cm = __shfl_up_sync(kAll, a.cm, off);
    r.im = __shfl_up_sync(kAll, a.im, off);
  }
  return r;
}

template <bool kColor>
__device__ __forceinline__ Acc shfl_down(const Acc& a, int off) {
  Acc r = {__shfl_down_sync(kAll, a.w, off),
           __shfl_down_sync(kAll, a.wh, off), INFINITY, INFINITY, INFINITY};
  if (kColor) {
    r.vc = __shfl_down_sync(kAll, a.vc, off);
    r.cm = __shfl_down_sync(kAll, a.cm, off);
    r.im = __shfl_down_sync(kAll, a.im, off);
  }
  return r;
}

// A cell's selection rows from its start row (the run's first point) and
// end row, and the gate's anchor and band (band < 0 for an empty cell).
struct Start {
  float st_h, st_v, st_out, oc_n, oc_v, oc_c, oc_i, low, anchor, band;
};

template <bool kColor>
__device__ __forceinline__ Start start_row(
    const float* __restrict__ h, const float* __restrict__ v,
    const float* __restrict__ inten, const float* __restrict__ colf,
    const float* __restrict__ elev0, const float* __restrict__ var0, int c,
    long long lo, long long hi, float invalid_elevation, float min_variance,
    float mahalanobis, int with_lowest) {
  Start s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (hi > lo) {
    s.st_h = h[lo];
    s.st_v = v[lo];
    const float e0 = elev0[c];
    const bool empty = e0 == invalid_elevation;
    s.anchor = empty ? s.st_h : e0;
    const float anchor_v =
        empty ? fmaxf(s.st_v, min_variance) : fmaxf(var0[c], min_variance);
    s.band = mahalanobis * sqrtf(anchor_v);
    if (!(fabsf(s.st_h - s.anchor) <= s.band)) {
      s.st_out = 1.f;
      if (kColor) {
        const float cp = colf[lo];
        const float ip = inten[lo];
        if (has_color(cp, ip)) {
          s.oc_n = 1.f; s.oc_v = s.st_v; s.oc_c = cp; s.oc_i = ip;
        }
      }
    }
    if (with_lowest) s.low = h[hi - 1] + 3.0f * v[hi - 1];
  }
  return s;
}

template <int N>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           int ncell, int c,
                                           const float (&rows)[N],
                                           const int (&at)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[static_cast<int64_t>(at[k]) * ncell + c] = rows[k];
}

// The block's shared state in the long-run pass: run bounds relative to
// the tile's first point (off[j]..off[j+1] is cell j's run; off[kTile] is
// the tile's point count), each cell's gate, and its accumulators.
struct Tile {
  int off[kTile + 1];
  float anchor[kTile];
  float band[kTile];
  float w[kTile], wh[kTile], vc[kTile], cm[kTile], im[kTile];
  int carry_cell[kWarps];
  Acc carry[kWarps];
};

template <bool kColor>
__device__ __forceinline__ void fold(Tile& t, int j, const Acc& x) {
  const Acc a = {t.w[j], t.wh[j], t.vc[j], t.cm[j], t.im[j]};
  const Acc r = combine<kColor>(a, x);
  t.w[j] = r.w;
  t.wh[j] = r.wh;
  if (kColor) {
    t.vc[j] = r.vc;
    t.cm[j] = r.cm;
    t.im[j] = r.im;
  }
}

// The cell j >= from of the tile whose run holds relative position r:
// the last j with off[j] <= r (off[kTile] > r always).
__device__ __forceinline__ int find_cell(const Tile& t, int r, int from) {
  int lo = from, hi = kTile;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.off[mid] <= r) lo = mid; else hi = mid;
  }
  return lo;
}

// A warp's part [a, b) of the tile's points, positions relative to the
// tile's first point p0 (h, v, inten and colf start there).  Points at the
// start whose cell is `skip` belong to a run that began in an earlier
// warp's part: they are reduced apart into `carry` (the identity if there
// is none) for the block to fold in order.  The lane's kItems points are
// read as one float4 per column where the group is 16-byte aligned
// (`aligned`: every column's pointer is) and lies below `end`, the
// absolute end of the points in cells; points of the group outside the
// part are read but not folded.
template <bool kColor>
__device__ __forceinline__ void reduce_part(
    const float* __restrict__ h, const float* __restrict__ v,
    const float* __restrict__ inten, const float* __restrict__ colf,
    long long p0, long long end, bool aligned, int a, int b, int skip,
    Tile& t, Acc& carry, int lane) {
  carry = identity();
  int cell = -1;   // the cell of the lane's last point: a search hint
  // steps start on an absolute multiple of kItems: every lane's group of
  // kItems points is then 16-byte aligned
  for (int base = a - static_cast<int>((p0 + a) % kItems); base < b;
       base += 32 * kItems) {
    const int i0 = base + lane * kItems;
    float hv[kItems], vv[kItems], cv[kItems] = {}, iv[kItems] = {};
    if (aligned && p0 + i0 + kItems <= end) {
      const float4 x = *reinterpret_cast<const float4*>(h + i0);
      const float4 y = *reinterpret_cast<const float4*>(v + i0);
      hv[0] = x.x; hv[1] = x.y; hv[2] = x.z; hv[3] = x.w;
      vv[0] = y.x; vv[1] = y.y; vv[2] = y.z; vv[3] = y.w;
      if (kColor) {
        const float4 cc = *reinterpret_cast<const float4*>(colf + i0);
        const float4 ii = *reinterpret_cast<const float4*>(inten + i0);
        cv[0] = cc.x; cv[1] = cc.y; cv[2] = cc.z; cv[3] = cc.w;
        iv[0] = ii.x; iv[1] = ii.y; iv[2] = ii.z; iv[3] = ii.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int r = i0 + k;
        const bool in = r >= a && r < b;
        hv[k] = in ? h[r] : 0.f;
        vv[k] = in ? v[r] : 1.f;
        if (kColor) {
          cv[k] = in ? colf[r] : 0.f;
          iv[k] = in ? inten[r] : 0.f;
        }
      }
    }
    int first_c = -1, last_c = -1;
    Acc first_v = identity(), last_v = identity();
    bool several = false;   // more than one run among the lane's items
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = i0 + k;
      if (r >= a && r < b) {
        if (cell < 0 || r >= t.off[cell + 1])
          cell = find_cell(t, r, cell < 0 ? 0 : cell + 1);
        const Acc x = point<kColor>(hv[k], vv[k], cv[k], iv[k],
                                    t.anchor[cell], t.band[cell]);
        if (cell == skip) {
          carry = combine<kColor>(carry, x);
        } else if (last_c < 0) {
          first_c = last_c = cell;
          last_v = x;
        } else if (cell == last_c) {
          last_v = combine<kColor>(last_v, x);
        } else {
          if (several)   // started and ended among the lane's items
            fold<kColor>(t, last_c, last_v);
          else
            first_v = last_v;
          several = true;
          last_c = cell;
          last_v = x;
        }
      }
    }
    if (!several) first_v = last_v;
    // segmented inclusive scan of the lanes' last runs: cells are sorted,
    // so a lane `off` to the left whose last run has the same cell is
    // joined to this one by lanes that hold nothing else
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int oc = __shfl_up_sync(kAll, last_c, off);
      const Acc o = shfl_up<kColor>(last_v, off);
      if (lane >= off && oc == last_c) last_v = combine<kColor>(o, last_v);
    }
    const int prev_c = __shfl_up_sync(kAll, last_c, 1);
    const int next_first = __shfl_down_sync(kAll, first_c, 1);
    const Acc prev_v = shfl_up<kColor>(last_v, 1);
    const bool head = several && lane > 0 && prev_c == first_c;
    const bool tail = last_c >= 0 && (lane == 31 || next_first != last_c);
    // the first run ends here, after what the lanes before carry
    if (several)
      fold<kColor>(t, first_c, head ? combine<kColor>(prev_v, first_v)
                                    : first_v);
    if (tail) fold<kColor>(t, last_c, last_v);
    __syncwarp();
  }
  if (skip >= 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      carry = combine<kColor>(carry, shfl_down<kColor>(carry, off));
  }
}

template <bool kColor>
__global__ void __launch_bounds__(kTile, 4)
fuse_stream_aggregate_kernel(
    const int64_t* __restrict__ offsets, const float* __restrict__ h,
    const float* __restrict__ v, const float* __restrict__ inten,
    const float* __restrict__ colf, const float* __restrict__ elev0,
    const float* __restrict__ var0, float* __restrict__ out, int ncell,
    float invalid_elevation, float min_variance, float mahalanobis,
    int with_lowest) {
  __shared__ Tile t;
  // robot blockIdx.y: its offsets row, priors and output rows
  const int64_t robot = blockIdx.y;
  offsets += robot * (ncell + 1);
  elev0 += robot * ncell;
  var0 += robot * ncell;
  out += robot * kStats * ncell;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTile;
  const int c = c0 + tid;
  const bool cell_ok = c < ncell;
  const long long lo = cell_ok ? offsets[c] : 0;
  const long long hi = cell_ok ? offsets[c + 1] : 0;

  if (!__syncthreads_or(hi - lo > kShortRun)) {
    // short runs: each thread walks its own cell's run in sorted order
    if (!cell_ok) return;
    const Start s = start_row<kColor>(h, v, inten, colf, elev0, var0, c, lo,
                                      hi, invalid_elevation, min_variance,
                                      mahalanobis, with_lowest);
    Acc a = identity();
    for (long long i = lo; i < hi; ++i)
      a = combine<kColor>(a, point<kColor>(h[i], v[i],
                                           kColor ? colf[i] : 0.f,
                                           kColor ? inten[i] : 0.f,
                                           s.anchor, s.band));
    const float rows[kStats] = {
        s.st_h, s.st_v, hi > lo ? 1.f : 0.f, 0.f, a.w, a.wh, s.st_out,
        s.oc_n, s.oc_v, s.oc_c, s.oc_i, s.low, a.vc, a.cm, a.im, INFINITY};
    const int at[kStats] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                            14, 15};
    store_rows(out, ncell, c, rows, at);
    return;
  }

  // long runs.  Prologue: the selection rows, the gate, the run bounds
  const long long p0 = offsets[c0];
  const long long p1 = offsets[min(c0 + kTile, ncell)];
  {
    const Start s = start_row<kColor>(h, v, inten, colf, elev0, var0, c, lo,
                                      hi, invalid_elevation, min_variance,
                                      mahalanobis, with_lowest);
    if (cell_ok) {
      const float rows[11] = {s.st_h, s.st_v, hi > lo ? 1.f : 0.f, 0.f,
                              s.st_out, s.oc_n, s.oc_v, s.oc_c, s.oc_i,
                              s.low, INFINITY};
      const int at[11] = {0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 15};
      store_rows(out, ncell, c, rows, at);
    }
    t.off[tid] = static_cast<int>((cell_ok ? lo : p1) - p0);
    if (tid == 0) t.off[kTile] = static_cast<int>(p1 - p0);
    t.anchor[tid] = s.anchor;
    t.band[tid] = s.band;
    t.w[tid] = 0.f;
    t.wh[tid] = 0.f;
    t.vc[tid] = t.cm[tid] = t.im[tid] = INFINITY;
  }
  __syncthreads();

  // point pass: the tile's points cut into `parts` equal parts by position
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = static_cast<int>(p1 - p0);
  const int parts = min(kWarps, (len + 32 * kItems - 1) / (32 * kItems));
  int skip = -1;
  Acc carry = identity();
  if (warp < parts) {
    const int wa = static_cast<int>(static_cast<long long>(len) * warp
                                    / parts);
    const int wb = static_cast<int>(static_cast<long long>(len) * (warp + 1)
                                    / parts);
    // the cell of the point before the part, if the tile holds it: a run
    // that began there is an earlier warp's
    skip = (wa > 0 && wa < wb) ? find_cell(t, wa - 1, 0) : -1;
    const bool aligned = ((reinterpret_cast<uintptr_t>(h) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(inten) |
                           reinterpret_cast<uintptr_t>(colf)) & 15) == 0;
    reduce_part<kColor>(h + p0, v + p0, inten + p0, colf + p0, p0,
                        offsets[ncell], aligned, wa, wb, skip, t, carry,
                        lane);
  }
  if (lane == 0) {
    t.carry_cell[warp] = skip;
    t.carry[warp] = carry;
  }
  __syncthreads();
  // runs that cross parts: one thread folds every carry in warp order.  Two
  // carries of one cell need not be neighbours (a tile of fewer than kWarps
  // points leaves parts empty between them), so no two threads may fold
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (t.carry_cell[w] >= 0) fold<kColor>(t, t.carry_cell[w], t.carry[w]);
  }
  __syncthreads();

  // epilogue: the reduced rows
  if (cell_ok) {
    const float rows[5] = {t.w[tid], t.wh[tid], t.vc[tid], t.cm[tid],
                           t.im[tid]};
    const int at[5] = {4, 5, 12, 13, 14};
    store_rows(out, ncell, c, rows, at);
  }
}

}  // namespace

extern "C" int gem_fuse_stream_aggregate(
    const void* offsets, const void* h, const void* v, const void* inten,
    const void* colf, const void* elev0, const void* var0, void* out,
    int ncell, int nrobot, float invalid_elevation, float min_variance,
    float mahalanobis, int with_lowest, int with_color, void* stream) {
  if (ncell > 0 && nrobot > 0) {
    const dim3 grid((ncell + kTile - 1) / kTile, nrobot);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* o = static_cast<const int64_t*>(offsets);
    const auto* hh = static_cast<const float*>(h);
    const auto* vv = static_cast<const float*>(v);
    const auto* ii = static_cast<const float*>(inten);
    const auto* cc = static_cast<const float*>(colf);
    const auto* e0 = static_cast<const float*>(elev0);
    const auto* v0 = static_cast<const float*>(var0);
    auto* y = static_cast<float*>(out);
    if (with_color)
      fuse_stream_aggregate_kernel<true><<<grid, kTile, 0, st>>>(
          o, hh, vv, ii, cc, e0, v0, y, ncell, invalid_elevation,
          min_variance, mahalanobis, with_lowest);
    else
      fuse_stream_aggregate_kernel<false><<<grid, kTile, 0, st>>>(
          o, hh, vv, ii, cc, e0, v0, y, ncell, invalid_elevation,
          min_variance, mahalanobis, with_lowest);
  }
  return static_cast<int>(cudaGetLastError());
}
