// K5: the submap store's compaction, one leading row at a time: each row's
// valid inputs go, in input order, into the accumulator's free rows.
//
// No TPU kernel: added for the compaction.  The JAX package
// (gem_tpu/global_map/submaps.py `_compact_append`, left to XLA) scatters
// every input, the invalid ones to a dump row.  The port's plain version,
// gem_tpu_torch/kernels/compact.py `compact_append_plain`, gathers: a
// cumsum of the valid flags, a `searchsorted` of the C output rows' ranks,
// one gather and one where per field.  Torch runs the cumsum of a (4, n)
// fleet stack as `tensor_kernel_scan_innermost_dim`, one block per row,
// each walking 10^6 flags: 1.4 ms a fleet frame.  This kernel computes what
// the plain version returns, bit for bit, for any leading shape (..., n)
// with a (..., C) buffer and a (...) count:
//   appended = clamp(min(total, C - count), 0), total the row's valid inputs
//   output row j in [count, count + appended): the valid input of rank
//     j - count, all eight fields, valid True;
//   every other output row: the buffer's row;
//   every output color through float32, `.to(float32).to(int32)` (round to
//     nearest, then truncate), the buffer's rows too;
//   out count = count + appended, dropped = total - appended.
//
// What bounds it on the card: memory.  It reads the row's valid flags (one
// byte an input; 4 MB at the fleet's (4, 10^6) finalize) in each of its two
// passes, the taken inputs' 28 bytes, the buffer's rows that stay, and
// writes the C output rows, 29 bytes each: ~16 MB at that finalize, ~5 us
// at the H100's 3.35 TB/s, less where the second read hits the 50 MB L2.
//
// Design, a reduce then a scan in two launches, so that no block waits on
// another and no scratch is reset inside a CUDA graph:
//  1. grid (tiles of kTile inputs, rows): each thread loads 16 flags (one
//     16-byte load where the row is aligned) and the block's popcounts sum
//     into a (rows, tiles) scratch.
//  2. grid (at most kBlocks input blocks + the copy blocks, rows): every
//     block sums its row's tile counts (a few hundred ints) into the row's
//     total.  Input block b walks tiles b, b + kBlocks, ... and stops where
//     the valid inputs before the tile reach `appended`: in the fleet's
//     finalize only the first ~14 of a row's 245 tiles are written, so
//     the rest are never launched.  It ranks a tile's flags (a warp scan of
//     the threads' popcounts, one sum of the warps') and writes its inputs
//     of rank < `appended` in input order, neighbouring threads on
//     neighbouring inputs.  The copy blocks write the buffer's rows that no
//     input takes, and the first writes the row's count and dropped.
// What is left is latency: a block's work is a few dependent loads.  So a
// thread issues all its loads of a group of rows before any store (the
// compiler cannot move a load past a store to a column it may alias), and
// the grid is small enough that every block is resident at once.
// Every output row is written exactly once, so the result does not depend
// on the order of the blocks, and two launches are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                  // flags a thread: 16 bytes
constexpr int kTile = kThreads * kPerThread;    // inputs a block (compact.py)
constexpr int kChunk = 8;                       // inputs loaded together
constexpr int kBlocks = 32;                     // input blocks a row, at most
constexpr int kCopyTile = 4 * kThreads;         // buffer rows a copy block
constexpr int kFloats = 6;      // x, y, z, variance, intensity, traver
constexpr unsigned kAll = 0xffffffffu;

// one PointBuffer's eight columns, each (rows, len) contiguous
struct Points {
  const float* f[kFloats];
  const int32_t* color;
  const uint8_t* valid;
};

struct OutPoints {
  float* f[kFloats];
  int32_t* color;
  uint8_t* valid;
};

// `.to(torch.float32).to(torch.int32)`: as torch's own CUDA casts do
__device__ __forceinline__ int32_t through_f32(int32_t c) {
  return static_cast<int32_t>(static_cast<float>(c));
}

// flags of inputs [i0, i0 + 16) of a row of n: bit k for input i0 + k
__device__ __forceinline__ unsigned load_flags(const uint8_t* v, int64_t n,
                                               int64_t i0, bool aligned) {
  unsigned m = 0;
  if (aligned && i0 + kPerThread <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(v + i0);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        m |= static_cast<unsigned>(((words[q] >> (8 * b)) & 0xffu) != 0)
             << (4 * q + b);
    }
  } else {
    for (int k = 0; k < kPerThread && i0 + k < n; ++k)
      m |= static_cast<unsigned>(v[i0 + k] != 0) << k;
  }
  return m;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const uint8_t* __restrict__ valid, int64_t n, int tiles,
                     int32_t* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const uint8_t* v = valid + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile
                     + threadIdx.x * kPerThread;
  const int c = __reduce_add_sync(
      kAll, __popc(load_flags(v, n, i0, aligned16(v))));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    tile_counts[static_cast<int64_t>(blockIdx.y) * tiles + blockIdx.x] = s;
  }
}

// the sum of `v` over the block; every thread gets it
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(kAll, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += scratch[w];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
compact_scatter_kernel(const Points in, const Points buf, const OutPoints out,
                       const int32_t* __restrict__ count,
                       int32_t* __restrict__ out_count,
                       int32_t* __restrict__ dropped,
                       const int32_t* __restrict__ tile_counts, int64_t n,
                       int tiles, int blocks, int C) {
  __shared__ int scratch[kWarps];
  __shared__ unsigned short masks[kThreads];
  __shared__ int thread_pre[kThreads];
  const int row = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int32_t* tc = tile_counts + static_cast<int64_t>(row) * tiles;
  const int64_t cnt = count[row];

  // the row's valid inputs, and those of the tiles before this block's
  // first (a copy block has none)
  const int first = b < blocks ? b : tiles;
  int total = 0, before = 0;
  for (int t = tid; t < tiles; t += kThreads) {
    const int c = tc[t];
    total += c;
    if (t < first) before += c;
  }
  total = block_sum(total, scratch);
  before = block_sum(before, scratch);
  const int64_t room = C - cnt;
  const int64_t appended = total < room ? (total > 0 ? total : 0)
                                        : (room > 0 ? room : 0);
  const int64_t ro = static_cast<int64_t>(row) * C;   // the row's outputs

  if (b >= blocks) {
    // the buffer's rows that no input takes; all loads before any store
    const int64_t j0 = static_cast<int64_t>(b - blocks) * kCopyTile + tid;
    constexpr int kRows = kCopyTile / kThreads;
    bool keep[kRows];
    float f32[kFloats][kRows];
    int32_t color[kRows];
    uint8_t valid[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t j = j0 + k * kThreads;
      keep[k] = j < C && (j < cnt || j >= cnt + appended);
      if (!keep[k]) continue;
#pragma unroll
      for (int f = 0; f < kFloats; ++f) f32[f][k] = buf.f[f][ro + j];
      color[k] = buf.color[ro + j];
      valid[k] = buf.valid[ro + j];
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (!keep[k]) continue;
      const int64_t o = ro + j0 + k * kThreads;
#pragma unroll
      for (int f = 0; f < kFloats; ++f) out.f[f][o] = f32[f][k];
      out.color[o] = through_f32(color[k]);
      out.valid[o] = valid[k];
    }
    if (b == blocks && tid == 0) {
      out_count[row] = static_cast<int32_t>(cnt + appended);
      dropped[row] = static_cast<int32_t>(total - appended);
    }
    return;
  }

  // input tiles b, b + blocks, ... until the ranks pass `appended`
  const int64_t rin = static_cast<int64_t>(row) * n;
  const uint8_t* v = in.valid + rin;
  const bool aligned = aligned16(v);
  for (int t = b; t < tiles; t += blocks) {
    if (t > b) {
      int add = 0;
      for (int u = t - blocks + tid; u < t; u += kThreads) add += tc[u];
      before += block_sum(add, scratch);
    }
    if (before >= appended) break;     // the whole block
    if (tc[t] == 0) continue;

    // rank the tile's valid inputs: thread t holds inputs [16 t, 16 t + 16)
    const int64_t t0 = static_cast<int64_t>(t) * kTile;
    const unsigned m = load_flags(v, n, t0 + tid * kPerThread, aligned);
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) scratch[warp] = incl;
    __syncthreads();
    int pre = before + incl - c;
    for (int w = 0; w < warp; ++w) pre += scratch[w];
    masks[tid] = static_cast<unsigned short>(m);
    thread_pre[tid] = pre;
    __syncthreads();

    // write in input order, thread t taking inputs t, t + 256, ... of the
    // tile, kChunk at a time with all their loads before any store
#pragma unroll
    for (int c0 = 0; c0 < kPerThread; c0 += kChunk) {
      int src[kChunk], dst[kChunk];    // dst < 0: no row
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int e = (c0 + k) * kThreads + tid;
        const unsigned mo = masks[e / kPerThread];
        const int bit = e % kPerThread;
        const int64_t rank =
            thread_pre[e / kPerThread] + __popc(mo & ((1u << bit) - 1u));
        // a negative count leaves the ranks below -count to no row, as
        // the plain version's gather does
        const bool take = ((mo >> bit) & 1u) && rank < appended
                          && cnt + rank >= 0;
        src[k] = e;
        dst[k] = take ? static_cast<int>(cnt + rank) : -1;
      }
      float f32[kFloats][kChunk];
      int32_t color[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (dst[k] < 0) continue;
        const int64_t i = rin + t0 + src[k];
#pragma unroll
        for (int f = 0; f < kFloats; ++f) f32[f][k] = in.f[f][i];
        color[k] = in.color[i];
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (dst[k] < 0) continue;
        const int64_t o = ro + dst[k];
#pragma unroll
        for (int f = 0; f < kFloats; ++f) out.f[f][o] = f32[f][k];
        out.color[o] = through_f32(color[k]);
        out.valid[o] = 1;
      }
    }
    __syncthreads();     // before the next tile's ranks reuse the arrays
  }
}

}  // namespace

// in, buf, out: host arrays of the eight column pointers, in the order x, y,
// z, variance, intensity, traver (float32), color (int32), valid (bool), of
// the (rows, n) inputs, the (rows, C) buffer and the (rows, C) outputs;
// count, out_count, dropped: (rows,) int32 on the device; tile_counts: a
// (rows, ceil(n / kTile)) int32 scratch.  Two launches on `stream`.
extern "C" int gem_compact_append(const void* const* in,
                                  const void* const* buf,
                                  void* const* out, const void* count,
                                  void* out_count, void* dropped,
                                  void* tile_counts, int rows, int64_t n,
                                  int C, void* stream) {
  if (rows <= 0 || n <= 0 || C < 0)
    return static_cast<int>(cudaGetLastError());
  Points pin, pbuf;
  OutPoints pout;
  for (int f = 0; f < kFloats; ++f) {
    pin.f[f] = static_cast<const float*>(in[f]);
    pbuf.f[f] = static_cast<const float*>(buf[f]);
    pout.f[f] = static_cast<float*>(out[f]);
  }
  pin.color = static_cast<const int32_t*>(in[kFloats]);
  pbuf.color = static_cast<const int32_t*>(buf[kFloats]);
  pout.color = static_cast<int32_t*>(out[kFloats]);
  pin.valid = static_cast<const uint8_t*>(in[kFloats + 1]);
  pbuf.valid = static_cast<const uint8_t*>(buf[kFloats + 1]);
  pout.valid = static_cast<uint8_t*>(out[kFloats + 1]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int blocks = tiles < kBlocks ? tiles : kBlocks;
  const int copy_tiles = C > 0 ? (C + kCopyTile - 1) / kCopyTile : 1;
  int32_t* tcounts = static_cast<int32_t*>(tile_counts);
  compact_count_kernel<<<dim3(tiles, rows), kThreads, 0, st>>>(
      pin.valid, n, tiles, tcounts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter_kernel<<<dim3(blocks + copy_tiles, rows), kThreads, 0,
                           st>>>(
      pin, pbuf, pout, static_cast<const int32_t*>(count),
      static_cast<int32_t*>(out_count), static_cast<int32_t*>(dropped),
      tcounts, n, tiles, blocks, C);
  return static_cast<int>(cudaGetLastError());
}
