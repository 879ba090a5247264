// K4: one round of the loop-closure re-stitch's pair join, over cell keys
// sorted once per event.
//
// No TPU kernel: added for the re-stitch join.  The JAX package joins each
// pair with a stable sort of the pair's 2C packed keys `key << 1 | tag`
// (gem_tpu/global_map/loop_closure.py `_refuse`, left to XLA), and so does
// the plain version, gem_tpu_torch/global_map/loop_closure.py `_refuse`.  A
// slot's keys depend only on its x, y and valid, which no round changes, so
// the port sorts each slot's keys once per event (`_sorted_keys`: a stable
// (K, C) sort keeping each row's source index) and this kernel joins a
// round's pairs from those sorted keys, updating z and variance in place.
//
// For a pair (a = slot i, b = slot j) and each key k < kNoFuse present on
// both sides, the rows that the plain version's stable sort makes adjacent
// are the LAST a row of k's run (highest source index) and the FIRST b row
// (lowest source index); with the a row's variance v_old in (0, 1) both rows
// get
//   denom = max(v_old + v_new, 1e-12)
//   z     = (v_old * h_new + v_new * h_old) / denom
//   v     = v_old * v_new / denom
// in that order of operations (built with --fmad=false, IEEE division: the
// plain version's rounding, bitwise), and the fused pair adds one to an
// int64 total.  Keys >= kNoFuse (invalid rows, and the valid cells whose
// packed key aliases them) never fuse, as in the plain version.
//
// The round's pairs are vertex-disjoint (`schedule_rounds`; the wrapper
// checks) and each row has one key, so each row has at most one writer and
// its reader is that writer: the update is in place, without float atomics,
// and two runs are bitwise equal.
//
// What bounds it on the card: memory.  Per pair it reads both slots' sorted
// keys (int64) and source rows (int32), 12 bytes a row, and the matched
// rows' z and variance; it writes the fused rows' z and variance.  A full
// round of the flagship ring (32 pairs of 32768-row slots) needs ~25 MB of
// keys and rows: 7.5 us at the H100's 3.35 TB/s, less from the 50 MB L2
// where the event's sort just wrote them.
//
// Design: one thread per sorted a row, grid (row blocks, pairs), the pairs
// passed by value (no upload, no device read of the schedule).  A thread
// whose row ends its key's run searches b's sorted keys for the key's first
// row.  To keep those searches short, warps 0 and 1 of the block first
// bound the b rows whose keys lie in the block's key range, each with a
// 32-way warp search (four rounds of one load per lane at 32768 rows); the
// threads then search only that stretch, which the block's neighbouring
// keys share in L1.  The block's fused count is one __syncthreads_count and
// one 64-bit atomic add.
//
// The host side: `gem_refuse_join_rounds` takes a whole event's schedule
// and makes every round's launches in one call, after checking every round
// once; `gem_refuse_join` launches one round (chip_smoke.py, the tests).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kThreads = 256;                  // sorted a rows per block
constexpr int kMaxPairs = 256;                 // pairs of one launch
constexpr int64_t kNoFuse = 0xFFFFFFFELL;      // keys at or above never fuse
constexpr unsigned kAll = 0xffffffffu;

struct Pairs {
  int32_t ij[2 * kMaxPairs];                   // (a slot, b slot) per pair
};

// First position in [0, n) with keys[pos] >= x (n if none), found by the
// whole warp: each round 32 lanes probe 32 rows that cut the interval into
// 33 parts, and the interval shrinks to the part holding the answer.
__device__ int lower_bound_warp(const int64_t* __restrict__ keys, int n,
                                int64_t x, int lane) {
  int lo = 0, hi = n;   // keys[lo - 1] < x <= keys[hi]
  while (lo < hi) {
    const int p = lo + static_cast<int>(
        static_cast<int64_t>(hi - lo) * (lane + 1) / 33);   // lo <= p < hi
    const unsigned ge = __ballot_sync(kAll, keys[p] >= x);
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

__global__ void __launch_bounds__(kThreads)
refuse_join_kernel(const Pairs pairs, const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ rows, float* __restrict__ z,
                   float* __restrict__ var, int C,
                   unsigned long long* __restrict__ total) {
  __shared__ int b_range[2];
  const int64_t i = pairs.ij[2 * blockIdx.y];
  const int64_t j = pairs.ij[2 * blockIdx.y + 1];
  const int64_t* ka = keys + i * C;
  const int64_t* kb = keys + j * C;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  const int64_t first = ka[p0];
  if (first >= kNoFuse) return;   // the whole block: no key fuses
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    // warp 0: b's first row of the block's first key; warp 1: b's first
    // row past the block's last key that can fuse
    int64_t x = first;
    if (warp == 1) {
      const int64_t last = ka[min(p0 + kThreads, C) - 1];
      x = (last < kNoFuse ? last : kNoFuse - 1) + 1;
    }
    const int pos = lower_bound_warp(kb, C, x, lane);
    if (lane == 0) b_range[warp] = pos;
  }
  __syncthreads();

  int fused = 0;
  if (p < C) {
    const int64_t k = ka[p];
    if (k < kNoFuse && (p + 1 == C || ka[p + 1] != k)) {
      int lo = b_range[0], hi = b_range[1];
      const int end = hi;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kb[mid] < k) lo = mid + 1; else hi = mid;
      }
      if (lo < end && kb[lo] == k) {
        float* za = z + i * C;
        float* va = var + i * C;
        float* zb = z + j * C;
        float* vb = var + j * C;
        const int ra = rows[i * C + p], rb = rows[j * C + lo];
        const float v_old = va[ra];
        if (v_old > 0.0f && v_old < 1.0f) {
          const float h_old = za[ra], h_new = zb[rb], v_new = vb[rb];
          const float s = v_old + v_new;
          // torch.clamp(s, min=1e-12): NaN stays NaN
          const float denom = s < 1e-12f ? 1e-12f : s;
          const float fz = (v_old * h_new + v_new * h_old) / denom;
          const float fv = v_old * v_new / denom;
          za[ra] = fz;
          va[ra] = fv;
          zb[rb] = fz;
          vb[rb] = fv;
          fused = 1;
        }
      }
    }
  }
  const int n = __syncthreads_count(fused);
  if (threadIdx.x == 0 && n > 0)
    atomicAdd(total, static_cast<unsigned long long>(n));
}

// The launches of one round: its n vertex-disjoint pairs (host int32 (n,
// 2)), kMaxPairs to a launch.
int launch_round(const int32_t* ij, int n_pairs, const void* keys,
                 const void* rows, void* z, void* var, int C, void* total,
                 cudaStream_t st, int* launched) {
  const int blocks = (C + kThreads - 1) / kThreads;
  for (int start = 0; start < n_pairs; start += kMaxPairs) {
    const int n = n_pairs - start < kMaxPairs ? n_pairs - start : kMaxPairs;
    Pairs chunk;
    for (int q = 0; q < 2 * n; ++q) chunk.ij[q] = ij[2 * start + q];
    refuse_join_kernel<<<dim3(blocks, n), kThreads, 0, st>>>(
        chunk, static_cast<const int64_t*>(keys),
        static_cast<const int32_t*>(rows), static_cast<float*>(z),
        static_cast<float*>(var), C,
        static_cast<unsigned long long*>(total));
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// pairs: host int32 (n_pairs, 2) slot indices, vertex-disjoint; keys (K, C)
// int64, each slot's sorted; rows (K, C) int32, each sorted key's source
// row; z, var (K, C) float32, updated in place; total: one int64 on the
// device, added to.  One launch per kMaxPairs pairs.
extern "C" int gem_refuse_join(const void* pairs, int n_pairs,
                               const void* keys, const void* rows, void* z,
                               void* var, int C, void* total, void* stream,
                               int* launched) {
  *launched = 0;
  if (n_pairs <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int err = launch_round(static_cast<const int32_t*>(pairs), n_pairs,
                               keys, rows, z, var, C, total,
                               static_cast<cudaStream_t>(stream), launched);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// A whole event's rounds in one call: rounds host int32 (R, P, 2), valid
// host bool (R, P); the other arguments as gem_refuse_join's over K slots.
// Every round is checked before the first launch: -1 if a valid lane names
// a slot outside [0, K), -2 if a slot occurs twice within a round, and
// nothing is launched.  Then each round's valid lanes, in lane order, are
// launched as gem_refuse_join launches them, round after round.
extern "C" int gem_refuse_join_rounds(const void* rounds, const void* valid,
                                      int R, int P, int K, const void* keys,
                                      const void* rows, void* z, void* var,
                                      int C, void* total, void* stream,
                                      int* launched) {
  *launched = 0;
  const int32_t* rd = static_cast<const int32_t*>(rounds);
  const bool* ok = static_cast<const bool*>(valid);
  std::vector<int> seen(K > 0 ? K : 0, -1);   // the last round using a slot
  for (int r = 0; r < R; ++r) {
    for (int p = 0; p < P; ++p) {
      if (!ok[r * P + p]) continue;
      for (int e = 0; e < 2; ++e) {
        const int s = rd[2 * (r * P + p) + e];
        if (s < 0 || s >= K) return -1;
        if (seen[s] == r) return -2;
        seen[s] = r;
      }
    }
  }
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::vector<int32_t> ij(2 * static_cast<size_t>(P));
  for (int r = 0; r < R; ++r) {
    int n = 0;
    for (int p = 0; p < P; ++p) {
      if (!ok[r * P + p]) continue;
      ij[2 * n] = rd[2 * (r * P + p)];
      ij[2 * n + 1] = rd[2 * (r * P + p) + 1];
      ++n;
    }
    if (n == 0) continue;
    const int err = launch_round(ij.data(), n, keys, rows, z, var, C, total,
                                 st, launched);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
