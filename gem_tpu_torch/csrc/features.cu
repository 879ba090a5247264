// K2: 5x5 masked plane fit over the circular elevation buffer.
//
// Replaces gem_tpu/kernels/features_pallas.py::_kernel (the Pallas TPU
// stencil behind `compute_features_pallas`).  Same semantics as the plain
// version in gem_tpu_torch/kernels/features.py: per storage cell, the moment
// sums n, Sx, Sy, Sz, Sxx, Syy, Sxy, Sxz, Syz, Szz over the 5x5 neighbours
// that are valid (not invalid_elevation) and inside the geographic window
// (masks from `start`), then `features_from_moments` -> slope, rough,
// traver, normal_z and the neighbour count.  It agrees with the plain
// version bitwise.
//
// What bounds it on the card: memory in the function, instruction issue in
// practice.  It reads the L*L elevation plane once and writes five planes:
// 24 bytes per cell, 24 MB at L=1000, 7.2 us at the H100's 3.35 TB/s.  A
// fitted cell also needs ~575 fp32 operations (25 neighbours x 13, plus an
// epilogue of IEEE divisions, sqrtf, acosf and cosf), 8.6 us at 67 TFLOP/s
// when every cell is fitted; a cell that is not fitted needs only its count.
//
// Design, doing less per cell than the first version (one thread per cell,
// the offsets recomputed in fp64, moments multiplied by a 0/1 mask, the
// whole epilogue run and thrown away where the cell is not fitted):
//  * The offsets' coordinates cx = i*res, cy = j*res, cx*cx, cy*cy, cx*cy
//    are a float table computed once on the host in double and rounded to
//    float, as the plain version rounds its Python scalars, and passed by
//    value: they sit in the constant bank, no fp64 in the kernel.
//  * A block stages a 32 x 8 output tile with its halo as a 36 x 12 shared
//    tile (the modulo-L wrap only in blocks that touch the edge of the
//    storage buffer), and each tile row's validity as a 36-bit mask (two
//    warp ballots).  One thread per cell: small blocks spread the fitted
//    cells, which cluster around the robot, over many SMs.
//  * Phase 1, every cell: its 25-bit neighbour mask (validity & the
//    geographic window) from five row masks, n by popcount, the count
//    stored.  Where the centre is invalid or n < min_neighbors the plain
//    version writes constants: so does this kernel, and does no more.
//    Otherwise the moments: where all 25 neighbours are valid, n, Sx, Sy,
//    Sxx, Syy and Sxy are the host's sums of the table in the plain
//    version's order and only Sz, Sxz, Syz, Szz are accumulated; elsewhere
//    the accumulation is predicated on the mask bit instead of multiplied
//    by a 0/1 mask.  Both are bitwise the plain version's masked sums
//    because x + 0.0f == x: this assumes every elevation is finite (0 * inf
//    would be NaN), which the map guarantees (invalid cells hold
//    invalid_elevation, a finite value).  The fitted cell's central moments
//    and roughness go to a queue in shared memory (one atomic per warp).
//  * Phase 2: the block's threads run the eigen epilogue over the queue,
//    every lane busy however the fitted cells are scattered over the tile,
//    where the first version ran it for every cell.
// Built with --fmad=false so every product and sum rounds as in the plain
// version: the eigenvector is picked by float equality, and acos near 1
// turns one ULP of normal_z into ~3e-4 rad.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTileW = 32;   // output tile: kTileW x kTileH cells, one
constexpr int kTileH = 8;    // thread each
constexpr int kHalo = 2;
constexpr int kInW = kTileW + 2 * kHalo;   // the staged tile, halo included
constexpr int kInH = kTileH + 2 * kHalo;
constexpr uint32_t kFull = (1u << 25) - 1;
constexpr double kPi = 3.14159265358979323846;

// The host's table (kernels/features.py `_offset_table`), by value.
struct Offsets {
  float c[5];      // k * res for k = -2..2 (cx of row offset i, cy of col j)
  float cc[5];     // (k * res)^2
  float cxy[25];   // (i * res) * (j * res), row-major in (i, j)
  // the sums over all 25 neighbours, in the plain version's (i, j) order
  float full_sx, full_sy, full_sxx, full_syy, full_sxy;
};

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

struct Cross {
  float x, y, z;
};

__device__ __forceinline__ Cross cross(float a0, float a1, float a2, float b0,
                                       float b1, float b2) {
  return {a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0};
}

// _smallest_eig_normal and the tail of features_from_moments of
// kernels/features.py, for a fitted cell (valid centre, n >= min_neighbors),
// from its central moments and roughness
__device__ __forceinline__ void fit(float xx, float yy, float zz, float xy,
                                    float xz, float yz, float rough,
                                    float inv_slope_critical,
                                    float inv_rough_critical,
                                    float* slope_out, float* traver_out,
                                    float* nz_out) {
  // x / constant is x * (1/constant) rounded to float, as XLA computes it
  // in the JAX reference (gem_tpu_torch/utils/precision.py)
  constexpr float kThird = 1.0f / 3.0f;
  const float q = (xx + yy + zz) * kThird;
  const float p1 = xy * xy + xz * xz + yz * yz;
  const float dx = xx - q, dy = yy - q, dz = zz - q;
  const float p2 = dx * dx + dy * dy + dz * dz + 2.0f * p1;
  // the plain version's `degenerate` cells (p2 < 1e-12 or best < 1e-20)
  // take normal_z = 1 whatever the rest computes: skip it (its divisions by
  // a tiny p take the slow path of IEEE division)
  float nz = 1.0f;
  if (!(p2 < 1e-12f)) {
    const float p = sqrtf(fmaxf(p2 * (1.0f / 6.0f), 1e-30f));
    const float bxx = dx / p, byy = dy / p, bzz = dz / p;
    const float bxy = xy / p, bxz = xz / p, byz = yz / p;
    const float detb = bxx * (byy * bzz - byz * byz) -
                       bxy * (bxy * bzz - byz * bxz) +
                       bxz * (bxy * byz - byy * bxz);
    const float r = fminf(fmaxf(detb * 0.5f, -1.0f), 1.0f);
    const float phi = acosf(r) * kThird;
    const float lam =
        q + 2.0f * p * cosf(phi + static_cast<float>(2.0 * kPi / 3.0));

    const Cross c01 = cross(xx - lam, xy, xz, xy, yy - lam, yz);
    const Cross c02 = cross(xx - lam, xy, xz, xz, yz, zz - lam);
    const Cross c12 = cross(xy, yy - lam, yz, xz, yz, zz - lam);
    const float n01 = c01.x * c01.x + c01.y * c01.y + c01.z * c01.z;
    const float n02 = c02.x * c02.x + c02.y * c02.y + c02.z * c02.z;
    const float n12 = c12.x * c12.x + c12.y * c12.y + c12.z * c12.z;
    const float best = fmaxf(fmaxf(n01, n02), n12);
    if (!(best < 1e-20f)) {
      const Cross v = best == n01 ? c01 : (best == n02 ? c02 : c12);
      const float norm =
          sqrtf(fmaxf(v.x * v.x + v.y * v.y + v.z * v.z, 1e-30f));
      nz = fabsf(v.z) / norm;
    }
  }

  const float slope = acosf(fminf(fmaxf(nz, 0.0f), 1.0f));
  *slope_out = slope;
  *traver_out = 0.5f * (1.0f - slope * inv_slope_critical) +
                0.5f * (1.0f - rough * inv_rough_critical);
  *nz_out = nz;
}

// bits j + 2 (j = -2..2) set where geo + j lies inside [0, L)
__device__ __forceinline__ uint32_t window_bits(int geo, int L) {
  uint32_t b = 0;
#pragma unroll
  for (int j = -2; j <= 2; ++j)
    b |= (geo + j >= 0 && geo + j < L) ? (1u << (j + 2)) : 0u;
  return b;
}

__global__ void __launch_bounds__(kTileW * kTileH)
plane_fit_kernel(const float* __restrict__ elev, const int* __restrict__ start,
                 float* __restrict__ slope, float* __restrict__ rough,
                 float* __restrict__ traver, float* __restrict__ normal_z,
                 int* __restrict__ count, int L, const Offsets off,
                 float invalid_elevation, float invalid_traversability,
                 float inv_slope_critical, float inv_rough_critical,
                 float min_neighbors) {
  __shared__ float tile[kInH][kInW];
  __shared__ unsigned long long valid_row[kInH];  // bit c: tile[t][c] valid
  // the fitted cells of the tile: central moments, roughness, cell index
  __shared__ float fq[7][kTileW * kTileH];
  __shared__ int fq_cell[kTileW * kTileH];
  __shared__ int fq_len;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = threadIdx.x;   // a warp is one row of threads
  constexpr int kTileN = kInH * kInW;
  if (r0 >= kHalo && c0 >= kHalo && r0 + kTileH + kHalo <= L &&
      c0 + kTileW + kHalo <= L) {
    const float* base = elev + static_cast<int64_t>(r0 - kHalo) * L +
                        (c0 - kHalo);
    for (int k = tid; k < kTileN; k += kTileW * kTileH) {
      const int ty = k / kInW;
      const int tx = k - ty * kInW;
      tile[ty][tx] = base[static_cast<int64_t>(ty) * L + tx];
    }
  } else {   // the block touches the edge of the storage buffer: wrap
    for (int k = tid; k < kTileN; k += kTileW * kTileH) {
      const int ty = k / kInW;
      const int tx = k - ty * kInW;
      const int r = floor_mod(r0 + ty - kHalo, L);
      const int c = floor_mod(c0 + tx - kHalo, L);
      tile[ty][tx] = elev[static_cast<int64_t>(r) * L + c];
    }
  }
  if (tid == 0) fq_len = 0;
  __syncthreads();
  for (int t = threadIdx.y; t < kInH; t += kTileH) {
    const unsigned lo = __ballot_sync(0xffffffffu,
                                      tile[t][lane] != invalid_elevation);
    const unsigned hi = __ballot_sync(
        0xffffffffu, lane < kInW - kTileW &&
                         tile[t][kTileW + (lane & 3)] != invalid_elevation);
    if (lane == 0)
      valid_row[t] = lo | (static_cast<unsigned long long>(hi) << 32);
  }
  __syncthreads();

  // phase 1: every cell's neighbour mask and count; the moments of the
  // fitted cells, queued; the constants of the others
  const int col = c0 + lane;
  const int tr = threadIdx.y;   // tile row of offset i = -2
  const int row = r0 + tr;
  const bool here = row < L && col < L;
  bool fitted = false;
  float xx, yy, zz, xy, xz, yz, rgh;
  int64_t o = 0;
  if (here) {
    const uint32_t row_ok = window_bits(floor_mod(row - start[0], L), L);
    const uint32_t col_ok = window_bits(floor_mod(col - start[1], L), L);
    uint32_t mask = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if ((row_ok >> i) & 1u)
        mask |= (static_cast<uint32_t>(valid_row[tr + i] >> lane) & 31u &
                 col_ok) << (5 * i);
    const int nbr = __popc(mask);
    const float n = static_cast<float>(nbr);
    const float center = tile[tr + 2][lane + 2];
    o = static_cast<int64_t>(row) * L + col;
    count[o] = nbr;
    fitted = center != invalid_elevation && n >= min_neighbors;
    if (!fitted) {
      slope[o] = 0.0f;
      rough[o] = 0.0f;
      traver[o] = invalid_traversability;
      normal_z[o] = 1.0f;
    } else {
      float Sx, Sy, Sxx, Syy, Sxy;
      float Sz = 0.f, Sxz = 0.f, Syz = 0.f, Szz = 0.f;
      if (mask == kFull) {
        Sx = off.full_sx;
        Sy = off.full_sy;
        Sxx = off.full_sxx;
        Syy = off.full_syy;
        Sxy = off.full_sxy;
#pragma unroll
        for (int i = 0; i < 5; ++i) {
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const float v = tile[tr + i][lane + j];
            Sz += v;
            Sxz += v * off.c[i];
            Syz += v * off.c[j];
            Szz += v * v;
          }
        }
      } else {
        Sx = Sy = Sxx = Syy = Sxy = 0.f;
#pragma unroll
        for (int i = 0; i < 5; ++i) {
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            if ((mask >> (5 * i + j)) & 1u) {
              const float v = tile[tr + i][lane + j];
              Sx += off.c[i];
              Sy += off.c[j];
              Sz += v;
              Sxx += off.cc[i];
              Syy += off.cc[j];
              Sxy += off.cxy[5 * i + j];
              Sxz += v * off.c[i];
              Syz += v * off.c[j];
              Szz += v * v;
            }
          }
        }
      }
      const float n_safe = fmaxf(n, 1.0f);
      xx = Sxx - Sx * Sx / n_safe;
      yy = Syy - Sy * Sy / n_safe;
      zz = Szz - Sz * Sz / n_safe;
      xy = Sxy - Sx * Sy / n_safe;
      xz = Sxz - Sx * Sz / n_safe;
      yz = Syz - Sy * Sz / n_safe;
      rgh = fabsf(center - Sz / n_safe);
      rough[o] = rgh;
    }
  }
  // queue the fitted cells: one shared-memory atomic per warp
  const unsigned who = __ballot_sync(0xffffffffu, fitted);
  if (who != 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&fq_len, __popc(who));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (fitted) {
      const int slot = base + __popc(who & ((1u << lane) - 1u));
      fq[0][slot] = xx;
      fq[1][slot] = yy;
      fq[2][slot] = zz;
      fq[3][slot] = xy;
      fq[4][slot] = xz;
      fq[5][slot] = yz;
      fq[6][slot] = rgh;
      fq_cell[slot] = static_cast<int>(o);
    }
  }
  __syncthreads();

  // phase 2: the eigen epilogue over the queue, every thread busy
  const int len = fq_len;
  for (int j = tid; j < len; j += kTileW * kTileH) {
    const int64_t o = fq_cell[j];
    fit(fq[0][j], fq[1][j], fq[2][j], fq[3][j], fq[4][j], fq[5][j], fq[6][j],
        inv_slope_critical, inv_rough_critical, &slope[o], &traver[o],
        &normal_z[o]);
  }
}

}  // namespace

extern "C" int gem_plane_fit_features(
    const void* elev, const void* start, void* slope, void* rough,
    void* traver, void* normal_z, void* count, int L, const float* table,
    float invalid_elevation, float invalid_traversability,
    float inv_slope_critical, float inv_rough_critical, float min_neighbors,
    void* stream) {
  if (L > 0) {
    Offsets off;
    static_assert(sizeof(Offsets) == 40 * sizeof(float), "table layout");
    memcpy(&off, table, sizeof(Offsets));
    const dim3 block(kTileW, kTileH);
    const dim3 grid((L + kTileW - 1) / kTileW, (L + kTileH - 1) / kTileH);
    plane_fit_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(elev), static_cast<const int*>(start),
        static_cast<float*>(slope), static_cast<float*>(rough),
        static_cast<float*>(traver), static_cast<float*>(normal_z),
        static_cast<int*>(count), L, off, invalid_elevation,
        invalid_traversability, inv_slope_critical, inv_rough_critical,
        min_neighbors);
  }
  return static_cast<int>(cudaGetLastError());
}
