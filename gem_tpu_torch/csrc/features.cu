// K2: 5x5 masked plane fit over the circular elevation buffer.
//
// Replaces gem_tpu/kernels/features_pallas.py::_kernel (the Pallas TPU
// stencil behind `compute_features_pallas`).  Same semantics as the plain
// version in gem_tpu_torch/kernels/features.py: per storage cell, the moment
// sums n, Sx, Sy, Sz, Sxx, Syy, Sxy, Sxz, Syz, Szz over the 5x5 neighbours
// that are valid (not invalid_elevation) and inside the geographic window
// (masks from `start`), then `features_from_moments` -> slope, rough,
// traver, normal_z and the neighbour count.
//
// What bounds it on the card: instruction issue, not memory.  It reads the
// L*L elevation plane once (plus the halo) and writes five planes: 24 bytes
// per cell, 24 MB at L=1000, ~7 us at the H100's 3.35 TB/s.  But each cell
// also runs ~250 multiply-adds for the moments and an epilogue of about ten
// correctly rounded divisions, sqrtf, acosf and cosf: several hundred
// instructions, which at L=1000 take ~70 us (H100 80GB HBM3, 700 W).  The
// divisions stay IEEE because the plain version, and the reference, divide.
//
// Design: one thread per storage cell in a 32x8 block.  The block stages its
// (8+4) x (32+4) elevation tile, halo included, in shared memory with
// modulo-L wrap, so every elevation value is read from device memory about
// 1.6 times instead of 25 and the TPU version's wrap-padded copy of the
// plane is never made.  Moments accumulate in registers in the plain
// version's (i, j) order, and the epilogue is one __device__ function using
// acosf, sqrtf and cosf.  Built with --fmad=false so every product and sum
// rounds as in the plain version: the eigenvector is picked by float
// equality, and acos near 1 turns one ULP of normal_z into ~3e-4 rad.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kHalo = 2;
constexpr double kPi = 3.14159265358979323846;

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

// features_from_moments + _smallest_eig_normal of kernels/features.py
__device__ void features_from_moments(
    float n, float Sx, float Sy, float Sz, float Sxx, float Syy, float Sxy,
    float Sxz, float Syz, float Szz, float center, float invalid_elevation,
    float invalid_traversability, float inv_slope_critical,
    float inv_rough_critical, float min_neighbors, float* slope_out, float* rough_out,
    float* traver_out, float* nz_out) {
  const float n_safe = fmaxf(n, 1.0f);
  const float xx = Sxx - Sx * Sx / n_safe;
  const float yy = Syy - Sy * Sy / n_safe;
  const float zz = Szz - Sz * Sz / n_safe;
  const float xy = Sxy - Sx * Sy / n_safe;
  const float xz = Sxz - Sx * Sz / n_safe;
  const float yz = Syz - Sy * Sz / n_safe;

  // x / constant is x * (1/constant) rounded to float, as XLA computes it
  // in the JAX reference (gem_tpu_torch/utils/precision.py)
  constexpr float kThird = 1.0f / 3.0f;
  const float q = (xx + yy + zz) * kThird;
  const float p1 = xy * xy + xz * xz + yz * yz;
  const float dx = xx - q, dy = yy - q, dz = zz - q;
  const float p2 = dx * dx + dy * dy + dz * dz + 2.0f * p1;
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
  const Cross v = best == n01 ? c01 : (best == n02 ? c02 : c12);
  const float norm = sqrtf(fmaxf(v.x * v.x + v.y * v.y + v.z * v.z, 1e-30f));
  const bool degenerate = (p2 < 1e-12f) || (best < 1e-20f);
  const float nz = degenerate ? 1.0f : fabsf(v.z) / norm;

  const float slope = acosf(fminf(fmaxf(nz, 0.0f), 1.0f));
  const float rough = fabsf(center - Sz / n_safe);
  const float traver = 0.5f * (1.0f - slope * inv_slope_critical) +
                       0.5f * (1.0f - rough * inv_rough_critical);
  const bool ok = center != invalid_elevation && n >= min_neighbors;
  *slope_out = ok ? slope : 0.0f;
  *rough_out = ok ? rough : 0.0f;
  *traver_out = ok ? traver : invalid_traversability;
  *nz_out = ok ? nz : 1.0f;
}

__global__ void plane_fit_kernel(const float* __restrict__ elev,
                                 const int* __restrict__ start,
                                 float* __restrict__ slope,
                                 float* __restrict__ rough,
                                 float* __restrict__ traver,
                                 float* __restrict__ normal_z,
                                 int* __restrict__ count, int L, double res,
                                 float invalid_elevation,
                                 float invalid_traversability,
                                 float inv_slope_critical,
                                 float inv_rough_critical,
                                 float min_neighbors) {
  __shared__ float tile[kBY + 2 * kHalo][kBX + 2 * kHalo];
  const int r0 = blockIdx.y * kBY;
  const int c0 = blockIdx.x * kBX;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  constexpr int kTileW = kBX + 2 * kHalo;
  constexpr int kTileN = (kBY + 2 * kHalo) * kTileW;
  for (int k = tid; k < kTileN; k += kBX * kBY) {
    const int ty = k / kTileW;
    const int tx = k - ty * kTileW;
    const int r = floor_mod(r0 + ty - kHalo, L);
    const int c = floor_mod(c0 + tx - kHalo, L);
    tile[ty][tx] = elev[static_cast<int64_t>(r) * L + c];
  }
  __syncthreads();

  const int row = r0 + threadIdx.y;
  const int col = c0 + threadIdx.x;
  if (row >= L || col >= L) return;
  const int geo_r = floor_mod(row - start[0] + L, L);
  const int geo_c = floor_mod(col - start[1] + L, L);

  float n = 0.f, Sx = 0.f, Sy = 0.f, Sz = 0.f, Sxx = 0.f, Syy = 0.f;
  float Sxy = 0.f, Sxz = 0.f, Syz = 0.f, Szz = 0.f;
#pragma unroll
  for (int i = -2; i <= 2; ++i) {
    const bool row_ok = geo_r + i >= 0 && geo_r + i < L;
    // the plain version's constants: products formed in double, then
    // rounded to float once
    const double dxd = i * res;
    const float cx = static_cast<float>(dxd);
    const float cxx = static_cast<float>(dxd * dxd);
#pragma unroll
    for (int j = -2; j <= 2; ++j) {
      const bool col_ok = geo_c + j >= 0 && geo_c + j < L;
      const double dyd = j * res;
      const float cy = static_cast<float>(dyd);
      const float cyy = static_cast<float>(dyd * dyd);
      const float cxy = static_cast<float>(dxd * dyd);
      const float z = tile[threadIdx.y + kHalo + i][threadIdx.x + kHalo + j];
      const float m =
          (row_ok && col_ok && z != invalid_elevation) ? 1.0f : 0.0f;
      const float mz = m * z;
      n += m;
      Sx += m * cx;
      Sy += m * cy;
      Sz += mz;
      Sxx += m * cxx;
      Syy += m * cyy;
      Sxy += m * cxy;
      Sxz += mz * cx;
      Syz += mz * cy;
      Szz += mz * z;
    }
  }
  const float center = tile[threadIdx.y + kHalo][threadIdx.x + kHalo];
  const int64_t o = static_cast<int64_t>(row) * L + col;
  features_from_moments(n, Sx, Sy, Sz, Sxx, Syy, Sxy, Sxz, Syz, Szz, center,
                        invalid_elevation, invalid_traversability,
                        inv_slope_critical, inv_rough_critical, min_neighbors,
                        &slope[o], &rough[o], &traver[o], &normal_z[o]);
  count[o] = static_cast<int>(n);
}

}  // namespace

extern "C" int gem_plane_fit_features(
    const void* elev, const void* start, void* slope, void* rough,
    void* traver, void* normal_z, void* count, int L, double res,
    float invalid_elevation, float invalid_traversability,
    float inv_slope_critical, float inv_rough_critical, float min_neighbors,
    void* stream) {
  if (L > 0) {
    const dim3 block(kBX, kBY);
    const dim3 grid((L + kBX - 1) / kBX, (L + kBY - 1) / kBY);
    plane_fit_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(elev), static_cast<const int*>(start),
        static_cast<float*>(slope), static_cast<float*>(rough),
        static_cast<float*>(traver), static_cast<float*>(normal_z),
        static_cast<int*>(count), L, res, invalid_elevation,
        invalid_traversability, inv_slope_critical, inv_rough_critical,
        min_neighbors);
  }
  return static_cast<int>(cudaGetLastError());
}
