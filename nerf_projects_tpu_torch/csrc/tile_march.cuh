// Shared stepping of the Plenoxels tile march, forward (K3,
// tile_march_fwd.cu) and backward (K4, tile_march_bwd.cu).
//
// Both kernels march a ray with one thread through the same code, so they
// mark exactly the same samples valid and active: the backward's running
// suffix (S_total minus the prefix of w * (c . g)) is the forward's only
// if every sample and every transmittance agree bit for bit. What is
// shared:
//   * the per-ray geometry of ops/kernels/tile_march.py::pack_rays;
//   * sample k at tt = T0 + k * dt, and its position og + tt * dg, each
//     formed with __fmul_rn / __fadd_rn so that nvcc fuses nothing and
//     the plain PyTorch version (a separate multiply and add) marks the
//     same samples valid;
//   * the 8 corners: the lower corner clamped to [0, reso - 2] and the
//     weights to [0, 1] (a sample on an upper face reads, and receives
//     its gradient in, the last cell, never past the grid), each cell
//     found through brick_links (-1 = empty brick);
//   * the interpolated density with the sigma threshold;
//   * the tile basis' SH colour before its decode, and the decode.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_march {

constexpr int PACK = 12;    // per-ray floats, see ops/kernels/tile_march.py
constexpr int CELLS = 512;  // cells per 8^3 brick

template <int B>
struct Layout {
  static constexpr int CP = ((1 + 3 * B + 7) / 8) * 8;  // channels a cell holds
  static constexpr int NV = CP / 8;                     // 16-byte vectors per cell
};

struct Grid {
  const __nv_bfloat16* cells;  // [nb, 512, CP]
  const int* links;            // [BX, BY, BZ]
  int X, Y, Z, BY, BZ;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, dt, t0, t1, T0, step_world;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ Ray load_ray(const float* pack, long long ray) {
  const float* pk = pack + ray * PACK;
  Ray r;
  r.ox = pk[0];
  r.oy = pk[1];
  r.oz = pk[2];
  r.dx = pk[3];
  r.dy = pk[4];
  r.dz = pk[5];
  r.dt = pk[6];
  r.t0 = pk[7];
  r.t1 = pk[8];
  r.T0 = pk[9];
  r.step_world = pk[10];
  return r;
}

// First candidate step, a little before the entry; the predicate
// t0 <= tt < t1 at each step decides exactly, as the plain version does.
__device__ __forceinline__ int first_step(const Ray& r, int max_steps) {
  const float kf = floorf((r.t0 - r.T0) / r.dt) - 2.f;
  return kf > 0.f ? static_cast<int>(fminf(kf, static_cast<float>(max_steps))) : 0;
}

__device__ __forceinline__ float sample_t(const Ray& r, int k) {
  return __fadd_rn(r.T0, __fmul_rn(static_cast<float>(k), r.dt));
}

// The 8 corners of the sample at tt: the element offset of each corner
// cell in `cells` (-1 when its brick is empty) and its trilinear weight.
// Returns the interpolated density, 0 at or below sigma_thresh.
template <int CP>
__device__ __forceinline__ float corners(const Grid& g, const Ray& r, float tt, float sigma_thresh,
                                         long long off[8], float cw[8]) {
  const float px = __fadd_rn(r.ox, __fmul_rn(tt, r.dx));
  const float py = __fadd_rn(r.oy, __fmul_rn(tt, r.dy));
  const float pz = __fadd_rn(r.oz, __fmul_rn(tt, r.dz));
  const int lx = clampi(static_cast<int>(floorf(px)), 0, g.X - 2);
  const int ly = clampi(static_cast<int>(floorf(py)), 0, g.Y - 2);
  const int lz = clampi(static_cast<int>(floorf(pz)), 0, g.Z - 2);
  const float wx = fminf(fmaxf(px - static_cast<float>(lx), 0.f), 1.f);
  const float wy = fminf(fmaxf(py - static_cast<float>(ly), 0.f), 1.f);
  const float wz = fminf(fmaxf(pz - static_cast<float>(lz), 0.f), 1.f);
  float sigma = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = lx + (c >> 2), cy = ly + ((c >> 1) & 1), cz = lz + (c & 1);
    cw[c] = ((c >> 2) ? wx : 1.f - wx) * (((c >> 1) & 1) ? wy : 1.f - wy) * ((c & 1) ? wz : 1.f - wz);
    const int row = __ldg(g.links + ((cx >> 3) * g.BY + (cy >> 3)) * g.BZ + (cz >> 3));
    off[c] = -1;
    if (row >= 0) {
      off[c] = (static_cast<long long>(row) * CELLS + ((cx & 7) * 64 + (cy & 7) * 8 + (cz & 7))) * CP;
      sigma += cw[c] * __bfloat162float(g.cells[off[c]]);
    }
  }
  return sigma > sigma_thresh ? sigma : 0.f;
}

// The sample's SH colour before its decode (raw[ch] = sum over corners
// and b of cw * basis_b * sh[ch * B + b]), read as 16-byte vectors.
template <int B>
__device__ __forceinline__ void shade(const Grid& g, const long long off[8], const float cw[8],
                                      const float basis[B], float raw[3]) {
  constexpr int NV = Layout<B>::NV;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (off[c] < 0) continue;
    float wb[B];
#pragma unroll
    for (int b = 0; b < B; ++b) wb[b] = cw[c] * basis[b];
    const uint4* src = reinterpret_cast<const uint4*>(g.cells + off[c]);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint4 q = __ldg(src + v);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = v * 8 + e - 1;  // SH channel index (c * B + b), -1 = density
        if (j < 0 || j >= 3 * B) continue;
        const float2 f = __bfloat1622float2(h[e >> 1]);
        const float val = (e & 1) ? f.y : f.x;
        if (j / B == 0) c0 += wb[j % B] * val;
        else if (j / B == 1) c1 += wb[j % B] * val;
        else c2 += wb[j % B] * val;
      }
    }
  }
  raw[0] = c0;
  raw[1] = c1;
  raw[2] = c2;
}

// rgb = max(raw + 0.5, 0), or a sigmoid.
__device__ __forceinline__ float decode(float raw, int sigmoid) {
  return sigmoid ? 1.f / (1.f + expf(-raw)) : fmaxf(raw + 0.5f, 0.f);
}

}  // namespace tile_march
