// Shared stepping of the Plenoxels tile march, forward (K3,
// tile_march_fwd.cu) and backward (K4, tile_march_bwd.cu).
//
// Both kernels march a ray with one thread through the same arithmetic,
// so they mark exactly the same samples valid and active: the backward's
// running suffix (S_total minus the prefix of w * (c . g)) is the
// forward's only if every sample and every transmittance agree bit for
// bit. What is shared:
//   * the per-ray geometry of ops/kernels/tile_march.py::pack_rays;
//   * sample k at tt = T0 + k * dt, and its position og + tt * dg, each
//     formed with __fmul_rn / __fadd_rn so that nvcc fuses nothing and
//     the plain PyTorch version (a separate multiply and add) marks the
//     same samples valid;
//   * the 8 corners: the lower corner clamped to [0, reso - 2] and the
//     weights to [0, 1] (a sample on an upper face reads, and receives
//     its gradient in, the last cell, never past the grid), each cell
//     found through brick_links (-1 = empty brick). Corner slot s holds,
//     along each axis, the one of the two cells (l, l + 1) whose
//     coordinate has the parity of s's bit for that axis (x: bit 2, y:
//     bit 1, z: bit 0): a cell keeps its slot while it stays a corner
//     (K3 finds the cells through the link rows of the lower corner's
//     brick and its upper neighbours, K4 reads brick_links directly);
//   * the interpolated density, summed over the slots in order with
//     explicit fused multiply-adds (an empty corner adds 0, which leaves
//     the sum's bits as they are), with the sigma threshold;
//   * a corner's colour before its decode (its SH line dotted with the
//     tile basis) and the weighted sum of the 8, in the same way; the
//     decode;
//   * tau = sigma * step_world and its running sum, rounded without
//     fusion (__fmul_rn, __fadd_rn) in both kernels.

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

__device__ __forceinline__ void position(const Ray& r, float tt, float& px, float& py, float& pz) {
  px = __fadd_rn(r.ox, __fmul_rn(tt, r.dx));
  py = __fadd_rn(r.oy, __fmul_rn(tt, r.dy));
  pz = __fadd_rn(r.oz, __fmul_rn(tt, r.dz));
}

// The clamped lower corner of a position, and the fractions toward the
// upper corner in [0, 1].
__device__ __forceinline__ void lower_corner(const Grid& g, float px, float py, float pz, int& lx, int& ly,
                                             int& lz, float& wx, float& wy, float& wz) {
  lx = clampi(static_cast<int>(floorf(px)), 0, g.X - 2);
  ly = clampi(static_cast<int>(floorf(py)), 0, g.Y - 2);
  lz = clampi(static_cast<int>(floorf(pz)), 0, g.Z - 2);
  wx = fminf(fmaxf(px - static_cast<float>(lx), 0.f), 1.f);
  wy = fminf(fmaxf(py - static_cast<float>(ly), 0.f), 1.f);
  wz = fminf(fmaxf(pz - static_cast<float>(lz), 0.f), 1.f);
}

// Along one axis, the corner coordinate (l or l + 1) of the given parity.
__device__ __forceinline__ int slot_coord(int l, int parity) { return l + ((parity ^ l) & 1); }

// The trilinear weight of each corner slot.
__device__ __forceinline__ void corner_weights(int lx, int ly, int lz, float wx, float wy, float wz, float cw[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const bool ux = ((s >> 2) ^ lx) & 1, uy = (((s >> 1) & 1) ^ ly) & 1, uz = ((s & 1) ^ lz) & 1;
    cw[s] = (ux ? wx : 1.f - wx) * (uy ? wy : 1.f - wy) * (uz ? wz : 1.f - wz);
  }
}

// A cell's index inside its 8^3 brick.
__device__ __forceinline__ int cell_in_brick(int cx, int cy, int cz) {
  return ((cx & 7) * 64 + (cy & 7) * 8 + (cz & 7));
}

// sum over the corner slots of cw * v, in slot order.
__device__ __forceinline__ float corner_sum(const float cw[8], const float v[8]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s = __fmaf_rn(cw[c], v[c], s);
  return s;
}

// A corner's colour before the decode: col[ch] = sum over b of basis_b *
// sh[ch * B + b] of the cell's line, read as 16-byte vectors.
template <int B>
__device__ __forceinline__ void corner_colour(const __nv_bfloat16* cell, const float basis[B], float col[3]) {
  constexpr int NV = Layout<B>::NV;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  const uint4* src = reinterpret_cast<const uint4*>(cell);
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
      if (j / B == 0) c0 = __fmaf_rn(basis[j % B], val, c0);
      else if (j / B == 1) c1 = __fmaf_rn(basis[j % B], val, c1);
      else c2 = __fmaf_rn(basis[j % B], val, c2);
    }
  }
  col[0] = c0;
  col[1] = c1;
  col[2] = c2;
}

// The 8 corner slots of the sample at tt: the element offset of each
// corner cell in `cells` (-1 when its brick is empty) and its trilinear
// weight. Returns the interpolated density, 0 at or below sigma_thresh.
template <int CP>
__device__ __forceinline__ float corners(const Grid& g, const Ray& r, float tt, float sigma_thresh,
                                         long long off[8], float cw[8]) {
  float px, py, pz, wx, wy, wz;
  int lx, ly, lz;
  position(r, tt, px, py, pz);
  lower_corner(g, px, py, pz, lx, ly, lz, wx, wy, wz);
  corner_weights(lx, ly, lz, wx, wy, wz, cw);
  float dens[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = slot_coord(lx, c >> 2), cy = slot_coord(ly, (c >> 1) & 1), cz = slot_coord(lz, c & 1);
    const int row = __ldg(g.links + ((cx >> 3) * g.BY + (cy >> 3)) * g.BZ + (cz >> 3));
    off[c] = -1;
    dens[c] = 0.f;
    if (row >= 0) {
      off[c] = (static_cast<long long>(row) * CELLS + cell_in_brick(cx, cy, cz)) * CP;
      dens[c] = __bfloat162float(g.cells[off[c]]);
    }
  }
  const float sigma = corner_sum(cw, dens);
  return sigma > sigma_thresh ? sigma : 0.f;
}

// The sample's colour before its decode: the corners' colours weighted
// (corner_sum's order; an empty corner adds 0).
template <int B>
__device__ __forceinline__ void shade(const Grid& g, const long long off[8], const float cw[8],
                                      const float basis[B], float raw[3]) {
  float col[3][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float cc[3] = {0.f, 0.f, 0.f};
    if (off[c] >= 0) corner_colour<B>(g.cells + off[c], basis, cc);
    col[0][c] = cc[0];
    col[1][c] = cc[1];
    col[2][c] = cc[2];
  }
  raw[0] = corner_sum(cw, col[0]);
  raw[1] = corner_sum(cw, col[1]);
  raw[2] = corner_sum(cw, col[2]);
}

// rgb = max(raw + 0.5, 0), or a sigmoid.
__device__ __forceinline__ float decode(float raw, int sigmoid) {
  return sigmoid ? 1.f / (1.f + expf(-raw)) : fmaxf(raw + 0.5f, 0.f);
}

}  // namespace tile_march
