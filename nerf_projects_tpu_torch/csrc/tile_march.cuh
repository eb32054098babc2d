// Shared stepping of the Plenoxels tile march, forward (K3,
// tile_march_fwd.cu) and backward (K4, tile_march_bwd.cu).
//
// Both kernels march a ray through the same arithmetic, so they mark
// exactly the same samples valid and active: the backward's running
// suffix (S_total minus the prefix of w * (c . g)) is the forward's only
// if every sample and every transmittance agree bit for bit. What is
// shared:
//   * the per-ray geometry of ops/kernels/tile_march.py::pack_rays;
//   * sample k at tt = T0 + k * dt, and its position og + tt * dg, each
//     formed with __fmul_rn / __fadd_rn so that nvcc fuses nothing and
//     the plain PyTorch version (a separate multiply and add) marks the
//     same samples valid;
//   * the empty-space skip: a sample whose lower corner lies in a brick
//     none of whose upper neighbourhood is occupied reads zeros, and the
//     march jumps past the brick (reach, skip_to);
//   * the 8 corners: the lower corner clamped to [0, reso - 2] and the
//     weights to [0, 1] (a sample on an upper face reads, and receives
//     its gradient in, the last cell, never past the grid), each cell
//     found through the link rows of the lower corner's brick and its
//     upper neighbours (-1 = empty brick). Corner slot s holds, along
//     each axis, the one of the two cells (l, l + 1) whose coordinate has
//     the parity of s's bit for that axis (x: bit 2, y: bit 1, z: bit 0):
//     a cell keeps its slot while it stays a corner;
//   * the interpolated density, summed over the slots in order with
//     explicit fused multiply-adds (an empty corner adds 0, which leaves
//     the sum's bits as they are), with the sigma threshold;
//   * a corner's colour before its decode (its SH line dotted with the
//     tile basis) and the weighted sum of the 8, in the same way; the
//     decode;
//   * tau = sigma * step_world and its running sum, rounded without
//     fusion (__fmul_rn, __fadd_rn) in both kernels;
//   * the compact patches of a tile that a warp marches (patch_ray).

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

// v[s] of the slot s a lane holds, selected without indexing the array
// at run time (which would put it in local memory).
template <typename V>
__device__ __forceinline__ V pick(const V v[8], int s) {
  V x = v[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) x = s == c ? v[c] : x;
  return x;
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

// ---------------------------------------------------------------------------
// The empty-space skip
// ---------------------------------------------------------------------------

constexpr float SKIP_EPS = 1.f / 128.f;  // cells: a skip stays this far inside its brick

// The link row of each corner slot from the link rows nb of the lower
// corner's brick and its upper neighbours: along an axis only the corner
// l + 1 of a lower corner on the brick's last cell (l & 7 == 7) lies in
// the next brick. Selected axis by axis, so that no register array is
// indexed at run time.
__device__ __forceinline__ void corner_rows(const int nb[8], int lx, int ly, int lz, int rows[8]) {
  const bool ex = (lx & 7) == 7, ey = (ly & 7) == 7, ez = (lz & 7) == 7;
  int a[2][4], b[2][2][2];
#pragma unroll
  for (int px = 0; px < 2; ++px) {
    const bool up = ex && ((px ^ lx) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[px][j] = up ? nb[4 + j] : nb[j];
  }
#pragma unroll
  for (int px = 0; px < 2; ++px)
#pragma unroll
    for (int py = 0; py < 2; ++py) {
      const bool up = ey && ((py ^ ly) & 1);
      b[px][py][0] = up ? a[px][2] : a[px][0];
      b[px][py][1] = up ? a[px][3] : a[px][1];
    }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool up = ez && (((c & 1) ^ lz) & 1);
    rows[c] = up ? b[c >> 2][(c >> 1) & 1][1] : b[c >> 2][(c >> 1) & 1][0];
  }
}

// The link rows of bricks (bx, by, bz) + {0, 1}^3, nb[4 dx + 2 dy + dz],
// each index clamped to the last brick that holds a cell of the grid.
// True if one of them is occupied: a sample whose lower corner lies in
// the brick can read data.
__device__ __forceinline__ bool neighbourhood(const Grid& g, int bx, int by, int bz, int nb[8]) {
  const int mx = (g.X - 1) >> 3, my = (g.Y - 1) >> 3, mz = (g.Z - 1) >> 3;
  bool any = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int x = min(bx + (c >> 2), mx), y = min(by + ((c >> 1) & 1), my), z = min(bz + (c & 1), mz);
    nb[c] = __ldg(g.links + (x * g.BY + y) * g.BZ + z);
    any |= nb[c] >= 0;
  }
  return any;
}

// A ray's state for the skip: its reciprocal direction and step, the
// brick of its last lower corner and that brick's neighbourhood.
struct Skip {
  float ix, iy, iz, idt;
  int bx, by, bz;
  int nb[8];  // the neighbourhood's link rows
  bool reach;
};

__device__ __forceinline__ Skip skip_start(const Ray& r) {
  Skip s;
  s.ix = 1.f / r.dx;
  s.iy = 1.f / r.dy;
  s.iz = 1.f / r.dz;
  s.idt = 1.f / r.dt;
  s.bx = s.by = s.bz = -1;
  s.reach = false;
  return s;
}

// Whether a sample whose clamped lower corner is (lx, ly, lz) can read
// data: the link rows are loaded once per brick the lower corner enters.
__device__ __forceinline__ bool reach(const Grid& g, int lx, int ly, int lz, Skip& s) {
  if ((lx >> 3) != s.bx || (ly >> 3) != s.by || (lz >> 3) != s.bz) {
    s.bx = lx >> 3;
    s.by = ly >> 3;
    s.bz = lz >> 3;
    s.reach = neighbourhood(g, s.bx, s.by, s.bz, s.nb);
  }
  return s.reach;
}

// The t at which the ray (origin o, direction d, inv = 1 / d) leaves
// [8 b + SKIP_EPS, 8 b + 8 - SKIP_EPS] along one axis (INFINITY if it does
// not move along it); clears inside if the position p is not in that span.
__device__ __forceinline__ float axis_exit(float o, float d, float inv, float p, int b, bool& inside) {
  const float lo = static_cast<float>(8 * b) + SKIP_EPS, hi = static_cast<float>(8 * b + 8) - SKIP_EPS;
  inside = inside && p >= lo && p <= hi;
  if (d > 0.f) return __fmul_rn(__fsub_rn(hi, o), inv);
  if (d < 0.f) return __fmul_rn(__fsub_rn(lo, o), inv);
  return INFINITY;
}

// Sample k at (px, py, pz) lies in a brick that reach() found empty
// around: sigma is 0 there and on every later sample whose lower corner
// stays in the brick, so they add nothing. The step to continue from
// (the loop adds one): the last one before the ray leaves the brick
// shrunk by SKIP_EPS on every face (sample positions carry ~1e-4 cells of
// rounding, far below the margin), or k itself if the sample is not that
// far inside.
__device__ __forceinline__ int skip_to(const Ray& r, const Skip& s, float px, float py, float pz, int k,
                                       int max_steps) {
  bool inside = true;
  const float tx = axis_exit(r.ox, r.dx, s.ix, px, s.bx, inside);
  const float ty = axis_exit(r.oy, r.dy, s.iy, py, s.by, inside);
  const float tz = axis_exit(r.oz, r.dz, s.iz, pz, s.bz, inside);
  if (inside) {
    const float kf = floorf(__fmul_rn(__fsub_rn(fminf(tx, fminf(ty, tz)), r.T0), s.idt));
    if (kf > static_cast<float>(k)) k = static_cast<int>(fminf(kf, static_cast<float>(max_steps - 1)));
  }
  return k;
}

// ---------------------------------------------------------------------------
// Rays to warps
// ---------------------------------------------------------------------------

// The ray that unit u marches (a thread in K3, a group of lanes in K4):
// with tile_w, each run of PH * PW units takes a patch of PH rows of PW
// rays of its tile, the tile read as rows of tile_w rays; else ray u.
template <int PH, int PW>
__device__ __forceinline__ long long patch_ray(long long u, int r, int tile_w) {
  constexpr int P = PH * PW;
  static_assert((P & (P - 1)) == 0, "a patch holds a power of two of rays");
  constexpr int LOG_P = P == 32 ? 5 : P == 16 ? 4 : P == 8 ? 3 : P == 4 ? 2 : P == 2 ? 1 : 0;
  if (!tile_w) return u;
  const long long gw = u >> LOG_P, wpt = r >> LOG_P, tile = gw / wpt;
  const int wi = static_cast<int>(gw - tile * wpt), lane = static_cast<int>(u & (P - 1)), cols = tile_w / PW;
  return tile * r + ((wi / cols) * PH + lane / PW) * tile_w + (wi % cols) * PW + lane % PW;
}

// The tile width patch_ray takes: the largest power of two w with w^2 <=
// 2r (32 for the frame path's 16x32 tiles, 16 for 8x16 and 16x16), if the
// tile then splits into whole patches; else 0 (rays in order).
template <int PH, int PW>
inline int patch_tile_width(int r) {
  int w = 1;
  while (4 * w * w <= 2 * r) w *= 2;
  return r % w == 0 && (r / w) % PH == 0 && w % PW == 0 ? w : 0;
}

}  // namespace tile_march
