// Plenoxels tile march, forward (K3), for Hopper (sm_90a): trilinear
// density and SH colour from a brick grid, alpha compositing, float32
// sums over bf16 cells.
//
// Replaces: nerf_projects_tpu/ops/pallas/tile_march.py::_make_fwd_kernel
// as launched by _march_group and _march_frame_group (entries
// render_tiles_pallas and frame_march.py::render_frame_pallas). The
// function per tile of r rays (the geometry comes from
// ops/kernels/tile_march.py::pack_rays, which follows _pack_rays):
//   * sample k of a ray lies at tt = T0 + k * dt (T0 the tile's least
//     entry), in float32 with the product rounded before the sum, and
//     counts where t0 <= tt < t1 and k < max_steps;
//   * density and the 3B SH coefficients are interpolated from the 8
//     cells around the sample; an empty brick (brick_links < 0) and an
//     inactive cell (stored as zeros) read 0; the lower corner is
//     clamped to [0, reso - 2] with weights in [0, 1], so a sample on the
//     upper face reads the last cell and never past the grid;
//   * sigma at or below sigma_thresh reads 0; rgb = max(sum_b basis_b *
//     sh_b + 0.5, 0) or a sigmoid, with the tile's basis (mean view
//     direction);
//   * tau = sigma * step_world; T = exp(-sum of earlier tau); while
//     T > stop_thresh: w = T * (1 - exp(-tau)) adds w * rgb, w, w * tt and
//     tau to rgb, acc, depth and -log_transmit; log1p(2 sigma^2) adds to
//     the sparsity sum on every valid sample, or, with early_stop, the
//     ray ends at the first sample whose T is at or below stop_thresh.
// Output per tile [8, r] float32 as the TPU kernel's out block: rgb (3),
// acc, depth_t, -log_transmit, sparsity, misses (always 0: every sample
// is read, none is dropped).
//
// Bound: the float operations the function needs (FLOPS_PER_SAMPLE and
// flops_per_shaded in ops/kernels/tile_march.py: 50 a marched sample,
// 54B + 21 a shaded one, 507 for B = 9), against the live bytes of the
// bricks it touches (1 + 3B bf16 channels a cell) read once from HBM;
// neighbouring samples and rays share cells in L1/L2, so the operations
// bound a frame at the card's float32 rate.
//
// Design: a thread marches one ray, sample by sample, and stops as soon
// as the ray leaves its interval (or, with early_stop, its transmittance
// falls below stop_thresh). The rays of a tile are consecutive threads,
// so a warp's samples cluster in a few bricks and share cache lines. The
// TPU's 2x2x2-brick windows, chunk plan, sentinel row, triangular prefix
// matmul and x3-interleaved packed layout exist to feed Mosaic's DMA and
// MXU; here each corner is a direct read through brick_links, so any
// brick is reachable and no sample is dropped. A cell keeps its 1 + 3B
// channels together (density first, then SH in c * B + b order), bf16,
// padded to a multiple of 8 channels: one 64-byte line for B = 9, read
// as 16-byte vectors. Density is read first from the 8 corners; the SH
// lines are read only for a sample with sigma > 0 whose ray is still
// active, decoded per corner with the tile basis and weighted. Empty
// space still costs its 8 link reads per sample; skipping it by bricks
// is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PACK = 12;   // per-ray floats, see ops/kernels/tile_march.py
constexpr int CELLS = 512; // cells per 8^3 brick

struct Params {
  const __nv_bfloat16* cells;  // [nb, 512, CP]
  const int* links;            // [BX, BY, BZ]
  const float* pack;           // [n_rays, PACK]
  const float* basis;          // [n_rays / r, B]
  float* out;                  // [n_rays / r, 8, r]
  long long n_rays;
  int r, X, Y, Z, BY, BZ, max_steps, sigmoid, early_stop;
  float sigma_thresh, stop_thresh;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

template <int B>
__global__ void __launch_bounds__(128) march_kernel(const Params p) {
  constexpr int CP = ((1 + 3 * B + 7) / 8) * 8;
  constexpr int NV = CP / 8;  // 16-byte vectors per cell
  const long long ray = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= p.n_rays) return;
  const long long tile = ray / p.r;
  const int lane = static_cast<int>(ray - tile * p.r);

  const float* pk = p.pack + ray * PACK;
  const float ox = pk[0], oy = pk[1], oz = pk[2];
  const float dx = pk[3], dy = pk[4], dz = pk[5];
  const float dt = pk[6], t0 = pk[7], t1 = pk[8], T0 = pk[9], step_world = pk[10];
  float basis[B];
#pragma unroll
  for (int b = 0; b < B; ++b) basis[b] = p.basis[tile * B + b];

  float rgb0 = 0.f, rgb1 = 0.f, rgb2 = 0.f, acc = 0.f, depth = 0.f, cum = 0.f, spars = 0.f;
  if (t1 > t0) {
    // first candidate step, a little before the entry; the predicate
    // below decides exactly as the plain version does
    const float kf = floorf((t0 - T0) / dt) - 2.f;
    int k = kf > 0.f ? static_cast<int>(fminf(kf, static_cast<float>(p.max_steps))) : 0;
    for (; k < p.max_steps; ++k) {
      const float tt = __fadd_rn(T0, __fmul_rn(static_cast<float>(k), dt));
      if (tt < t0) continue;
      if (!(tt < t1)) break;
      const float px = __fadd_rn(ox, __fmul_rn(tt, dx));
      const float py = __fadd_rn(oy, __fmul_rn(tt, dy));
      const float pz = __fadd_rn(oz, __fmul_rn(tt, dz));
      const int lx = clampi(static_cast<int>(floorf(px)), 0, p.X - 2);
      const int ly = clampi(static_cast<int>(floorf(py)), 0, p.Y - 2);
      const int lz = clampi(static_cast<int>(floorf(pz)), 0, p.Z - 2);
      const float wx = fminf(fmaxf(px - static_cast<float>(lx), 0.f), 1.f);
      const float wy = fminf(fmaxf(py - static_cast<float>(ly), 0.f), 1.f);
      const float wz = fminf(fmaxf(pz - static_cast<float>(lz), 0.f), 1.f);

      long long off[8];  // element offset of each corner cell, -1 when empty
      float cw[8];
      float sigma = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cx = lx + (c >> 2), cy = ly + ((c >> 1) & 1), cz = lz + (c & 1);
        cw[c] = ((c >> 2) ? wx : 1.f - wx) * (((c >> 1) & 1) ? wy : 1.f - wy) * ((c & 1) ? wz : 1.f - wz);
        const int row = __ldg(p.links + ((cx >> 3) * p.BY + (cy >> 3)) * p.BZ + (cz >> 3));
        off[c] = -1;
        if (row >= 0) {
          off[c] = (static_cast<long long>(row) * CELLS + ((cx & 7) * 64 + (cy & 7) * 8 + (cz & 7))) * CP;
          sigma += cw[c] * __bfloat162float(p.cells[off[c]]);
        }
      }
      if (!(sigma > p.sigma_thresh)) sigma = 0.f;
      const float T = expf(-cum);
      const bool active = T > p.stop_thresh;
      if (!active && p.early_stop) break;
      spars += log1pf(2.f * sigma * sigma);
      if (!active || sigma == 0.f) continue;

      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (off[c] < 0) continue;
        float wb[B];
#pragma unroll
        for (int b = 0; b < B; ++b) wb[b] = cw[c] * basis[b];
        const uint4* src = reinterpret_cast<const uint4*>(p.cells + off[c]);
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
      if (p.sigmoid) {
        c0 = 1.f / (1.f + expf(-c0));
        c1 = 1.f / (1.f + expf(-c1));
        c2 = 1.f / (1.f + expf(-c2));
      } else {
        c0 = fmaxf(c0 + 0.5f, 0.f);
        c1 = fmaxf(c1 + 0.5f, 0.f);
        c2 = fmaxf(c2 + 0.5f, 0.f);
      }
      const float tau = sigma * step_world;
      const float w = T * (1.f - expf(-tau));
      rgb0 += w * c0;
      rgb1 += w * c1;
      rgb2 += w * c2;
      acc += w;
      depth += w * tt;
      cum += tau;
    }
  }
  float* o = p.out + tile * 8 * p.r + lane;
  o[0 * p.r] = rgb0;
  o[1 * p.r] = rgb1;
  o[2 * p.r] = rgb2;
  o[3 * p.r] = acc;
  o[4 * p.r] = depth;
  o[5 * p.r] = cum;
  o[6 * p.r] = spars;
  o[7 * p.r] = 0.f;
}

template <int B>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int threads = 128;
  const long long blocks = (p.n_rays + threads - 1) / threads;
  march_kernel<B><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tile_march_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Channels a cell holds for basis_dim B: 1 + 3B padded to a multiple of 8.
int tile_march_fwd_channels(int basis_dim) { return ((1 + 3 * basis_dim + 7) / 8) * 8; }

// cells bf16 [nb, 512, channels], links int32 [BX, BY, BZ], pack float32
// [n_rays, 12], basis float32 [n_rays / r, basis_dim], out float32
// [n_rays / r, 8, r]. Launched on `stream`; returns the CUDA error of the
// launch, 0 on success, cudaErrorInvalidValue for a basis_dim other than
// 1, 4, 9, 16, 25.
int tile_march_fwd(const void* cells, const void* links, const void* pack, const void* basis,
                   void* out, long long n_rays, int r, int X, int Y, int Z, int BY, int BZ,
                   int basis_dim, int max_steps, float sigma_thresh, float stop_thresh, int sigmoid,
                   int early_stop, void* stream) {
  if (n_rays <= 0) return 0;
  Params p;
  p.cells = static_cast<const __nv_bfloat16*>(cells);
  p.links = static_cast<const int*>(links);
  p.pack = static_cast<const float*>(pack);
  p.basis = static_cast<const float*>(basis);
  p.out = static_cast<float*>(out);
  p.n_rays = n_rays;
  p.r = r;
  p.X = X;
  p.Y = Y;
  p.Z = Z;
  p.BY = BY;
  p.BZ = BZ;
  p.max_steps = max_steps;
  p.sigma_thresh = sigma_thresh;
  p.stop_thresh = stop_thresh;
  p.sigmoid = sigmoid;
  p.early_stop = early_stop;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis_dim) {
    case 1: return static_cast<int>(launch<1>(p, s));
    case 4: return static_cast<int>(launch<4>(p, s));
    case 9: return static_cast<int>(launch<9>(p, s));
    case 16: return static_cast<int>(launch<16>(p, s));
    case 25: return static_cast<int>(launch<25>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
