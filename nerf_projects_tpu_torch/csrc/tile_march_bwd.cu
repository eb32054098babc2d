// Plenoxels tile march, backward (K4), for Hopper (sm_90a): the density
// and SH gradients of the MSE, beta and Cauchy sparsity losses of the
// march (K3, tile_march_fwd.cu), float32, added into the brick arrays.
//
// Replaces: nerf_projects_tpu/ops/pallas/tile_march.py::_make_bwd_kernel
// as launched by _bwd_group and _bwd_frame_group (entry
// render_fused_tiles_pallas). The function per ray, given the loss
// gradient g = dL/d rgb_out and the suffix seed S_total = g . rgb_out
// (plus the beta term), both from ops/kernels/tile_march.py:
//   * re-march the ray in forward order through tile_march.cuh, the
//     stepping that K3 runs, so the two see the same samples, densities
//     and transmittances T_i;
//   * on a shaded sample (valid, active: T_i > stop_thresh, sigma above
//     sigma_thresh): w_i = T_i (1 - e^{-tau_i}), the running inclusive
//     sum P_i of w_j (c_j . g), suffix_i = S_total - P_i, and
//       dL/dtau_i = T_i e^{-tau_i} (c_i . g) - suffix_i,
//       g_sigma  += dL/dtau_i * step_world,
//       g_rgb     = w_i * g * decode'(raw),
//     decode' the +0.5 clamp's indicator, or rgb (1 - rgb) for sigmoid;
//   * on every valid sample with sigma above sigma_thresh, active or not:
//     g_sigma += sparsity_scale * 4 sigma / (1 + 2 sigma^2);
//   * add cw * g_sigma to grad_density and cw * g_rgb[ch] * basis_b to
//     grad_sh[ch * B + b] of each of the 8 corner cells (cw its
//     trilinear weight), skipping corners in empty bricks. A sample on an
//     upper face adds to the clamped last cell, as K3 reads it.
// These are the formulas of tile_march.py:1443-1496.
//
// A ray ends where it leaves [t0, t1) or after max_steps, or, when
// sparsity_scale is 0, at its first inactive sample: past it neither w
// nor the sparsity term adds anything. With sparsity on, the sparsity
// gradient goes on to the ray's exit, as the TPU kernel gates it only by
// validity and the threshold.
//
// Bound: on one training batch the gradient arrays dominate: the touched
// bricks' live cells (1 + 3B bf16 channels) read once and the float32
// gradient arrays written once; the float operations (the re-march's,
// plus the backward's per shaded sample and per corner, itemised in
// ops/kernels/tile_march.py) are a fraction of that at the float32 rate.
//
// Design: the TPU kernel reads the forward's per-sample stream and emits
// per-(tile, chunk, corner) gradient blocks in 2x2x2-brick windows that
// XLA scatter-adds afterwards. Here a thread re-marches its ray (svox2's
// render_ray_backward pattern), so K3's serving path writes no stream,
// and adds each corner's 1 + 3B gradients straight into the brick arrays
// in their own layout with float32 atomicAdd (no relayout, no blocks).
// The rays of a tile are consecutive threads, so a warp's atomics fall on
// a few bricks and collide: 8 x (1 + 3B) per shaded sample, 224 at B = 9.
// Pre-reducing them within a warp, or vector red.global.add.v4.f32, is
// later speed work. tile_march_bwd_probe runs the same kernel with each
// would-be atomic summed into one float a ray instead, to time what the
// atomics cost.

#include "tile_march.cuh"

namespace {

using namespace tile_march;

struct Params {
  Grid g;
  const float* pack;      // [n_rays, PACK]
  const float* basis;     // [n_rays / r, B]
  const float* grad_rgb;  // [n_rays, 3]: dL / d rgb_out
  const float* s_total;   // [n_rays]: the suffix seed
  float* grad_density;    // [nb, 512]
  float* grad_sh;         // [nb, 512, 3B]
  float* sink;            // [n_rays], the probe's output (SCATTER false)
  long long n_rays;
  int r, max_steps, sigmoid;
  float sigma_thresh, stop_thresh, sparsity_scale;
};

template <int B, bool SCATTER>
__global__ void __launch_bounds__(128) march_bwd_kernel(const Params p) {
  constexpr int CP = Layout<B>::CP;
  const long long ray = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= p.n_rays) return;
  const long long tile = ray / p.r;

  const Ray r = load_ray(p.pack, ray);
  float basis[B];
#pragma unroll
  for (int b = 0; b < B; ++b) basis[b] = p.basis[tile * B + b];
  const float g0 = p.grad_rgb[ray * 3 + 0], g1 = p.grad_rgb[ray * 3 + 1], g2 = p.grad_rgb[ray * 3 + 2];
  const float s_total = p.s_total[ray];

  float cum = 0.f;    // -log T: the prefix of tau over the active samples, as K3's
  float P = 0.f;      // inclusive prefix of w (c . g)
  float probe = 0.f;  // SCATTER false: the sum of the would-be atomics
  if (r.t1 > r.t0) {
    for (int k = first_step(r, p.max_steps); k < p.max_steps; ++k) {
      const float tt = sample_t(r, k);
      if (tt < r.t0) continue;
      if (!(tt < r.t1)) break;
      long long off[8];  // element offset of each corner cell, -1 when empty
      float cw[8];
      const float sigma = corners<CP>(p.g, r, tt, p.sigma_thresh, off, cw);
      const float T = expf(-cum);
      const bool active = T > p.stop_thresh;
      if (!active && p.sparsity_scale == 0.f) break;
      if (sigma == 0.f) continue;  // at or below the threshold: no gradient

      float gsig = p.sparsity_scale * (4.f * sigma / (1.f + 2.f * sigma * sigma));
      float gr[3] = {0.f, 0.f, 0.f};  // dL / d raw colour
      if (active) {
        float raw[3];
        shade<B>(p.g, off, cw, basis, raw);
        const float c0 = decode(raw[0], p.sigmoid);
        const float c1 = decode(raw[1], p.sigmoid);
        const float c2 = decode(raw[2], p.sigmoid);
        const float tau = sigma * r.step_world;
        const float e = expf(-tau);
        const float w = T * (1.f - e);
        const float cdotg = c0 * g0 + c1 * g1 + c2 * g2;
        P += w * cdotg;
        const float gtau = T * e * cdotg - (s_total - P);
        gsig += gtau * r.step_world;
        const float d0 = p.sigmoid ? c0 * (1.f - c0) : (raw[0] + 0.5f > 0.f ? 1.f : 0.f);
        const float d1 = p.sigmoid ? c1 * (1.f - c1) : (raw[1] + 0.5f > 0.f ? 1.f : 0.f);
        const float d2 = p.sigmoid ? c2 * (1.f - c2) : (raw[2] + 0.5f > 0.f ? 1.f : 0.f);
        gr[0] = w * g0 * d0;
        gr[1] = w * g1 * d1;
        gr[2] = w * g2 * d2;
        cum += tau;
      }

#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (off[c] < 0) continue;
        const long long cell = off[c] / CP;  // row * 512 + cell in the brick
        if (SCATTER) atomicAdd(p.grad_density + cell, cw[c] * gsig);
        else probe += cw[c] * gsig;
        if (!active) continue;
        float* dst = p.grad_sh + cell * (3 * B);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float cg = cw[c] * gr[ch];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            if (SCATTER) atomicAdd(dst + ch * B + b, cg * basis[b]);
            else probe += cg * basis[b];
          }
        }
      }
    }
  }
  if (!SCATTER) p.sink[ray] = probe;
}

template <int B>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int threads = 128;
  const long long blocks = (p.n_rays + threads - 1) / threads;
  if (p.sink) march_bwd_kernel<B, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(p);
  else march_bwd_kernel<B, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(p);
  return cudaGetLastError();
}

int run(Params& p, const void* cells, const void* links, const void* pack, const void* basis,
        const void* grad_rgb, const void* s_total, long long n_rays, int r, int X, int Y, int Z, int BY,
        int BZ, int basis_dim, int max_steps, float sigma_thresh, float stop_thresh, float sparsity_scale,
        int sigmoid, void* stream) {
  if (n_rays <= 0) return 0;
  p.g.cells = static_cast<const __nv_bfloat16*>(cells);
  p.g.links = static_cast<const int*>(links);
  p.g.X = X;
  p.g.Y = Y;
  p.g.Z = Z;
  p.g.BY = BY;
  p.g.BZ = BZ;
  p.pack = static_cast<const float*>(pack);
  p.basis = static_cast<const float*>(basis);
  p.grad_rgb = static_cast<const float*>(grad_rgb);
  p.s_total = static_cast<const float*>(s_total);
  p.n_rays = n_rays;
  p.r = r;
  p.max_steps = max_steps;
  p.sigmoid = sigmoid;
  p.sigma_thresh = sigma_thresh;
  p.stop_thresh = stop_thresh;
  p.sparsity_scale = sparsity_scale;
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

}  // namespace

extern "C" {

const char* tile_march_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Channels a cell holds for basis_dim B: 1 + 3B padded to a multiple of 8.
int tile_march_bwd_channels(int basis_dim) { return ((1 + 3 * basis_dim + 7) / 8) * 8; }

// cells bf16 [nb, 512, channels], links int32 [BX, BY, BZ], pack float32
// [n_rays, 12], basis float32 [n_rays / r, basis_dim], grad_rgb float32
// [n_rays, 3], s_total float32 [n_rays]; adds into grad_density float32
// [nb, 512] and grad_sh float32 [nb, 512, 3 * basis_dim], which the
// caller zeroes. Launched on `stream`; returns the CUDA error of the
// launch, 0 on success, cudaErrorInvalidValue for a basis_dim other than
// 1, 4, 9, 16, 25.
int tile_march_bwd(const void* cells, const void* links, const void* pack, const void* basis,
                   const void* grad_rgb, const void* s_total, void* grad_density, void* grad_sh,
                   long long n_rays, int r, int X, int Y, int Z, int BY, int BZ, int basis_dim,
                   int max_steps, float sigma_thresh, float stop_thresh, float sparsity_scale,
                   int sigmoid, void* stream) {
  Params p;
  p.grad_density = static_cast<float*>(grad_density);
  p.grad_sh = static_cast<float*>(grad_sh);
  p.sink = nullptr;
  return run(p, cells, links, pack, basis, grad_rgb, s_total, n_rays, r, X, Y, Z, BY, BZ, basis_dim,
             max_steps, sigma_thresh, stop_thresh, sparsity_scale, sigmoid, stream);
}

// tile_march_bwd with every atomic add replaced by a sum into one float
// a ray, written to sink float32 [n_rays]: the same march and arithmetic
// without the scatter, to time what the atomics cost.
int tile_march_bwd_probe(const void* cells, const void* links, const void* pack, const void* basis,
                         const void* grad_rgb, const void* s_total, void* sink, long long n_rays, int r,
                         int X, int Y, int Z, int BY, int BZ, int basis_dim, int max_steps,
                         float sigma_thresh, float stop_thresh, float sparsity_scale, int sigmoid,
                         void* stream) {
  Params p;
  p.grad_density = nullptr;
  p.grad_sh = nullptr;
  p.sink = static_cast<float*>(sink);
  return run(p, cells, links, pack, basis, grad_rgb, s_total, n_rays, r, X, Y, Z, BY, BZ, basis_dim,
             max_steps, sigma_thresh, stop_thresh, sparsity_scale, sigmoid, stream);
}

}  // extern "C"
