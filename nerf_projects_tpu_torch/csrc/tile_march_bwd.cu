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
// XLA scatter-adds afterwards. Here the ray is re-marched (svox2's
// render_ray_backward pattern), so K3's serving path writes no stream,
// and the gradients go straight into the brick arrays in their own layout
// with float32 atomicAdd (no relayout, no blocks). The first port marched
// a ray on one thread, read 8 link words a sample and issued
// 8 x (1 + 3B) atomics a shaded sample (224 at B = 9); the atomics,
// colliding in L2 on the cells that a ray's next samples and its
// neighbours hit again, took ~84% of a training batch, and 40 blocks of
// one thread a ray filled 40 of 132 SMs. So:
//   * A ray is marched by a group of 8 lanes, one per corner slot; a
//     warp holds 4 rays, a 2x2 patch of its tile (patch_ray). All 8
//     lanes step alike; each loads its own corner's density and SH line,
//     and the group's densities and colours reach every lane by shuffles
//     and are summed in slot order by tile_march.cuh's corner_sum, as K3
//     sums them, so every sample, T and P are K3's bit for bit.
//   * K3's skip: runs of samples whose lower-corner brick has no occupied
//     neighbour read zeros (sigma 0: no gradient, no sparsity term, cum
//     and P unchanged) and are jumped; a brick's 8 link rows are read once.
//   * The gradients are summed on chip before they reach global memory. A
//     slot keeps its cell while the cell stays a corner, and the tile's
//     basis is one for all its rays, so a lane carries its slot's run:
//     the density gradient and the 3 colour gradients before the basis,
//     4 floats for any B. It expands them only when the slot's cell
//     changes, and at the ray's end: one add for the density and the
//     cell's 3B SH gradients as float4 reductions where 16-byte aligned
//     (sm_90's vector atomicAdd), scalar ones around them, 10 add
//     instructions at B = 9 where the first port issued 28 a sample.
//     Scalar adds for the row measured slower on the card (PERF.md); a
//     merge of the same cell's runs across a warp was not built: after
//     the vector adds, the march itself takes most of the time.
// The order of the sums changes with the runs and the atomics, so each
// sum differs from the plain version's by float32 rounding, and its last
// bits from run to run. tile_march_bwd_probe runs the same kernel with
// each global add summed into one float a ray instead, to time what the
// adds that are left cost, and writes the samples each ray visited, to
// hold its skip against the host twin (kernel_visits).

#include "tile_march.cuh"

namespace {

using namespace tile_march;

constexpr int LANES = 8;                 // lanes a ray: one per corner slot
constexpr int PATCH_H = 2, PATCH_W = 2;  // a warp's 4 rays: 2 rows of 2 of its tile

struct Params {
  Grid g;
  const float* pack;      // [n_rays, PACK]
  const float* basis;     // [n_rays / r, B]
  const float* grad_rgb;  // [n_rays, 3]: dL / d rgb_out
  const float* s_total;   // [n_rays]: the suffix seed
  float* grad_density;    // [nb, 512]
  float* grad_sh;         // [nb, 512, 3B]
  float* sink;            // [2, n_rays], the probe's output (SCATTER false): sums, samples visited
  long long n_rays;
  int r, max_steps, sigmoid;
  int tile_w;  // the width taken for the tile's rows, or 0: rays in order
  float sigma_thresh, stop_thresh, sparsity_scale;
};

// A corner slot's pending gradient: its cell (row * 512 + cell in the
// brick, -1 none), and the density gradient and the three colour
// gradients before the tile basis summed over the run of samples whose
// corner the cell has been.
struct Run {
  long long cell;
  float gd, g0, g1, g2;
};

// Adds v to *dst, or, in the probe, to the ray's sum.
template <bool SCATTER>
__device__ __forceinline__ void add(float* dst, float v, float& probe) {
  if (SCATTER) atomicAdd(dst, v);
  else probe += v;
}

// Adds (a, b, c, d) to the 16-byte aligned dst[0:4] in one vector
// reduction (sm_90), or, in the probe, to the ray's sum.
template <bool SCATTER>
__device__ __forceinline__ void add4(float* dst, float a, float b, float c, float d, float& probe) {
  if (SCATTER) atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
  else probe += a + b + c + d;
}

// A cell's 3B SH gradients gc[j / B] * basis[j % B] added into its row
// dst, which starts A floats past a 16-byte boundary: scalar adds up to
// the first boundary and after the last, float4 adds between them. A is
// a template argument so that every index is known at compile time.
template <int B, int A, bool SCATTER>
__device__ __forceinline__ void add_row(float* dst, const float gc[3], const float basis[B], float& probe) {
  constexpr int N = 3 * B, HEAD = (4 - A) % 4 < N ? (4 - A) % 4 : N, BODY = (N - HEAD) / 4 * 4;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = gc[j / B] * basis[j % B];
#pragma unroll
  for (int j = 0; j < HEAD; ++j) add<SCATTER>(dst + j, v[j], probe);
#pragma unroll
  for (int j = HEAD; j < HEAD + BODY; j += 4) add4<SCATTER>(dst + j, v[j], v[j + 1], v[j + 2], v[j + 3], probe);
#pragma unroll
  for (int j = HEAD + BODY; j < N; ++j) add<SCATTER>(dst + j, v[j], probe);
}

// A run's adds: its density gradient, then its 3B SH gradients as one
// row (add_row; grad_sh itself is 16-byte aligned), each left out where
// its sums are 0 (with sparsity on, the samples past the last active one
// add to the density only).
template <int B, bool SCATTER>
__device__ __forceinline__ void flush(const Params& p, const Run& run, const float basis[B], float& probe) {
  if (run.cell < 0) return;
  if (run.gd != 0.f) add<SCATTER>(p.grad_density + run.cell, run.gd, probe);
  if (run.g0 == 0.f && run.g1 == 0.f && run.g2 == 0.f) return;
  const float gc[3] = {run.g0, run.g1, run.g2};
  float* dst = p.grad_sh + run.cell * (3 * B);
  switch (static_cast<int>((run.cell * (3 * B)) & 3)) {
    case 0: add_row<B, 0, SCATTER>(dst, gc, basis, probe); break;
    case 1: add_row<B, 1, SCATTER>(dst, gc, basis, probe); break;
    case 2: add_row<B, 2, SCATTER>(dst, gc, basis, probe); break;
    default: add_row<B, 3, SCATTER>(dst, gc, basis, probe); break;
  }
}

template <int B, bool SCATTER>
__global__ void __launch_bounds__(128) march_bwd_kernel(const Params p) {
  constexpr int CP = Layout<B>::CP;
  const long long unit = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / LANES;
  const long long ray = patch_ray<PATCH_H, PATCH_W>(unit, p.r, p.tile_w);
  if (ray >= p.n_rays) return;  // the whole group: its lanes share the ray
  const int slot = threadIdx.x % LANES;      // the corner slot this lane holds
  const int first = threadIdx.x % 32 - slot;  // the group's first lane in the warp
  const unsigned group = 0xffu << first;
  const long long tile = ray / p.r;

  const Ray r = load_ray(p.pack, ray);
  float basis[B];
#pragma unroll
  for (int b = 0; b < B; ++b) basis[b] = p.basis[tile * B + b];
  const float g0 = p.grad_rgb[ray * 3 + 0], g1 = p.grad_rgb[ray * 3 + 1], g2 = p.grad_rgb[ray * 3 + 2];
  const float s_total = p.s_total[ray];

  float cum = 0.f;    // -log T: the prefix of tau over the active samples, as K3's
  float P = 0.f;      // inclusive prefix of w (c . g)
  float probe = 0.f;  // SCATTER false: the sum of the would-be adds
  int visits = 0;     // SCATTER false: the samples visited
  Run acc = {-1, 0.f, 0.f, 0.f, 0.f};  // this lane's slot
  if (r.t1 > r.t0) {
    Skip sk = skip_start(r);
    for (int k = first_step(r, p.max_steps); k < p.max_steps; ++k) {
      const float tt = sample_t(r, k);
      if (tt < r.t0) continue;
      if (!(tt < r.t1)) break;
      const float T = expf(-cum);
      const bool active = T > p.stop_thresh;
      if (!active && p.sparsity_scale == 0.f) break;
      ++visits;
      float px, py, pz, wx, wy, wz;
      int lx, ly, lz;
      position(r, tt, px, py, pz);
      lower_corner(p.g, px, py, pz, lx, ly, lz, wx, wy, wz);
      if (!reach(p.g, lx, ly, lz, sk)) {  // sigma 0 here and on to the brick's exit: no gradient
        k = skip_to(r, sk, px, py, pz, k, p.max_steps);
        continue;
      }

      // this lane's corner; the group's densities in slot order
      float cw[8], dens[8];
      int rows[8];
      corner_weights(lx, ly, lz, wx, wy, wz, cw);
      corner_rows(sk.nb, lx, ly, lz, rows);
      const int row = pick(rows, slot);
      const long long cell =
          row >= 0 ? static_cast<long long>(row) * CELLS + cell_in_brick(slot_coord(lx, slot >> 2),
                                                                          slot_coord(ly, (slot >> 1) & 1),
                                                                          slot_coord(lz, slot & 1))
                   : -1;
      const float d = row >= 0 ? __bfloat162float(p.g.cells[cell * CP]) : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) dens[c] = __shfl_sync(group, d, first + c);
      const float s = corner_sum(cw, dens);
      const float sigma = s > p.sigma_thresh ? s : 0.f;
      if (sigma == 0.f) continue;  // at or below the threshold: no gradient

      float gsig = p.sparsity_scale * (4.f * sigma / (1.f + 2.f * sigma * sigma));
      float gr[3] = {0.f, 0.f, 0.f};  // dL / d raw colour
      if (active) {
        float col[3] = {0.f, 0.f, 0.f}, cols[3][8];
        if (row >= 0) corner_colour<B>(p.g.cells + cell * CP, basis, col);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          cols[0][c] = __shfl_sync(group, col[0], first + c);
          cols[1][c] = __shfl_sync(group, col[1], first + c);
          cols[2][c] = __shfl_sync(group, col[2], first + c);
        }
        const float raw[3] = {corner_sum(cw, cols[0]), corner_sum(cw, cols[1]), corner_sum(cw, cols[2])};
        const float c0 = decode(raw[0], p.sigmoid);
        const float c1 = decode(raw[1], p.sigmoid);
        const float c2 = decode(raw[2], p.sigmoid);
        const float tau = __fmul_rn(sigma, r.step_world);  // rounded as K3 rounds it
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
        cum = __fadd_rn(cum, tau);
      }

      if (row < 0) continue;  // a corner in an empty brick receives nothing
      if (cell != acc.cell) {  // the slot's cell changed: the last one's run is whole
        flush<B, SCATTER>(p, acc, basis, probe);
        acc.cell = cell;
        acc.gd = acc.g0 = acc.g1 = acc.g2 = 0.f;
      }
      const float cws = pick(cw, slot);
      acc.gd += cws * gsig;
      acc.g0 += cws * gr[0];
      acc.g1 += cws * gr[1];
      acc.g2 += cws * gr[2];
    }
  }
  flush<B, SCATTER>(p, acc, basis, probe);  // the ray's last run
  if (!SCATTER) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) probe += __shfl_xor_sync(group, probe, o);
    if (slot == 0) {
      p.sink[ray] = probe;
      p.sink[p.n_rays + ray] = static_cast<float>(visits);
    }
  }
}

template <int B>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int threads = 128;
  const long long blocks = (p.n_rays * LANES + threads - 1) / threads;
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
  p.tile_w = patch_tile_width<PATCH_H, PATCH_W>(r);
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

// tile_march_bwd with every global add replaced by a sum into one float
// a ray, written to sink float32 [2, n_rays] with the samples the ray
// visited: the same march, runs and arithmetic without the adds, to time
// what they cost.
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
