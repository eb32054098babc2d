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
// that can read data is read, none is dropped).
//
// Bound: the float operations the function needs (ops/kernels/
// tile_march.py: FLOPS_PER_SAMPLE, 50, for each sample that can reach an
// occupied brick, flops_per_shaded, 507 at B = 9, for each shaded one,
// FLOPS_PER_BRICK_STEP for each run of samples in an unreachable brick)
// against the live bytes of the bricks it touches (1 + 3B bf16 channels a
// cell) read once from HBM; the operations bound a frame at the card's
// float32 rate.
//
// Design. A thread marches one ray, and a warp a patch of neighbouring
// rays of one tile, so its samples cluster in a few bricks. A cell keeps its
// 1 + 3B channels together (density first, then SH in c * B + b order),
// bf16, padded to a multiple of 8 channels: one 64-byte line for B = 9.
// The TPU's 2x2x2-brick windows, chunk plan and MXU prefix sums exist to
// feed Mosaic; here any brick is read through brick_links. On the card
// the march is bound by its gathers, not by arithmetic: on the 512^3 fog
// frame the first port's per-sample design spent ~6% of its time
// stepping and reading 8 link words a sample, ~25% reading the 8
// densities behind them and ~69% reading and weighting the 8 SH lines
// of a shaded sample; on the opaque shell most of it went to stepping
// through empty bricks (tile_march_fwd_probe times those cuts; PERF.md).
// So:
//   * Empty space is skipped by bricks. A sample whose lower corner lies
//     in brick b reads only bricks b + {0, 1}^3 (the upper corner may
//     cross a face); the thread loads those 8 link rows once per brick it
//     enters. If none is occupied, the sample and every later one whose
//     lower corner stays in b read zeros: sigma is 0, so they add nothing
//     (log1p(0) = 0, cum unchanged). The thread then jumps to the first
//     step after the last one before the ray leaves b shrunk by SKIP_EPS
//     on every face (sample positions carry ~1e-4 cells of rounding, far
//     below the margin; the exit uses per-ray reciprocals, so no division
//     in the loop), and marches on from there; t0 <= tt < t1 still
//     decides each sample. So the outputs are those of the march without
//     the skip, with or without use_occupancy.
//   * The 8 link rows of the brick serve its samples' corners: no link
//     read in a sample, one dependent read (the densities) before sigma.
//   * A warp marches a compact patch of its tile, 8 rows of 4 rays
//     (thread_ray; the tile's width is taken from r, and any other shape
//     only changes which thread marches which ray), and the corners sit
//     in slots by the parities of their coordinates (tile_march.cuh): a
//     warp's load for one slot then falls on few cells, since
//     neighbouring rays share corners, and costs few L1 transactions.
//     Both made the fog frame faster on the card (PERF.md).
//   * Keeping each corner's cell, density and colour in registers while
//     it stays a corner was tried and was slower on every shape: the 32
//     rays of a warp refresh different corners, so the warp still issues
//     all 8 corners' code each sample, with more registers and branches.
// The density and colour sums over the corners are tile_march.cuh's, the
// ones K4 recomputes each sample, so K3 and K4 see the same samples and
// transmittances bit for bit.
// tile_march_fwd_probe runs the per-sample march of the first port (8
// link reads, 8 densities and 8 SH lines a sample, no skip) cut after its
// link reads, after its densities, or whole, to time where that design's
// time goes.

#include "tile_march.cuh"

namespace {

using namespace tile_march;

constexpr float SKIP_EPS = 1.f / 128.f;  // cells: a skip stays this far inside its brick
constexpr int PATCH_H = 8, PATCH_W = 4;  // a warp's rays: 8 rows of 4 of its tile

struct Params {
  Grid g;
  const float* pack;   // [n_rays, PACK]
  const float* basis;  // [n_rays / r, B]
  float* out;          // [n_rays / r, 8, r]
  float* sink;         // [n_rays]: the probe's output
  long long n_rays;
  int r, max_steps, sigmoid, early_stop;
  int tile_w;  // the width taken for the tile's rows, or 0: rays in order
  float sigma_thresh, stop_thresh;
};

// The link row of each corner slot (tile_march.cuh) from the link rows
// nb of the lower corner's brick and its upper neighbours: along an axis
// only the corner l + 1 of a lower corner on the brick's last cell
// (l & 7 == 7) lies in the next brick. Selected axis by axis, so that no
// register array is indexed at run time.
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

// The ray a thread marches: with tile_w, warp w of a tile takes a patch of
// PATCH_H rows of PATCH_W rays, the tile read as rows of tile_w rays.
__device__ __forceinline__ long long thread_ray(const Params& p) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!p.tile_w) return t;
  const long long gw = t >> 5, wpt = p.r >> 5, tile = gw / wpt;
  const int wi = static_cast<int>(gw - tile * wpt), lane = threadIdx.x & 31, cols = p.tile_w / PATCH_W;
  return tile * p.r + ((wi / cols) * PATCH_H + lane / PATCH_W) * p.tile_w + (wi % cols) * PATCH_W + lane % PATCH_W;
}

// The tile width thread_ray takes: the largest power of two w with w^2 <=
// 2r (32 for the frame path's 16x32 tiles, 16 for 8x16 and 16x16), if the
// tile then splits into whole patches; else 0.
int patch_tile_width(int r) {
  int w = 1;
  while (4 * w * w <= 2 * r) w *= 2;
  return r % w == 0 && (r / w) % PATCH_H == 0 && w % PATCH_W == 0 ? w : 0;
}

template <int B>
__global__ void __launch_bounds__(128) march_kernel(const Params p) {
  constexpr int CP = Layout<B>::CP;
  const long long ray = thread_ray(p);
  if (ray >= p.n_rays) return;
  const long long tile = ray / p.r;
  const int lane = static_cast<int>(ray - tile * p.r);

  const Ray r = load_ray(p.pack, ray);
  float basis[B];
#pragma unroll
  for (int b = 0; b < B; ++b) basis[b] = p.basis[tile * B + b];

  float rgb0 = 0.f, rgb1 = 0.f, rgb2 = 0.f, acc = 0.f, depth = 0.f, cum = 0.f, spars = 0.f;
  if (r.t1 > r.t0) {
    const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz, idt = 1.f / r.dt;
    int bx = -1, by = -1, bz = -1;  // the brick of the last lower corner
    int nb[8];                      // its neighbourhood's link rows
    bool reach = false;
    float T = 1.f;  // exp(-cum)
    for (int k = first_step(r, p.max_steps); k < p.max_steps; ++k) {
      const float tt = sample_t(r, k);
      if (tt < r.t0) continue;
      if (!(tt < r.t1)) break;
      const bool active = T > p.stop_thresh;
      if (!active && p.early_stop) break;
      float px, py, pz, wx, wy, wz;
      int lx, ly, lz;
      position(r, tt, px, py, pz);
      lower_corner(p.g, px, py, pz, lx, ly, lz, wx, wy, wz);
      if ((lx >> 3) != bx || (ly >> 3) != by || (lz >> 3) != bz) {
        bx = lx >> 3;
        by = ly >> 3;
        bz = lz >> 3;
        reach = neighbourhood(p.g, bx, by, bz, nb);
      }
      if (!reach) {  // sigma 0 here and on to the brick's exit: jump past it
        bool inside = true;
        const float tx = axis_exit(r.ox, r.dx, ix, px, bx, inside);
        const float ty = axis_exit(r.oy, r.dy, iy, py, by, inside);
        const float tz = axis_exit(r.oz, r.dz, iz, pz, bz, inside);
        if (inside) {
          const float kf = floorf(__fmul_rn(__fsub_rn(fminf(tx, fminf(ty, tz)), r.T0), idt));
          if (kf > static_cast<float>(k)) k = static_cast<int>(fminf(kf, static_cast<float>(p.max_steps - 1)));
        }
        continue;
      }

      // the corners through the brick's link rows
      long long off[8];  // element offset of each corner cell, -1 when empty
      float cw[8], dens[8];
      int rows[8];
      corner_weights(lx, ly, lz, wx, wy, wz, cw);
      corner_rows(nb, lx, ly, lz, rows);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cx = slot_coord(lx, c >> 2), cy = slot_coord(ly, (c >> 1) & 1), cz = slot_coord(lz, c & 1);
        const int row = rows[c];
        off[c] = row >= 0 ? (static_cast<long long>(row) * CELLS + cell_in_brick(cx, cy, cz)) * CP : -1;
        dens[c] = row >= 0 ? __bfloat162float(p.g.cells[off[c]]) : 0.f;
      }
      const float s = corner_sum(cw, dens);
      const float sigma = s > p.sigma_thresh ? s : 0.f;
      if (sigma == 0.f) continue;  // log1p(0) adds 0 to the sparsity sum
      spars += log1pf(2.f * sigma * sigma);
      if (!active) continue;

      float raw[3];
      shade<B>(p.g, off, cw, basis, raw);
      const float c0 = decode(raw[0], p.sigmoid);
      const float c1 = decode(raw[1], p.sigmoid);
      const float c2 = decode(raw[2], p.sigmoid);
      const float tau = __fmul_rn(sigma, r.step_world);
      const float w = T * (1.f - expf(-tau));
      rgb0 += w * c0;
      rgb1 += w * c1;
      rgb2 += w * c2;
      acc += w;
      depth += w * tt;
      cum = __fadd_rn(cum, tau);
      T = expf(-cum);
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

// The first port's per-sample march, cut after its link reads (MODE 0:
// every valid sample, their rows summed), after its densities (MODE 1:
// the composite with a constant colour) or whole (MODE 2); each ray's
// sums go to sink so that nothing read is dead.
template <int B, int MODE>
__global__ void __launch_bounds__(128) probe_kernel(const Params p) {
  constexpr int CP = Layout<B>::CP;
  const long long ray = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= p.n_rays) return;
  const long long tile = ray / p.r;
  const Ray r = load_ray(p.pack, ray);
  float basis[B];
#pragma unroll
  for (int b = 0; b < B; ++b) basis[b] = p.basis[tile * B + b];
  float rgb = 0.f, acc = 0.f, cum = 0.f, spars = 0.f;
  int rows = 0;
  if (r.t1 > r.t0) {
    for (int k = first_step(r, p.max_steps); k < p.max_steps; ++k) {
      const float tt = sample_t(r, k);
      if (tt < r.t0) continue;
      if (!(tt < r.t1)) break;
      if (MODE == 0) {
        float px, py, pz, wx, wy, wz;
        int lx, ly, lz;
        position(r, tt, px, py, pz);
        lower_corner(p.g, px, py, pz, lx, ly, lz, wx, wy, wz);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int cx = slot_coord(lx, c >> 2), cy = slot_coord(ly, (c >> 1) & 1), cz = slot_coord(lz, c & 1);
          rows += __ldg(p.g.links + ((cx >> 3) * p.g.BY + (cy >> 3)) * p.g.BZ + (cz >> 3));
        }
        continue;
      }
      long long off[8];
      float cw[8];
      const float sigma = corners<CP>(p.g, r, tt, p.sigma_thresh, off, cw);
      const float T = expf(-cum);
      const bool active = T > p.stop_thresh;
      if (!active && p.early_stop) break;
      spars += log1pf(2.f * sigma * sigma);
      if (!active || sigma == 0.f) continue;
      float c = 1.f;
      if (MODE == 2) {
        float raw[3];
        shade<B>(p.g, off, cw, basis, raw);
        c = decode(raw[0], p.sigmoid) + decode(raw[1], p.sigmoid) + decode(raw[2], p.sigmoid);
      }
      const float tau = __fmul_rn(sigma, r.step_world);
      const float w = T * (1.f - expf(-tau));
      rgb += w * c;
      acc += w;
      cum = __fadd_rn(cum, tau);
    }
  }
  p.sink[ray] = rgb + acc + cum + spars + static_cast<float>(rows);
}

template <int B>
cudaError_t launch(const Params& p, int mode, cudaStream_t stream) {
  constexpr int threads = 128;
  const unsigned blocks = static_cast<unsigned>((p.n_rays + threads - 1) / threads);
  switch (mode) {
    case -1: march_kernel<B><<<blocks, threads, 0, stream>>>(p); break;
    case 0: probe_kernel<B, 0><<<blocks, threads, 0, stream>>>(p); break;
    case 1: probe_kernel<B, 1><<<blocks, threads, 0, stream>>>(p); break;
    case 2: probe_kernel<B, 2><<<blocks, threads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(Params& p, int mode, const void* cells, const void* links, const void* pack, const void* basis,
        long long n_rays, int r, int X, int Y, int Z, int BY, int BZ, int basis_dim, int max_steps,
        float sigma_thresh, float stop_thresh, int sigmoid, int early_stop, void* stream) {
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
  p.n_rays = n_rays;
  p.r = r;
  p.max_steps = max_steps;
  p.sigma_thresh = sigma_thresh;
  p.stop_thresh = stop_thresh;
  p.sigmoid = sigmoid;
  p.early_stop = early_stop;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis_dim) {
    case 1: return static_cast<int>(launch<1>(p, mode, s));
    case 4: return static_cast<int>(launch<4>(p, mode, s));
    case 9: return static_cast<int>(launch<9>(p, mode, s));
    case 16: return static_cast<int>(launch<16>(p, mode, s));
    case 25: return static_cast<int>(launch<25>(p, mode, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  Params p;
  p.out = static_cast<float*>(out);
  p.sink = nullptr;
  p.tile_w = patch_tile_width(r);
  return run(p, -1, cells, links, pack, basis, n_rays, r, X, Y, Z, BY, BZ, basis_dim, max_steps,
             sigma_thresh, stop_thresh, sigmoid, early_stop, stream);
}

// The first port's per-sample march cut at `mode` (0: link reads, 1: and
// densities, 2: whole), writing one float a ray to sink float32 [n_rays];
// the other arguments as tile_march_fwd's.
int tile_march_fwd_probe(const void* cells, const void* links, const void* pack, const void* basis,
                         void* sink, long long n_rays, int r, int X, int Y, int Z, int BY, int BZ,
                         int basis_dim, int max_steps, float sigma_thresh, float stop_thresh, int sigmoid,
                         int early_stop, int mode, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = nullptr;
  p.sink = static_cast<float*>(sink);
  p.tile_w = 0;
  return run(p, mode, cells, links, pack, basis, n_rays, r, X, Y, Z, BY, BZ, basis_dim, max_steps,
             sigma_thresh, stop_thresh, sigmoid, early_stop, stream);
}

}  // extern "C"
