// The dense sweep of the Plenoxels touched step, for Hopper (sm_90a): one
// pass from K4's gradient arrays (tile_march_bwd.cu) to the new packed
// state, under per-visit RMSprop or SGD.
//
// Replaces no TPU kernel: the JAX package's dense_optim step
// (nerf_projects_tpu/train/plenoxels_sparse.py) leaves this sweep to XLA's
// fusion. The port ran it as ~15 eager PyTorch passes over float32
// temporaries of the whole state (ops/kernels/dense_sweep.py keeps that
// arithmetic as the plain version); svox2 runs it as one fused kernel
// (rmsprop_once, svox2/csrc/optim_kernel.cu:20-27).
//
// The function per element of packed [nb + 1, 512, CP] (channel 0
// density, channels 1 .. 3B SH, zero padding; row nb the sentinel):
//   * the gradient g = grad * mask, grad read from K4's arrays as K4
//     leaves them (grad_density [nb, 512] on channel 0, grad_sh [nb, 512,
//     3B] on channels 1 .. 3B) and 0 on the padding channels and the
//     sentinel row, mask the cell's occupancy (0 on the sentinel);
//   * per-visit RMSprop: rms' = g == 0 ? rms : (rms == 0 ? g g : b rms +
//     (1 - b) g g), new = data - lr g / (sqrt(rms') + 1e-8); SGD: new =
//     data - lr g, rms untouched (not read, not written);
//   * lr is lr_sigma on channel 0, lr_sh on the others; the density floor
//     clamps channel 0 from below (NaN passes, as torch.clamp);
//   * where g == 0 the old master and rms are kept, bit for bit;
//   * the bf16 copy the march reads (cells) is the new master rounded to
//     nearest even, and last_step[row] = step where flag[row] == 1, the
//     old stamp elsewhere, -1 on the sentinel.
// Each product, sum, quotient and square root is a separately rounded
// float32 operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction, no fast math), in the plain version's
// order, so the kernel's outputs are the plain version's bits.
//
// Bound: the pass reads every element once and writes every output once.
// At the 512^3 shell (nb = 61,296, B = 9, CP = 32): the gradients 3.52 GB
// (grad_density 0.13, grad_sh 3.39), the float32 masters read and written
// 8.03, a float32 rms read and written 8.03, the bf16 cells written 2.01:
// 21.6 GB, 6.4 ms at 3.35 TB/s.
//
// Design: the state is contiguous along its channels, so a thread takes 4
// channels of a cell (a quad): its master and float32 rms are one 16-byte
// load and store each, its bf16 cells (and a bf16 rms) one 8-byte store;
// a warp's quads are 512 contiguous bytes of each array. grad_sh's cell
// rows (3B floats) start off 16-byte boundaries, so its values are scalar
// loads; a warp's loads of them cover 4 cells' contiguous rows and hit
// the same sectors, so they cost their bytes once. A thread takes QPT
// quads 256 apart, their loads issued before any arithmetic, and a block
// stays inside one row; a row of CP = 32 is 8 blocks, the shell's state
// ~490,000 blocks, so every SM holds its full 2,048 threads. The
// state's loads and the outputs' stores are streaming (__ldcs, __stcs):
// each is touched once. No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CELLS = 512;   // cells a brick row
constexpr int THREADS = 256;
constexpr int QPT = 2;       // quads a thread

struct Params {
  const float* packed;            // [nb + 1, 512, CP]
  const void* rms;                // [nb + 1, 512, CP], float32 or bf16; null under SGD
  const float* grad_density;      // [nb, 512]
  const float* grad_sh;           // [nb, 512, 3B]
  const unsigned char* mask;      // bool [nb, 512]
  const int* flag;                // [nb + 1]
  const int* last_in;             // [nb + 1]
  float* packed_out;              // [nb + 1, 512, CP]
  void* rms_out;                  // as rms; null under SGD
  __nv_bfloat16* cells_out;       // [nb + 1, 512, CP] or null
  int* last_out;                  // [nb + 1]
  int nb, step, floor_on;
  float lr_sigma, lr_sh, beta, one_minus_beta, minval;
};

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

__device__ __forceinline__ uint2 pack_bf16(const float v[4]) {
  return make_uint2(bf16_bits(v[0]) | (static_cast<unsigned>(bf16_bits(v[1])) << 16),
                    bf16_bits(v[2]) | (static_cast<unsigned>(bf16_bits(v[3])) << 16));
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <bool BF16_RMS>
__device__ __forceinline__ void load_rms(const void* rms, size_t e, float v[4]) {
  if (BF16_RMS) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(rms) + e));
    v[0] = bf16_lo(w.x);
    v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y);
    v[3] = bf16_hi(w.y);
  } else {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(rms) + e));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
}

template <bool BF16_RMS>
__device__ __forceinline__ void store_rms(void* rms, size_t e, const float v[4]) {
  if (BF16_RMS) {
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(rms) + e), pack_bf16(v));
  } else {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(rms) + e), make_float4(v[0], v[1], v[2], v[3]));
  }
}

template <int B, bool BF16_RMS, bool RMSPROP>
__global__ void __launch_bounds__(THREADS) dense_sweep_kernel(Params p) {
  constexpr int NSH = 3 * B;
  constexpr int CP = (1 + NSH + 7) / 8 * 8;
  constexpr int QPC = CP / 4;                           // quads a cell
  constexpr int BPR = CELLS * QPC / (THREADS * QPT);    // blocks a row
  static_assert(CELLS * QPC % (THREADS * QPT) == 0, "a block stays inside one row");
  const int row = blockIdx.x / BPR;
  const int base = (blockIdx.x - row * BPR) * THREADS * QPT + threadIdx.x;  // the first quad in the row
  const bool live_row = row < p.nb;

  size_t elem[QPT], rc[QPT];
  int c0[QPT];
  float data[QPT][4], rms[QPT][4], grad[QPT][4], m[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int j = base + q * THREADS;
    const int cell = j / QPC;
    c0[q] = (j - cell * QPC) * 4;
    rc[q] = static_cast<size_t>(row) * CELLS + cell;
    elem[q] = rc[q] * CP + c0[q];
    const float4 d = __ldcs(reinterpret_cast<const float4*>(p.packed + elem[q]));
    data[q][0] = d.x;
    data[q][1] = d.y;
    data[q][2] = d.z;
    data[q][3] = d.w;
    if (RMSPROP) load_rms<BF16_RMS>(p.rms, elem[q], rms[q]);
    m[q] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) grad[q][k] = 0.f;
    if (live_row) {
      m[q] = p.mask[rc[q]] ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0[q] + k;
        if (c == 0) grad[q][k] = __ldg(p.grad_density + rc[q]);
        else if (c <= NSH) grad[q][k] = __ldg(p.grad_sh + rc[q] * NSH + (c - 1));
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    float out[4], rms_new[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool density = c0[q] + k == 0;
      const float g = __fmul_rn(grad[q][k], m[q]);
      const float lr = density ? p.lr_sigma : p.lr_sh;
      float upd;
      if (RMSPROP) {
        const float r = rms[q][k];
        const float rec = __fadd_rn(__fmul_rn(p.beta, r), __fmul_rn(__fmul_rn(p.one_minus_beta, g), g));
        rms_new[k] = g == 0.f ? r : (r == 0.f ? __fmul_rn(g, g) : rec);
        upd = __fmul_rn(__fdiv_rn(g, __fadd_rn(__fsqrt_rn(rms_new[k]), 1e-8f)), lr);
      } else {
        upd = __fmul_rn(g, lr);
      }
      float v = __fsub_rn(data[q][k], upd);
      if (density && p.floor_on && !isnan(v)) v = fmaxf(v, p.minval);
      out[k] = g == 0.f ? data[q][k] : v;
    }
    __stcs(reinterpret_cast<float4*>(p.packed_out + elem[q]), make_float4(out[0], out[1], out[2], out[3]));
    if (RMSPROP) store_rms<BF16_RMS>(p.rms_out, elem[q], rms_new);
    if (p.cells_out) __stcs(reinterpret_cast<uint2*>(p.cells_out + elem[q]), pack_bf16(out));
  }
  if (base == 0) p.last_out[row] = !live_row ? -1 : (p.flag[row] == 1 ? p.step : p.last_in[row]);
}

template <int B, bool BF16_RMS, bool RMSPROP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int CP = (1 + 3 * B + 7) / 8 * 8;
  constexpr int BPR = CELLS * (CP / 4) / (THREADS * QPT);
  const long long blocks = static_cast<long long>(p.nb + 1) * BPR;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dense_sweep_kernel<B, BF16_RMS, RMSPROP><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_b(const Params& p, int rms_bf16, int rmsprop, cudaStream_t stream) {
  if (!rmsprop) return launch<B, false, false>(p, stream);
  return rms_bf16 ? launch<B, true, true>(p, stream) : launch<B, false, true>(p, stream);
}

}  // namespace

extern "C" {

const char* dense_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// packed float32 [nb + 1, 512, CP] (CP = 1 + 3 basis_dim padded to a
// multiple of 8), rms of its shape in float32 (rms_bf16 0) or bf16 (1),
// grad_density float32 [nb, 512], grad_sh float32 [nb, 512, 3 basis_dim],
// mask bool [nb, 512], flag and last_in int32 [nb + 1]; writes packed_out
// (packed's shape), rms_out (rms's), cells_out bf16 (packed's shape; null:
// none) and last_out int32 [nb + 1]. rmsprop 1: per-visit RMSprop; 0: SGD,
// rms and rms_out unused (may be null). floor_on 1 clamps the density
// channel at minval. lr_sigma, lr_sh, beta and one_minus_beta (1 - beta
// rounded once to float32) are the caller's float32 numbers. Launched on
// `stream`; returns the CUDA error of the launch, 0 on success,
// cudaErrorInvalidValue for a basis_dim other than 1, 4, 9, 16, 25 or a
// grid too large for one launch.
int dense_sweep(const void* packed, const void* rms, const void* grad_density, const void* grad_sh,
                const void* mask, const void* flag, const void* last_in, void* packed_out, void* rms_out,
                void* cells_out, void* last_out, int nb, int basis_dim, int rms_bf16, int rmsprop, int step,
                float lr_sigma, float lr_sh, float beta, float one_minus_beta, int floor_on, float minval,
                void* stream) {
  Params p;
  p.packed = static_cast<const float*>(packed);
  p.rms = rms;
  p.grad_density = static_cast<const float*>(grad_density);
  p.grad_sh = static_cast<const float*>(grad_sh);
  p.mask = static_cast<const unsigned char*>(mask);
  p.flag = static_cast<const int*>(flag);
  p.last_in = static_cast<const int*>(last_in);
  p.packed_out = static_cast<float*>(packed_out);
  p.rms_out = rms_out;
  p.cells_out = static_cast<__nv_bfloat16*>(cells_out);
  p.last_out = static_cast<int*>(last_out);
  p.nb = nb;
  p.step = step;
  p.floor_on = floor_on;
  p.lr_sigma = lr_sigma;
  p.lr_sh = lr_sh;
  p.beta = beta;
  p.one_minus_beta = one_minus_beta;
  p.minval = minval;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis_dim) {
    case 1: return static_cast<int>(launch_b<1>(p, rms_bf16, rmsprop, s));
    case 4: return static_cast<int>(launch_b<4>(p, rms_bf16, rmsprop, s));
    case 9: return static_cast<int>(launch_b<9>(p, rms_bf16, rmsprop, s));
    case 16: return static_cast<int>(launch_b<16>(p, rms_bf16, rmsprop, s));
    case 25: return static_cast<int>(launch_b<25>(p, rms_bf16, rmsprop, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
