// Shared device code of the fused NeRF-SH trunk's weight-gradient
// backward for Hopper (sm_90a), fused_sh_bwd.cu (K5b), built on
// mlp_tile.cuh's primitives (gemm_tile, dense_layer, stash_cols,
// dx_epilogue, mlp_dw_kernel), which this header uses as they are. The
// forward (fused_sh_fwd.cu, K5f) runs on the wgmma core (mlp_sm90.cuh);
// K5b's recomputed trunk stays here until K5b moves onto that core too.
//
// The MLP is models/nerf_sh.py's CondMLP without a condition: trunk
// dense 0..7 (8x256, relu) with the [h, x] concat after dense 4, a sigma
// head (dense 8, one column) and a coefficient head (dense 9, num_rgb =
// 3 (deg+1)^2 or 3 sg_dim columns, at most 128). The reference concatenates
// h first (jaxnerf order); the tile keeps mlp_tile.cuh's activation
// columns [x 0..63 | h 64..319], so the weight buffer holds dense 5's
// input columns permuted to [x | h] (ops/kernels/fused_sh_mlp.py packs
// them so and un-permutes its gradient). Every product takes bf16
// operands and accumulates in float32; biases are bf16, added in float32.

#pragma once

#include "mlp_tile.cuh"

namespace sh {

using mlp::AS;
using mlp::BM;
using mlp::bf16;
using mlp::COL_H;
using mlp::COL_X;
using mlp::THREADS;

constexpr int MAX_RGB = 128;

// K5b's forward weight buffer (ops/kernels/fused_sh_mlp.py::KERNEL_LAYOUT),
// bf16, matrices as [out][in]; the recomputed trunk reads OFF_W0..OFF_B.
constexpr long long OFF_W0 = 0;                       // [256][64]
constexpr long long OFF_W1 = OFF_W0 + 256 * 64;       // w1..w4, [256][256] each
constexpr long long OFF_W5 = OFF_W1 + 4 * 256 * 256;  // [256][320], inputs [x 64 | h 256]
constexpr long long OFF_W6 = OFF_W5 + 256 * 320;      // w6, w7
constexpr long long OFF_WSIG = OFF_W6 + 2 * 256 * 256;  // [256]
constexpr long long OFF_WRGB = OFF_WSIG + 256;        // [128][256], rows past num_rgb zero
constexpr long long OFF_B = OFF_WRGB + MAX_RGB * 256;   // b0..b7, [256] each
constexpr long long OFF_BSIG = OFF_B + 8 * 256;       // [8], entry 0 live
constexpr long long OFF_BRGB = OFF_BSIG + 8;          // [128]
constexpr long long N_WEIGHTS = OFF_BRGB + MAX_RGB;

// Backward weight buffer (KERNEL_LAYOUT_BWD): the matrices of the dX
// products as [in][out]; the coefficient head last, [256][RN].
constexpr long long OFFT_WSIG = 0;                    // [256]
constexpr long long OFFT_W7 = 256;                    // w7, w6, w5 (h rows), w4, w3, w2, w1
constexpr long long OFFT_WRGB = OFFT_W7 + 7 * 256 * 256;
__host__ __device__ constexpr long long offt_trunk(int l) { return OFFT_W7 + (7 - l) * 256 * 256; }
__host__ __device__ constexpr long long nt_weights(int rn) { return OFFT_WRGB + 256LL * rn; }

// Activation stash: x, a0..a7 (mlp_tile.cuh's A_X and A_TRUNK).
constexpr int A_FEATS = mlp::A_TRUNK + 8 * 256;
// Gradient stash: the coefficient head's output gradient, the sigma
// head's, then dense 0..7's output gradients.
constexpr int G_RGB = 0;
constexpr int G_SIG = MAX_RGB;
constexpr int G_TRUNK = G_SIG + 8;  // + 256 l
constexpr int G_FEATS = G_TRUNK + 8 * 256;

// Gradient buffer, float32: FusedSHWeights' padded [in][out] shapes in
// order, except that w5's rows are in the kernel's [x 64 | h 256] order.
constexpr long long GW0 = 0;                      // [64][256]
constexpr long long GW1 = GW0 + 64 * 256;         // w1..w4
constexpr long long GW5 = GW1 + 4 * 256 * 256;    // [320][256]
constexpr long long GW6 = GW5 + 320 * 256;        // w6, w7
constexpr long long GWSIG = GW6 + 2 * 256 * 256;  // [256][128]
constexpr long long GWRGB = GWSIG + 256 * 128;    // [256][128]
constexpr long long GB0 = GWRGB + 256 * 128;      // b0..b7 [256]
constexpr long long GBSIG = GB0 + 8 * 256;        // [128]
constexpr long long GBRGB = GBSIG + 128;          // [128]
constexpr long long GRAD_ELEMS = GBRGB + 128;
// mlp_dw_kernel writes split k's partial at k * mlp::GB0: K5's weights fit
static_assert(GB0 <= mlp::GB0, "K5's weight gradients must fit K1's partial stride");

constexpr int FWD_SMEM_BYTES = mlp::FWD_SMEM_BYTES;

// x [n, 63] float32 (the block posenc) as bf16 into act columns 0..63;
// column 63 and rows past n are zero.
__device__ __forceinline__ void load_points(bf16* act, const float* x, long long row_base, long long n) {
  for (int i = threadIdx.x; i < BM * 64; i += THREADS) {
    const int r = i >> 6, c = i & 63;
    const long long row = row_base + r;
    const float val = (c < 63 && row < n) ? x[row * 63 + c] : 0.f;
    act[r * AS + COL_X + c] = __float2bfloat16_rn(val);
  }
}

// The trunk of one 64-row tile whose inputs are in act (synchronised):
// a7 ends in columns COL_H..COL_H+256, each layer's output also in the
// activation stash (x, a0..a7).
__device__ __forceinline__ void trunk_tile(bf16* act, bf16* wbuf, const bf16* w, long long row_base,
                                           bf16* stash, long long ld) {
  using mlp::A_TRUNK;
  using mlp::dense_layer;
  using mlp::stash_cols;
  stash_cols(act, AS, COL_X, 64, stash, mlp::A_X, ld, row_base);
  dense_layer<256, true>(act, wbuf, w + OFF_W0, w + OFF_B, 64, COL_X, COL_H);
  stash_cols(act, AS, COL_H, 256, stash, A_TRUNK, ld, row_base);
  for (int l = 1; l <= 4; ++l) {
    dense_layer<256, true>(act, wbuf, w + OFF_W1 + (l - 1) * 256 * 256, w + OFF_B + l * 256, 256,
                           COL_H, COL_H);
    stash_cols(act, AS, COL_H, 256, stash, A_TRUNK + l * 256, ld, row_base);
  }
  // dense 5 reads [x | h4], columns 0..319 (its weights permuted to match)
  dense_layer<256, true>(act, wbuf, w + OFF_W5, w + OFF_B + 5 * 256, 320, COL_X, COL_H);
  stash_cols(act, AS, COL_H, 256, stash, A_TRUNK + 5 * 256, ld, row_base);
  for (int l = 6; l <= 7; ++l) {
    dense_layer<256, true>(act, wbuf, w + OFF_W6 + (l - 6) * 256 * 256, w + OFF_B + l * 256, 256,
                           COL_H, COL_H);
    stash_cols(act, AS, COL_H, 256, stash, A_TRUNK + l * 256, ld, row_base);
  }
}

// One block a 64-row tile: the trunk, writing the activation stash (row
// stride ld).
__global__ void __launch_bounds__(THREADS, 2)
    sh_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ w, long long n, bf16* __restrict__ stash,
                  long long ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);
  bf16* wbuf = act + BM * AS;
  const long long row_base = static_cast<long long>(blockIdx.x) * BM;
  load_points(act, x, row_base, n);
  __syncthreads();
  trunk_tile(act, wbuf, w, row_base, stash, ld);
}

inline cudaError_t launch_forward(const float* x, const bf16* w, long long n, bf16* stash, long long ld,
                                  cudaStream_t stream) {
  const long long blocks = (n + BM - 1) / BM;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sh_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  sh_fwd_kernel<<<static_cast<unsigned>(blocks), THREADS, FWD_SMEM_BYTES, stream>>>(x, w, n, stash, ld);
  return cudaGetLastError();
}

}  // namespace sh
