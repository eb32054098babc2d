// The layouts, encoder and fixed-order reduce that the wgmma core
// (mlp_sm90.cuh) shares among its kernels. No kernel here multiplies
// matrices: every MLP product runs on the core.
//
// namespace mlp, the 8x256 viewdirs NeRF MLP of models/nerf.py (K1f, K1b,
// K1rf, K1rb, K2): trunk_0..7 with the [x, h] concat after trunk_4's relu,
// the sigma head, the bottleneck, one 128-wide view layer over
// [bottleneck, views] and the rgb head. Its backward's stash feature map
// (A_*, G_*: the activation or output gradient each stash feature holds),
// the layout of its float32 gradient buffer (GW*, GB*), the block
// positional encoding of its raw-points mode (encode_col), and the
// fixed-order sums of the dW partials and the bias partials into that
// buffer (mlp_grad_reduce_kernel).
//
// namespace sh, the NeRF-SH trunk of models/nerf_sh.py (K5b): the same
// eight trunk layers under a sigma head and a coefficient head of at most
// 128 columns. Its stash feature map and gradient layout; its reduce is
// fused_sh_bwd.cu's.
//
// The stashes are bf16 and hold exactly what the reference rounds to bf16
// at its products (mmT rounds both operands, mmBT rounds g), and a relu
// mask of a bf16 value has the sign of the float32 one, so the stashes
// change no number.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr float HALF_PI = 1.5707963267948966f;
constexpr unsigned FULL = 0xffffffffu;

// Activation stash features: x, a0..a7, bottleneck, v, hv ([bottleneck | v]
// is view_0's input, contiguous).
constexpr int A_X = 0;
constexpr int A_TRUNK = 64;  // + 256 l
constexpr int A_BNECK = A_TRUNK + 8 * 256;
constexpr int A_V = A_BNECK + 256;
constexpr int A_HV = A_V + 32;
constexpr int A_FEATS = A_HV + 128;
// Gradient stash features: the rgb and sigma head gradients (4 each), the
// view layer's, the bottleneck's, then trunk_0..7's output gradients.
constexpr int G_RGB = 0;
constexpr int G_SIG = 4;
constexpr int G_V = 8;
constexpr int G_B = G_V + 128;
constexpr int G_TRUNK = G_B + 256;  // + 256 l
constexpr int G_FEATS = G_TRUNK + 8 * 256;

// Gradient buffer: FusedMLPWeights' fields in order, padded [in][out], float32.
constexpr long long GW0 = 0;                      // [64][256]
constexpr long long GW1 = GW0 + 64 * 256;         // w1..w4 [256][256]
constexpr long long GW5 = GW1 + 4 * 256 * 256;    // [320][256]
constexpr long long GW6 = GW5 + 320 * 256;        // w6, w7
constexpr long long GWSIG = GW6 + 2 * 256 * 256;  // [256][128]
constexpr long long GWB = GWSIG + 256 * 128;      // [256][256]
constexpr long long GWV = GWB + 256 * 256;        // [288][128]
constexpr long long GWRGB = GWV + 288 * 128;      // [128][128]
constexpr long long GB0 = GWRGB + 128 * 128;      // b0..b7 [256]
constexpr long long GBSIG = GB0 + 8 * 256;        // [128]
constexpr long long GBB = GBSIG + 128;            // [256]
constexpr long long GBV = GBB + 256;              // [128]
constexpr long long GBRGB = GBV + 128;            // [128]
constexpr long long GRAD_ELEMS = GBRGB + 128;

// Block-layout positional encoding of column c of a point p (3 live):
// [p(3), sin(2^f p) f<F, sin(2^f p + pi/2) f<F], zero past 3 + 6F
// (ops/pallas/fused_mlp.py::_encode_tile). The wgmma core's raw input
// mode encodes with it.
__device__ __forceinline__ float encode_col(const float* p, int c, int n_freqs) {
  if (c < 3) return p[c];
  const int k = c - 3;
  if (k < 6 * n_freqs) {
    const bool is_cos = k >= 3 * n_freqs;
    const int j = is_cos ? k - 3 * n_freqs : k;
    const float xb = p[j % 3] * static_cast<float>(1 << (j / 3));
    return sinf(is_cos ? xb + HALF_PI : xb);
  }
  return 0.f;
}

// Gradient-stash feature whose float32 sum is bias element b (-1: padding).
__device__ __forceinline__ int bias_feature(int b) {
  if (b < 8 * 256) return G_TRUNK + b;
  b -= 8 * 256;
  if (b < 128) return b < 4 ? G_SIG + b : -1;
  b -= 128;
  if (b < 256) return G_B + b;
  b -= 256;
  if (b < 128) return G_V + b;
  b -= 128;
  return b < 4 ? G_RGB + b : -1;
}

// grads[i] = the sum over the splits of the dW partials part[k][i] (split
// k's at k * GB0), or, for a bias, over the blocks of the dX pass's bias
// partials db_part[b][G_FEATS]: each in a fixed order.
__global__ void mlp_grad_reduce_kernel(const float* __restrict__ part, int splits,
                                       const float* __restrict__ db_part, int db_blocks,
                                       float* __restrict__ grads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= GRAD_ELEMS) return;
  float s = 0.f;
  if (i < GB0) {
    for (int k = 0; k < splits; ++k) s += part[k * GB0 + i];
  } else {
    const int f = bias_feature(static_cast<int>(i - GB0));
    if (f >= 0)
      for (int b = 0; b < db_blocks; ++b) s += db_part[static_cast<long long>(b) * G_FEATS + f];
  }
  grads[i] = s;
}

}  // namespace mlp

namespace sh {

constexpr int MAX_RGB = 128;

// Activation stash: x and a0..a7, at mlp's A_X and A_TRUNK.
constexpr int A_FEATS = mlp::A_TRUNK + 8 * 256;
// Gradient stash: the coefficient head's output gradient (MAX_RGB
// features, zero past num_rgb), the sigma head's (8, the first live), then
// dense 0..7's output gradients.
constexpr int G_RGB = 0;
constexpr int G_SIG = MAX_RGB;
constexpr int G_TRUNK = G_SIG + 8;  // + 256 l
constexpr int G_FEATS = G_TRUNK + 8 * 256;

// Gradient buffer, float32: FusedSHWeights' padded [in][out] shapes in
// order, except that w5's rows are in the kernels' [x 64 | h 256] order.
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
// the dW pass writes split k's partial at k * mlp::GB0, and both trunks'
// dW jobs share mlp's GW0..GW6
static_assert(GB0 <= mlp::GB0, "K5's weight gradients must fit K1's partial stride");
static_assert(GW0 == mlp::GW0 && GW1 == mlp::GW1 && GW5 == mlp::GW5 && GW6 == mlp::GW6,
              "the trunks' gradient layouts agree");

}  // namespace sh
