// Fused NeRF-SH trunk weight-gradient backward for Hopper (sm_90a), bf16
// wgmma products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_sh_mlp.py::_fused_sh_bwd
// (kernel _bwd_kernel): given the inputs x [n, 63] and the output
// gradients g_rgb [n, num_rgb] and g_sig [n] of fused_sh_fwd, the float32
// gradients of the ten padded weights and ten biases. x gets none, as on
// the TPU. Like the TPU kernel it recomputes the forward; its rounding
// points are _bwd_kernel's: dW = mmT rounds both operands to bf16, the dX
// products (mmBT) round g, the relu masks come from the sign of the
// activation, the bias gradients are float32 sums of the unrounded g.
//
// Bound: per row the recomputed trunk (491,008 multiply-adds), the dX
// products (7 x 65,536 + 256 (num_rgb + 1)) and dW (491,008 + 256 (num_rgb
// + 1)): 1,465,856 at sh_deg 3, ~2.9 MFLOP, against (63 + num_rgb + 1) * 4
// bytes of input a row and 2.2 MB of gradients for the call: bound by
// tensor-core operations. The stashes (sh::A_FEATS 2,112 and sh::G_FEATS
// 2,184 bf16 features a row, each written once and read about twice) are
// not in that bound.
//
// Design: K1b's three passes on the wgmma core (mlp_sm90.cuh), over K5's
// stash feature map and gradient layout (mlp_tile.cuh's sh::), with K5f's
// weight buffer (kernel_weights_sm90) and a dX buffer of its own. The
// forward is K5f's (IN_SH) with the activation stash and without the
// heads: it stashes x and a0..a7 only, staging each layer's output into
// the stash by bulk copies and adding each 64-deep slab's products into
// float32 registers (PROMOTE), which the float64-sums rule needs. The dX
// pass reads g_rgb and g_sig as the bf16 fragments of one K = 144 product
// over [coefficient head^T | sigma head^T] into dense 7 (one slab table
// for every head width: the coefficient head's rows past num_rgb are
// zero, and its 128 columns cost ~2% of the pass over num_rgb rounded up),
// stashes them as G_RGB and G_SIG, and walks the gradient down to dense 0
// with per-block float32 bias sums over a fixed grid of DX_BLOCKS blocks.
// The split-K dW pass runs K5's 36 jobs (K1's trunk jobs, then the sigma
// head's and the coefficient head's) and sh_grad_reduce_kernel sums the
// partials and the bias rows in a fixed order: the same bits on every run.
// Rows past n are zeros in the stash of x and read as zero g, so they add
// nothing to dW or the bias sums.

#include "mlp_sm90.cuh"

namespace sh {

// Gradient-stash feature whose float32 sum is bias element b (-1: padding).
__device__ __forceinline__ int bias_feature(int b) {
  if (b < 8 * 256) return G_TRUNK + b;
  b -= 8 * 256;
  if (b < 128) return b == 0 ? G_SIG : -1;
  return G_RGB + (b - 128);
}

__global__ void sh_grad_reduce_kernel(const float* __restrict__ part, int splits,
                                      const float* __restrict__ db_part, int db_blocks,
                                      float* __restrict__ grads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= GRAD_ELEMS) return;
  float s = 0.f;
  if (i < GB0) {
    for (int k = 0; k < splits; ++k) s += part[k * mlp::GB0 + i];
  } else {
    const int f = bias_feature(static_cast<int>(i - GB0));
    if (f >= 0)
      for (int b = 0; b < db_blocks; ++b) s += db_part[static_cast<long long>(b) * G_FEATS + f];
  }
  grads[i] = s;
}

}  // namespace sh

extern "C" {

long long fused_sh_bwd_weight_elems() { return sm90::SH_WEIGHTS; }
long long fused_sh_bwd_weight_t_elems() { return sm90::SWT_SH_WEIGHTS; }
long long fused_sh_bwd_grad_elems() { return sh::GRAD_ELEMS; }
long long fused_sh_bwd_workspace_bytes(long long n) { return sm90::workspace_bytes(n, sm90::K5_FEATS, false); }

const char* fused_sh_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 63], g_rgb [n, num_rgb], g_sig [n] float32; w, wt the bf16
// forward (K5f's) and dX weight buffers of mlp_sm90.cuh's NeRF-SH layouts;
// grads [GRAD_ELEMS] float32; workspace of fused_sh_bwd_workspace_bytes(n)
// bytes, 256-byte aligned. Launched on `stream`; returns the first CUDA
// error, 0 on success.
int fused_sh_bwd(const void* x, const void* g_rgb, const void* g_sig, const void* w, const void* wt,
                 void* grads, long long n, int num_rgb, void* workspace, void* stream) {
  if (n <= 0 || num_rgb < 1 || num_rgb > sh::MAX_RGB) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::Workspace ws = sm90::carve(workspace, n, sm90::K5_FEATS, false);
  cudaError_t err = sm90::launch_forward<sm90::IN_SH, true>(
      static_cast<const float*>(x), nullptr, static_cast<const mlp::bf16*>(w), nullptr, n, ws.A, 1, 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dx_blocks = 0;
  err = sm90::launch_dx<true>({static_cast<const float*>(g_rgb), static_cast<const float*>(g_sig), num_rgb}, n,
                              static_cast<const mlp::bf16*>(wt), ws, &dx_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int splits = 0;
  err = sm90::launch_dw_parts(n, ws, sm90::K5_FEATS, sm90::sh_dw_jobs(num_rgb), &splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sh::sh_grad_reduce_kernel<<<static_cast<unsigned>((sh::GRAD_ELEMS + 255) / 256), 256, 0, s>>>(
      ws.part, splits, ws.db_part, dx_blocks, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
