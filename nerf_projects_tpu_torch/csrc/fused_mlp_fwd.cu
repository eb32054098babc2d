// Fused NeRF MLP forward for Hopper (sm_90a), bf16 tensor-core products
// with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_mlp.py::_fused_fwd_impl
// (kernel _fwd_kernel over _fwd_tile): the whole 8x256 NeRF MLP with
// viewdirs — trunk_0..7 with the [x, h] concat after trunk_4's relu, the
// sigma head, the bottleneck, one 128-wide view layer over
// [bottleneck, views] and the rgb head. Every product takes bf16
// operands (the left operand is rounded to bf16 first, concats included)
// and accumulates in float32; the bias is added in float32; relu follows.
//
// Bound: per sample 593,408 live multiply-adds (1.19 MFLOP) against 416
// bytes of input and output (x [64] and v [32] float32 in, [8] float32
// out): ~2,850 FLOP per byte, far above the H100's ~295 bf16 FLOP per
// byte of HBM, so the kernel is bound by tensor-core operations.
//
// Design: the TPU kernel keeps all ~1.3 MB of bf16 weights resident in
// VMEM. A Hopper block has at most 227 KB of shared memory, so here each
// block owns a 64-row tile whose activations stay in shared memory as
// bf16 (64 x [x 64 | h 256 | v 32] columns, 45 KB), walks the 12 layers,
// and streams each layer's weights through a double-buffered 32-deep
// K-slice with cp.async. Every block reads the same weights, so they
// stay in the 50 MB L2 and HBM traffic is the activations' 416 B per
// row. Products are mma.sync.m16n8k16 (8 warps, each a 32-row by
// N/4-column tile); the four live columns of each narrow head (sigma
// and rgb) are float32 dot products over the bf16 activations. Rows past
// n are computed on zeros and never stored, so callers need no padding.
// wgmma, TMA and warp specialisation are left for later work. The tile
// code is shared with the backward kernels (mlp_tile.cuh).
//
// Weight buffer (bf16, built by ops/kernels/fused_mlp.py::kernel_weights):
// the matrices transposed to [out][in] (k contiguous), then the heads'
// four columns transposed, then the biases; offsets in mlp_tile.cuh.

#include "mlp_tile.cuh"

extern "C" {

long long fused_mlp_fwd_weight_elems() { return mlp::N_WEIGHTS; }

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 64] float32, v [n, 32] float32, w the bf16 weight buffer,
// out [n, 8] float32 (columns 0..3 rgb head, 4..7 sigma head); launched
// on `stream`. Returns the CUDA error of the launch, 0 on success.
int fused_mlp_fwd(const void* x, const void* v, const void* w, void* out, long long n,
                  void* stream) {
  if (n <= 0) return 0;
  return static_cast<int>(mlp::launch_forward<mlp::IN_ENCODED>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const mlp::bf16*>(w), static_cast<float*>(out), n, nullptr, 0, 0, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
