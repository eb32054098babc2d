// Fused NeRF MLP weight-gradient backward for Hopper (sm_90a), bf16 wgmma
// products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_mlp.py::_fused_bwd (kernel
// _bwd_kernel over _mlp_backward): given the inputs x [n, 64], v [n, 32]
// and the output gradient g [n, 8] of fused_mlp_fwd (all eight columns
// read: 0..3 the rgb head's, 4..7 the sigma head's), the gradients of all
// 24 padded weights and biases (FusedMLPWeights layout, float32). The
// inputs get none, as on the TPU. Like the TPU kernel it recomputes the
// forward; its rounding points are _mlp_backward's: mmT rounds both
// operands to bf16, mmBT rounds g, the relu masks come from the sign of
// the activation, the bias gradients are float32 sums.
//
// Bound: per row 593,408 live multiply-adds for each of the recomputed
// forward, dX and dW products, 3.56 MFLOP in all, against 448 bytes of
// input (x, v, g) and 2.58 MB of gradients for the whole call: bound by
// tensor-core operations. The stashes (A 2,528 and G 2,440 bf16 features
// a row, each written once and read about twice) are not in that bound.
//
// Design: the raw-points backward's three passes (fused_mlp_raw_bwd.cu,
// K1rb) on the wgmma core (mlp_sm90.cuh) in its encoded input mode. The
// forward is K1f's (IN_ENCODED) with the activation stash: its x and v
// features are the row's own encodings rounded to bf16, exactly the
// operands the reference's mmT rounds; it stages each layer's output into
// the stash by bulk copies and adds each 64-deep slab's products into
// float32 registers (PROMOTE), which the float64-sums rule needs. Rows
// past n are zeros, so the padded tile's stash is finite, and g reads as
// zero there, so they add nothing to dW or the bias sums. Then the dX pass
// on the caller's g (the gradient stash and per-block bias sums over a
// fixed grid of DX_BLOCKS blocks), the split-K dW pass and mlp_tile.cuh's
// fixed-order reduce: the same bits on every run.

#include "mlp_sm90.cuh"

extern "C" {

long long fused_mlp_bwd_weight_elems() { return sm90::SW_WEIGHTS; }
long long fused_mlp_bwd_weight_t_elems() { return sm90::SWT_WEIGHTS; }
long long fused_mlp_bwd_grad_elems() { return mlp::GRAD_ELEMS; }
long long fused_mlp_bwd_workspace_bytes(long long n) { return sm90::workspace_bytes(n, sm90::K1_FEATS, false); }

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 64], v [n, 32], g [n, 8] float32; w, wt the bf16 forward and dX
// weight buffers of mlp_sm90.cuh (the model's layout); grads [GRAD_ELEMS]
// float32; workspace of fused_mlp_bwd_workspace_bytes(n) bytes, 256-byte
// aligned. Launched on `stream`; returns the first CUDA error, 0 on
// success.
int fused_mlp_bwd(const void* x, const void* v, const void* g, const void* w, const void* wt,
                  void* grads, long long n, void* workspace, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::Workspace ws = sm90::carve(workspace, n, sm90::K1_FEATS, false);
  cudaError_t err = sm90::launch_forward<sm90::IN_ENCODED, true>(
      static_cast<const float*>(x), static_cast<const float*>(v), static_cast<const mlp::bf16*>(w), nullptr, n,
      ws.A, 1, 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dx_blocks = 0;
  err = sm90::launch_dx<false>({static_cast<const float*>(g), nullptr, 0}, n, static_cast<const mlp::bf16*>(wt),
                               ws, &dx_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::launch_dw(n, ws, dx_blocks, static_cast<float*>(grads), s));
}

}  // extern "C"
