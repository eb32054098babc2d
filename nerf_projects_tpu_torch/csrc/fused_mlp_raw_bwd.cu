// Fused NeRF MLP weight-gradient backward on raw points for Hopper
// (sm_90a), the positional encoding done in the kernel; bf16 tensor-core
// products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_mlp.py::_fused_raw_bwd
// (kernel _bwd_raw_kernel over _mlp_backward): given raw points p [n, 8],
// view directions v [n, 8] (columns 0..2 live) and the output gradient
// g [n, 8] of fused_mlp_raw_fwd, the gradients of all 24 padded weights
// and biases in the raw layout (FusedMLPWeights, float32); p and v get
// none, as on the TPU. Like the TPU kernel it re-encodes the inputs and
// recomputes the forward; dW0 and w5's x rows take the bf16 encodings,
// as mmT rounds them.
//
// Bound: fused_mlp_bwd.cu's 3.56 MFLOP a row (recomputed forward, dX and
// dW), against 96 bytes of input a row (p, v, g) and 2.58 MB of
// gradients for the whole call: bound by tensor-core operations.
//
// Design: fused_mlp_bwd.cu's three passes (mlp_tile.cuh). The forward
// pass is fused_mlp_raw_fwd.cu's (the raw input mode at S = 1, R = 8)
// writing the activation stash: its x features A_X hold the bf16 block
// encodings of the points and A_V those of the directions, exactly the
// operands the reference's mmT rounds, so the dX and dW passes run
// unchanged. The backward weight buffer (kernel_weights_bwd) has no raw
// layout: the dX products read trunk_5's h rows and view_0's bottleneck
// rows, never the permuted input rows.

#include "mlp_tile.cuh"

extern "C" {

long long fused_mlp_raw_bwd_weight_elems() { return mlp::N_WEIGHTS; }
long long fused_mlp_raw_bwd_weight_t_elems() { return mlp::NT_WEIGHTS; }
long long fused_mlp_raw_bwd_grad_elems() { return mlp::GRAD_ELEMS; }
long long fused_mlp_raw_bwd_workspace_bytes(long long n) { return mlp::workspace_bytes(n, false); }

const char* fused_mlp_raw_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p [n, 8], v [n, 8], g [n, 8] float32; w, wt the bf16 raw-layout
// forward and backward weight buffers; grads [GRAD_ELEMS] float32;
// workspace of fused_mlp_raw_bwd_workspace_bytes(n) bytes, 256-byte
// aligned. Launched on `stream`; returns the first CUDA error, 0 on
// success.
int fused_mlp_raw_bwd(const void* p, const void* v, const void* g, const void* w, const void* wt,
                      void* grads, long long n, void* workspace, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mlp::Workspace ws = mlp::carve(workspace, n, false);
  const mlp::bf16* wb = static_cast<const mlp::bf16*>(w);
  cudaError_t err = mlp::launch_forward<mlp::IN_TRAIN_RAW>(
      static_cast<const float*>(p), static_cast<const float*>(v), wb, nullptr, n, ws.A,
      mlp::padded_rows(n), 1, 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mlp::run_backward(static_cast<const float*>(g), n, wb,
                                            static_cast<const mlp::bf16*>(wt), ws,
                                            static_cast<float*>(grads), s));
}

}  // extern "C"
