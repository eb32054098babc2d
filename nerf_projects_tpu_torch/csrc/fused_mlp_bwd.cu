// Fused NeRF MLP weight-gradient backward for Hopper (sm_90a), bf16
// tensor-core products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_mlp.py::_fused_bwd (kernel
// _bwd_kernel over _mlp_backward): given the inputs x [n, 64], v [n, 32]
// and the output gradient g [n, 8] of fused_mlp_fwd, the gradients of all
// 24 padded weights and biases (FusedMLPWeights layout, float32). The
// inputs get none, as on the TPU. Like the TPU kernel it recomputes the
// forward; its rounding points are _mlp_backward's: mmT rounds both
// operands to bf16, mmBT rounds g, the relu masks come from the sign of
// the activation, the bias gradients are float32 sums.
//
// Bound: per row 593,408 live multiply-adds for each of the recomputed
// forward, dX and dW products, 3.56 MFLOP in all, against 448 bytes of
// input (x, v, g) and 2.58 MB of gradients for the whole call: bound by
// tensor-core operations.
//
// Design (mlp_tile.cuh): the forward writes a bf16 activation stash to
// device memory (5 KB a row), a dX pass writes a bf16 gradient stash
// (4.9 KB a row) and per-block float32 bias sums, and a split-K dW pass
// writes partial products that a last pass sums in a fixed order. The
// stashes cost device-memory traffic the TPU kernel does not have (each
// ~10 KB a row is written once and read about twice, ~30 KB a row); they
// buy a deterministic dW sum without atomics and without holding 2.58 MB
// of gradients in a block.

#include "mlp_tile.cuh"

extern "C" {

long long fused_mlp_bwd_weight_elems() { return mlp::N_WEIGHTS; }
long long fused_mlp_bwd_weight_t_elems() { return mlp::NT_WEIGHTS; }
long long fused_mlp_bwd_grad_elems() { return mlp::GRAD_ELEMS; }
long long fused_mlp_bwd_workspace_bytes(long long n) { return mlp::workspace_bytes(n); }

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 64], v [n, 32], g [n, 8] float32; w, wt the bf16 forward and
// backward weight buffers; grads [GRAD_ELEMS] float32; workspace of
// fused_mlp_bwd_workspace_bytes(n) bytes, 256-byte aligned. Launched on
// `stream`; returns the first CUDA error, 0 on success.
int fused_mlp_bwd(const void* x, const void* v, const void* g, const void* w, const void* wt,
                  void* grads, long long n, void* workspace, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mlp::Workspace ws = mlp::carve(workspace, n);
  const mlp::bf16* wb = static_cast<const mlp::bf16*>(w);
  cudaError_t err = mlp::launch_forward(static_cast<const float*>(x), static_cast<const float*>(v), wb, n,
                                        ws.A, mlp::padded_rows(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mlp::run_backward(static_cast<const float*>(g), n, wb,
                                            static_cast<const mlp::bf16*>(wt), ws,
                                            static_cast<float*>(grads), s));
}

}  // extern "C"
