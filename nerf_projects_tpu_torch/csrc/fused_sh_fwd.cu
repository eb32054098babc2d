// Fused NeRF-SH trunk forward for Hopper (sm_90a), bf16 tensor-core
// products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_sh_mlp.py::_fused_sh_impl
// (kernel _fwd_kernel over _fwd_tile): encoded points x [n, 63] float32 ->
// the coefficient head's num_rgb columns [n, num_rgb] and the sigma head
// [n] float32. Its rounding points are _fwd_tile's: each product rounds
// its left operand (the [h, x] concat included) to bf16 and accumulates in
// float32; biases are bf16 (pack_sh_params packs them so), added in float32.
//
// Bound: per row 491,008 + 256 (num_rgb + 1) live multiply-adds (503,552
// at sh_deg 3, ~1.0 MFLOP) against (63 + num_rgb + 1) * 4 bytes in and out:
// bound by tensor-core operations.
//
// Design (fused_sh_tile.cuh over mlp_tile.cuh): a block owns a 64-row
// tile whose activations stay in shared memory as bf16, and streams each
// layer's weights from L2 through a double-buffered cp.async K-slice; the
// TPU kernel instead holds all weights in VMEM at 512 rows. The coefficient
// head is a tensor-core product over num_rgb rounded up to 32 columns.
// Rows past n are computed on zeros and never stored, so callers pad
// nothing.

#include "fused_sh_tile.cuh"

extern "C" {

long long fused_sh_fwd_weight_elems() { return sh::N_WEIGHTS; }

const char* fused_sh_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 63] float32; w the bf16 forward weight buffer; rgb [n, num_rgb]
// and sig [n] float32 out. Launched on `stream`; returns the first CUDA
// error, 0 on success.
int fused_sh_fwd(const void* x, const void* w, void* rgb, void* sig, long long n, int num_rgb,
                 void* stream) {
  if (n <= 0 || num_rgb < 1 || num_rgb > sh::MAX_RGB) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sh::launch_forward(
      static_cast<const float*>(x), static_cast<const sh::bf16*>(w), static_cast<float*>(rgb),
      static_cast<float*>(sig), n, num_rgb, nullptr, 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
