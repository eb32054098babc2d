// Fused NeRF-SH trunk forward for Hopper (sm_90a), bf16 wgmma products
// with float32 accumulation.
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
// Design: the wgmma core's forward (mlp_sm90.cuh) in its NeRF-SH input
// mode (IN_SH): the NeRF trunk's eight layers, with dense 5's input
// columns permuted to the core's [x | h4] (ops/kernels/fused_sh_mlp.py
// packs them so), under the NeRF-SH head. A persistent grid of 128-row
// tiles, two warpgroups of 64 rows sharing each 64-deep weight slab that
// one bulk copy stages into a ring of shared-memory stages; each layer's
// float32 accumulators, biased, relu'd and rounded to bf16, stay in
// registers as the next layer's wgmma fragments. The sigma head is an n8
// product (column 0 live); the coefficient head one product over num_rgb
// rounded up to 32 columns of its 128-row slabs, stored a float at a time
// (rows of num_rgb floats need not be 8-byte aligned). The TPU kernel
// keeps all weights in VMEM at 512 rows; here every block streams them
// from L2 (evict_last). As K1f, the serving forward has no per-slab
// promotion. Rows past n are computed on zeros and never stored, so
// callers pad nothing.

#include "mlp_sm90.cuh"

extern "C" {

long long fused_sh_fwd_weight_elems() { return sm90::SH_WEIGHTS; }

const char* fused_sh_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 63] float32; w the bf16 weight buffer of mlp_sm90.cuh's NeRF-SH
// layout; rgb [n, num_rgb] and sig [n] float32 out. Launched on `stream`;
// returns the first CUDA error, 0 on success.
int fused_sh_fwd(const void* x, const void* w, void* rgb, void* sig, long long n, int num_rgb,
                 void* stream) {
  if (n <= 0 || num_rgb < 1 || num_rgb > sm90::SH_MAX_RGB) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90::launch_forward<sm90::IN_SH, false>(
      static_cast<const float*>(x), nullptr, static_cast<const mlp::bf16*>(w), static_cast<float*>(rgb), n,
      nullptr, 1, 8, static_cast<cudaStream_t>(stream), static_cast<float*>(sig), num_rgb));
}

}  // extern "C"
