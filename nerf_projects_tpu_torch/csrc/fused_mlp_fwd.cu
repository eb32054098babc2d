// Fused NeRF MLP forward for Hopper (sm_90a), bf16 wgmma products with
// float32 accumulation.
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
// Design: mlp_sm90.cuh's forward in its encoded input mode (IN_ENCODED),
// as the raw-points forward (fused_mlp_raw_fwd.cu) runs it on raw inputs:
// a persistent grid of 128-row tiles, two warpgroups of 64 rows sharing
// each 64-deep weight slab that one bulk copy stages into a ring of
// shared-memory stages; each layer's float32 accumulators, biased, relu'd
// and rounded to bf16, stay in registers as the next layer's wgmma
// fragments. The TPU kernel keeps all ~1.3 MB of weights in VMEM; here
// every block streams them from L2 (evict_last). Without a stash there is
// no per-slab promotion: the serving forward is held to its plain version
// within KERNEL_TOL, as K1rf. Rows past n are computed on zeros and never
// stored, so callers need no padding.
//
// Weight buffer (bf16, ops/kernels/fused_mlp.py::kernel_weights_sm90 in
// the model's layout): each layer's [out][in] matrix as 64-deep K-slabs
// of wgmma's core matrices, then the biases; offsets SW_* in mlp_sm90.cuh.

#include "mlp_sm90.cuh"

extern "C" {

long long fused_mlp_fwd_weight_elems() { return sm90::SW_WEIGHTS; }

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 64] float32, v [n, 32] float32, w the bf16 weight buffer,
// out [n, 8] float32 (columns 0..3 rgb head, 4..7 sigma head); launched
// on `stream`. Returns the CUDA error of the launch, 0 on success.
int fused_mlp_fwd(const void* x, const void* v, const void* w, void* out, long long n, void* stream) {
  return static_cast<int>(sm90::launch_forward<sm90::IN_ENCODED, false>(
      static_cast<const float*>(x), static_cast<const float*>(v), static_cast<const mlp::bf16*>(w),
      static_cast<float*>(out), n, nullptr, 1, 8, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
