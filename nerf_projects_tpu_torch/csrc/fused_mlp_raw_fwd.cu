// Fused NeRF MLP forward on raw points for Hopper (sm_90a): the
// positional encoding is done in the kernel; bf16 wgmma products with
// float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_mlp.py::_fused_raw_impl
// (kernel _fwd_raw_kernel): fused_mlp_fwd.cu's 8x256 viewdirs NeRF MLP
// on raw points p [n, 8] and unit view directions v [n, 8] (columns 0..2
// live), each row encoded as _encode_tile does: [p(3), sin(2^f p) f<F,
// sin(2^f p + pi/2) f<F] in the block layout, F = 10 for the points
// (63 of 64 columns) and F = 4 for the directions (27 of 32), float32
// sinf (no fast-math: 2^9 |p| reaches thousands of radians). The weights
// are kernel_weights_sm90(model, raw_layout=True): trunk_0's, trunk_5's x
// and view_0's view rows permuted to the block layout, packed in
// mlp_sm90.cuh's slabs.
//
// Bound: the products of fused_mlp_fwd.cu, 593,408 live multiply-adds a
// row (1.19 MFLOP), against 96 bytes of input and output a row (p and v
// [8] float32 in, [8] float32 out) instead of K1f's 416: bound by
// tensor-core operations. The encoder adds 84 sinf a row on the float32
// units, outside that bound.
//
// Design: mlp_sm90.cuh's forward (two warpgroups of 64 rows share each
// weight slab; activations stay in registers as the next layer's wgmma
// fragments) in K2's raw input mode (IN_TRAIN_RAW), which reads the view
// direction of row r from vt[(r / S / R) * 8 + (r / S) % R] [8]. With
// S = 1 and R = 8 that is row r of a per-row [n, 8] array, so this kernel
// is that mode at S = 1, R = 8; the encodings are rounded to bf16 into the
// first layer's fragments. K1f (fused_mlp_fwd.cu) is the same forward on
// encodings (IN_ENCODED): over this kernel's raw-layout weights and on the
// encodings that _encode_tile gives, it must give this kernel's output bit
// for bit, which holds the in-kernel encoder to the host's.

#include "mlp_sm90.cuh"

extern "C" {

long long fused_mlp_raw_fwd_weight_elems() { return sm90::SW_WEIGHTS; }

const char* fused_mlp_raw_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p [n, 8], v [n, 8] float32 (columns 0..2 live), w the bf16 raw-layout
// weight buffer of mlp_sm90.cuh, out [n, 8] float32 (columns 0..3 rgb
// head, 4..7 sigma head); launched on `stream`. Returns the CUDA error of
// the launch.
int fused_mlp_raw_fwd(const void* p, const void* v, const void* w, void* out, long long n, void* stream) {
  return static_cast<int>(sm90::launch_forward<sm90::IN_TRAIN_RAW, false>(
      static_cast<const float*>(p), static_cast<const float*>(v), static_cast<const mlp::bf16*>(w),
      static_cast<float*>(out), n, nullptr, 1, 8, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
