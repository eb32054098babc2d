// Fused NeRF train level for Hopper (sm_90a): MLP forward, volume
// compositing, the MSE loss gradient and the MLP weight-gradient backward
// for one level of the hierarchy.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_train.py::fused_train_level
// (kernel _make_kernel). Rows are ray-major (row = ray * S + sample); the
// per-ray inputs vt are [T, 8, 8] raw (direction 0..2, target 4..6) or
// [T, 8, 32] encoded (view encoding 0..26, target 28..30), with R rays of
// each 8-row block live. Outputs: the composited rgb [n_rays, 3], acc
// [n_rays], optionally the sample weights [n_rays, S], and the 24 weight
// gradients of L = mean((rgb - target)^2) * n_rays / n_rays_total.
//
// Arithmetic (fused_train.py:142-176): sigma = relu(logit); tau =
// sigma * dist (dist carries the 1e10 tail); T = exp(exclusive sum of
// log(exp(-tau) + 1e-10)); w = (1 - exp(-tau)) * T; rgb = sigmoid; the
// composite plus (1 - acc) * bkgd; g = 2 (rgb_out - target) / (3 n_rays_total);
// dtau = T e s - e / (e + 1e-10) * suffix(w s), s = sum_c g_c (rgb_c - bkgd);
// d_sigma where logit > 0; d_rgb = g w rgb (1 - rgb). The view columns from
// 27 on are zero before the view layer. Activations are kept in bf16, as
// the TPU kernel's stash_dtype; the products round as _mlp_backward's.
//
// Bound: per row 3 x 593,408 live multiply-adds (forward, dX, dW): 3.56
// MFLOP against 64 or 288 bytes of input, so tensor-core operations bind.
//
// Design: the TPU kernel runs per-ray prefix and suffix sums as matmuls
// against a [TILE, TILE] 0/1 matrix; here a warp owns a ray and scans its
// samples with shuffles, 32 at a time (a forward scan for T, a reverse
// scan for the suffix), so any S fits. The MLP passes run on the wgmma
// core (mlp_sm90.cuh): the forward writes the bf16 activation stash, then
// compositing, dX (writing the gradient stash and per-block bias sums),
// split-K dW and mlp_tile.cuh's fixed-order sums; the result is the same
// bits on every run. The positional encoding of raw inputs is done in the
// forward (block layout, cos as sin(x + pi/2)). The weights are
// kernel_weights_sm90 (w) and kernel_weights_sm90_bwd (wt).

#include "mlp_sm90.cuh"

namespace {

using mlp::FULL;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// One warp per ray. raw [n, 8] (rgb logits 0..2, sigma logit 4); dist in
// column 3 of x [n, 8] (raw) or 63 of x [n, 64] (encoded). Writes g8 [n, 8]
// (d_rgb 0..2, d_sigma 4, zeros elsewhere), rgb_out, acc and, when w_out
// is not null, the weights.
template <bool RAW>
__global__ void __launch_bounds__(mlp::THREADS)
    composite_kernel(const float* __restrict__ raw, const float* __restrict__ x,
                     const float* __restrict__ vt, long long n_rays, int S, int R, float bkgd,
                     float denom, float* __restrict__ g8, float* __restrict__ rgb_out,
                     float* __restrict__ acc_out, float* __restrict__ w_out) {
  extern __shared__ float csm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * (mlp::THREADS / 32) + warp;
  if (ray >= n_rays) return;
  float* Tr = csm + warp * 3 * S;
  float* Wt = Tr + S;
  float* Ee = Wt + S;
  const long long base = ray * S;
  const float* tgt = vt + ((ray / R) * 8 + ray % R) * (RAW ? 8 : 32) + (RAW ? 4 : 28);
  const int xc = RAW ? 8 : 64, dc = RAW ? 3 : 63;

  float carry = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    const long long row = base + s;
    float e = 1.f, lterm = 0.f;
    if (valid) {
      const float tau = fmaxf(raw[row * 8 + 4], 0.f) * x[row * xc + dc];
      e = expf(-tau);
      lterm = logf(e + 1e-10f);
    }
    float incl = lterm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    const float logT = carry + excl;
    carry += __shfl_sync(FULL, incl, 31);
    if (valid) {
      const float T = expf(logT);
      const float w = (1.f - e) * T;
      c0 += w * sigmoid(raw[row * 8 + 0]);
      c1 += w * sigmoid(raw[row * 8 + 1]);
      c2 += w * sigmoid(raw[row * 8 + 2]);
      acc += w;
      Tr[s] = T;
      Wt[s] = w;
      Ee[s] = e;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c0 += __shfl_xor_sync(FULL, c0, o);
    c1 += __shfl_xor_sync(FULL, c1, o);
    c2 += __shfl_xor_sync(FULL, c2, o);
    acc += __shfl_xor_sync(FULL, acc, o);
  }
  const float o0 = c0 + (1.f - acc) * bkgd;
  const float o1 = c1 + (1.f - acc) * bkgd;
  const float o2 = c2 + (1.f - acc) * bkgd;
  const float g0 = 2.f * (o0 - tgt[0]) / denom;
  const float g1 = 2.f * (o1 - tgt[1]) / denom;
  const float g2 = 2.f * (o2 - tgt[2]) / denom;
  if (lane == 0) {
    rgb_out[ray * 3 + 0] = o0;
    rgb_out[ray * 3 + 1] = o1;
    rgb_out[ray * 3 + 2] = o2;
    acc_out[ray] = acc;
  }

  carry = 0.f;
  for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    const long long row = base + s;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, srow = 0.f, ws = 0.f;
    if (valid) {
      r0 = sigmoid(raw[row * 8 + 0]);
      r1 = sigmoid(raw[row * 8 + 1]);
      r2 = sigmoid(raw[row * 8 + 2]);
      srow = g0 * (r0 - bkgd) + g1 * (r1 - bkgd) + g2 * (r2 - bkgd);
      ws = Wt[s] * srow;
    }
    float incl = ws;  // inclusive suffix within the chunk
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(FULL, incl, o);
      if (lane + o < 32) incl += y;
    }
    float excl = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) excl = 0.f;
    const float suf = carry + excl;
    carry += __shfl_sync(FULL, incl, 0);
    if (valid) {
      const float e = Ee[s], T = Tr[s], w = Wt[s];
      const float logit = raw[row * 8 + 4];
      const float r_eps = e / (e + 1e-10f);
      const float dtau = T * e * srow - r_eps * suf;
      float* o = g8 + row * 8;
      o[0] = g0 * w * r0 * (1.f - r0);
      o[1] = g1 * w * r1 * (1.f - r1);
      o[2] = g2 * w * r2 * (1.f - r2);
      o[3] = 0.f;
      o[4] = logit > 0.f ? dtau * x[row * xc + dc] : 0.f;
      o[5] = 0.f;
      o[6] = 0.f;
      o[7] = 0.f;
      if (w_out) w_out[base + s] = w;
    }
  }
}

template <bool RAW>
cudaError_t train_level(const float* x, const float* vt, const mlp::bf16* w,
                        const mlp::bf16* wt, long long n_rays, int S, int R,
                        long long n_rays_total, float bkgd, float* rgb_out, float* acc_out,
                        float* w_out, float* grads, void* workspace, cudaStream_t stream) {
  const long long n = n_rays * S;
  const sm90::Workspace ws = sm90::carve(workspace, n, sm90::K1_FEATS, true);
  cudaError_t err = sm90::launch_forward<RAW ? sm90::IN_TRAIN_RAW : sm90::IN_TRAIN_ENC, true>(
      x, vt, w, ws.raw, n, ws.A, S, R, stream);
  if (err != cudaSuccess) return err;
  const int rays_per_block = mlp::THREADS / 32;
  const long long blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  const int smem = rays_per_block * 3 * S * 4;
  err = cudaFuncSetAttribute(composite_kernel<RAW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  composite_kernel<RAW><<<static_cast<unsigned>(blocks), mlp::THREADS, smem, stream>>>(
      ws.raw, x, vt, n_rays, S, R, bkgd, 3.0f * static_cast<float>(n_rays_total), ws.g8,
      rgb_out, acc_out, w_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int dx_blocks = 0;
  if ((err = sm90::launch_dx<false>({ws.g8, nullptr, 0}, n, wt, ws, &dx_blocks, stream)) != cudaSuccess) return err;
  return sm90::launch_dw(n, ws, dx_blocks, grads, stream);
}

}  // namespace

extern "C" {

long long fused_train_weight_elems() { return sm90::SW_WEIGHTS; }
long long fused_train_weight_t_elems() { return sm90::SWT_WEIGHTS; }
long long fused_train_grad_elems() { return mlp::GRAD_ELEMS; }
long long fused_train_workspace_bytes(long long n_rows) { return sm90::workspace_bytes(n_rows, sm90::K1_FEATS, true); }

const char* fused_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n_rays * S, 8] raw points (xyz 0..2, dist 3) or [.., 64] encoded
// (dist in 63); vt [n_rays / R, 8, 8 or 32]; w, wt the bf16 forward and
// dX weight buffers of mlp_sm90.cuh (kernel_weights_sm90, permuted to the
// block encoding when raw_inputs, and kernel_weights_sm90_bwd); rgb_out
// [n_rays, 3], acc_out [n_rays], w_out [n_rays, S] or null, grads
// [GRAD_ELEMS], all float32; workspace of
// fused_train_workspace_bytes(n_rays * S) bytes. Returns the first CUDA
// error, 0 on success.
int fused_train_level(const void* x, const void* vt, const void* w, const void* wt,
                      long long n_rays, int S, int R, int raw_inputs, long long n_rays_total,
                      float bkgd, void* rgb_out, void* acc_out, void* w_out, void* grads,
                      void* workspace, void* stream) {
  if (n_rays <= 0 || S <= 0 || R <= 0 || R > 8 || n_rays % R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = raw_inputs ? train_level<true> : train_level<false>;
  return static_cast<int>(fn(static_cast<const float*>(x), static_cast<const float*>(vt),
                             static_cast<const mlp::bf16*>(w), static_cast<const mlp::bf16*>(wt),
                             n_rays, S, R, n_rays_total, bkgd, static_cast<float*>(rgb_out),
                             static_cast<float*>(acc_out), static_cast<float*>(w_out),
                             static_cast<float*>(grads), workspace,
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
