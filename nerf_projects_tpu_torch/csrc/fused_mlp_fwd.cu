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
// wgmma, TMA and warp specialisation are left for later work.
//
// Weight buffer (bf16, built by ops/kernels/fused_mlp.py::kernel_weights):
// the matrices transposed to [out][in] (k contiguous), then the heads'
// four columns transposed, then the biases; offsets below.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr int KS = 32;        // depth of a staged weight slice
constexpr int WS = KS + 8;    // padded row stride of a staged slice (bf16)
constexpr int AS = 352 + 8;   // padded row stride of the activation tile (bf16)
constexpr int COL_X = 0;      // activation columns: [x 0..63 | h 64..319 | v 320..351]
constexpr int COL_H = 64;
constexpr int COL_V = 320;

constexpr long long OFF_W0 = 0;                       // [256][64]
constexpr long long OFF_W1 = OFF_W0 + 256 * 64;       // w1..w4, [256][256] each
constexpr long long OFF_W5 = OFF_W1 + 4 * 256 * 256;  // [256][320]
constexpr long long OFF_W6 = OFF_W5 + 256 * 320;      // w6, w7, [256][256] each
constexpr long long OFF_WB = OFF_W6 + 2 * 256 * 256;  // [256][256]
constexpr long long OFF_WV = OFF_WB + 256 * 256;      // [128][288]
constexpr long long OFF_WSIG = OFF_WV + 128 * 288;    // [4][256]
constexpr long long OFF_WRGB = OFF_WSIG + 4 * 256;    // [4][128]
constexpr long long OFF_B = OFF_WRGB + 4 * 128;       // b0..b7, [256] each
constexpr long long OFF_BB = OFF_B + 8 * 256;         // [256]
constexpr long long OFF_BV = OFF_BB + 256;            // [128]
constexpr long long OFF_BSIG = OFF_BV + 128;          // [4]
constexpr long long OFF_BRGB = OFF_BSIG + 4;          // [4]
constexpr long long N_WEIGHTS = OFF_BRGB + 4;

constexpr int SMEM_BYTES = (BM * AS + 2 * 256 * WS) * 2;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage wt[0:N][k0:k0+KS] (row stride K) into a padded [N][WS] slice.
template <int N>
__device__ __forceinline__ void load_slice(__nv_bfloat16* dst, const __nv_bfloat16* wt,
                                           int K, int k0) {
  constexpr int PARTS = KS / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < N * PARTS; c += THREADS) {
    const int n = c / PARTS, part = c % PARTS;
    cp_async16(dst + n * WS + part * 8, wt + static_cast<long long>(n) * K + k0 + part * 8);
  }
  cp_async_commit();
}

// act[:, in_col:in_col+K] @ wt^T + bias (relu optional), rounded to bf16
// into act[:, out_col:out_col+N] once every warp has read its input.
template <int N, bool RELU>
__device__ __forceinline__ void dense_layer(__nv_bfloat16* act, __nv_bfloat16* wbuf,
                                            const __nv_bfloat16* wt,
                                            const __nv_bfloat16* bias, int K,
                                            int in_col, int out_col) {
  constexpr int NT = N / 32;  // 8-column tiles per warp: 4 warp columns of N/4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 32;
  const int col0 = (warp & 3) * (N / 4);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int nslices = K / KS;
  load_slice<N>(wbuf, wt, K, 0);
  for (int s = 0; s < nslices; ++s) {
    if (s + 1 < nslices) {
      load_slice<N>(wbuf + ((s + 1) & 1) * 256 * WS, wt, K, (s + 1) * KS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ws = wbuf + (s & 1) * 256 * WS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = act + (row0 + mt * 16 + g) * AS + in_col + s * KS + kk + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * AS);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * AS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* q = ws + (col0 + nt * 8 + g) * WS + kk + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = col0 + nt * 8 + 2 * t;
    const float bias0 = __bfloat162float(bias[n]);
    const float bias1 = __bfloat162float(bias[n + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = acc[mt][nt][2 * half] + bias0;
        float v1 = acc[mt][nt][2 * half + 1] + bias1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int r = row0 + mt * 16 + g + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(act + r * AS + out_col + n) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
  __syncthreads();
}

// float32 dot product of k bf16 pairs (k even).
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                          int k) {
  float s = 0.f;
  for (int i = 0; i < k; i += 2) {
    const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + i));
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + i));
    s = fmaf(av.x, bv.x, s);
    s = fmaf(av.y, bv.y, s);
  }
  return s;
}

// Load a [BM, C] float32 tile (row stride C) as bf16 into act columns col..col+C.
template <int C>
__device__ __forceinline__ void load_input(__nv_bfloat16* act, const float* src,
                                           long long row_base, long long n, int col) {
  constexpr int V4 = C / 4;
  for (int i = threadIdx.x; i < BM * V4; i += THREADS) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_base + r < n) val = *reinterpret_cast<const float4*>(src + (row_base + r) * C + c);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(act + r * AS + col + c);
    dst[0] = __floats2bfloat162_rn(val.x, val.y);
    dst[1] = __floats2bfloat162_rn(val.z, val.w);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ v,
                         const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                         long long n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wbuf = act + BM * AS;
  const long long row_base = static_cast<long long>(blockIdx.x) * BM;

  load_input<64>(act, x, row_base, n, COL_X);
  load_input<32>(act, v, row_base, n, COL_V);
  __syncthreads();

  dense_layer<256, true>(act, wbuf, w + OFF_W0, w + OFF_B, 64, COL_X, COL_H);
  for (int l = 1; l <= 4; ++l)
    dense_layer<256, true>(act, wbuf, w + OFF_W1 + (l - 1) * 256 * 256, w + OFF_B + l * 256,
                           256, COL_H, COL_H);
  // trunk_5 reads [x | h4], columns 0..319
  dense_layer<256, true>(act, wbuf, w + OFF_W5, w + OFF_B + 5 * 256, 320, COL_X, COL_H);
  for (int l = 6; l <= 7; ++l)
    dense_layer<256, true>(act, wbuf, w + OFF_W6 + (l - 6) * 256 * 256, w + OFF_B + l * 256,
                           256, COL_H, COL_H);

  // four threads per row; thread j computes column j of each head
  const int r = threadIdx.x >> 2, j = threadIdx.x & 3;
  const float sig = dot_bf16(act + r * AS + COL_H, w + OFF_WSIG + j * 256, 256) +
                    __bfloat162float(w[OFF_BSIG + j]);
  dense_layer<256, false>(act, wbuf, w + OFF_WB, w + OFF_BB, 256, COL_H, COL_H);
  // view layer reads [bottleneck | v], columns 64..351
  dense_layer<128, true>(act, wbuf, w + OFF_WV, w + OFF_BV, 288, COL_H, COL_H);
  const float rgb = dot_bf16(act + r * AS + COL_H, w + OFF_WRGB + j * 128, 128) +
                    __bfloat162float(w[OFF_BRGB + j]);
  if (row_base + r < n) {
    out[(row_base + r) * 8 + j] = rgb;
    out[(row_base + r) * 8 + 4 + j] = sig;
  }
}

}  // namespace

extern "C" {

long long fused_mlp_fwd_weight_elems() { return N_WEIGHTS; }

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 64] float32, v [n, 32] float32, w the bf16 weight buffer,
// out [n, 8] float32 (columns 0..3 rgb head, 4..7 sigma head); launched
// on `stream`. Returns the CUDA error of the launch, 0 on success.
int fused_mlp_fwd(const void* x, const void* v, const void* w, void* out, long long n,
                  void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + BM - 1) / BM;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_fwd_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
