// The mma.sync tile of the fused NeRF-SH trunk's weight-gradient backward
// for Hopper (sm_90a): fused_sh_bwd.cu (K5b), through fused_sh_tile.cuh,
// runs on its GEMM, stash and dW code. Its stash feature map, gradient
// layout, encoder (encode_col) and fixed-order reduce are shared with the
// wgmma core (mlp_sm90.cuh), which runs every other MLP kernel (K1f, K1b,
// K1rf, K1rb, K2, K5f). Once K5b moves onto that core, the GEMM code here
// (gemm_tile, dense_layer, the dX epilogue and mlp_dw_kernel) goes.
//
// The feature maps are those of the 8x256 viewdirs NeRF MLP of
// models/nerf.py: trunk_0..7 with the [x, h] concat after trunk_4's relu,
// the sigma head, the bottleneck, one 128-wide view layer over
// [bottleneck, views] and the rgb head. Every product takes bf16 operands
// and accumulates in float32 (mma.sync.m16n8k16), as the TPU kernels' _mm
// / mmT / mmBT do.
//
// A block owns a 64-row tile whose activations stay in shared memory as
// bf16 and streams each layer's weights through a double-buffered 32-deep
// K-slice with cp.async (dense_layer). The backward is three passes over
// bf16 stashes in device memory, feature-major ([feature][row], rows padded
// to 64): the forward writes every activation the backward reads to the
// activation stash (stash_cols); a dX pass walks the gradient down the
// layers (dX products with the transposed weights, relu masks from the
// activation stash; dx_epilogue), writes each layer's output gradient,
// rounded to bf16, to the gradient stash and sums the float32 gradients
// into bias partials per block; mlp_dw_kernel computes dW = A^T G as a
// split-K product over rows, each block a 128x128 tile of one dW over a
// fixed span of rows; a last pass sums the partials over the splits, and
// the bias partials over the blocks, in a fixed order. The result is the
// same bits on every run. The bf16 stashes hold exactly what the reference
// rounds to bf16 at its products (mmT rounds both operands, mmBT rounds
// g), and relu masks of a bf16 value have the sign of the float32 one, so
// the stash changes no number.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // rows per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int KS = 32;        // depth of a staged weight slice
constexpr int WS = KS + 8;    // padded row stride of a staged slice (bf16)
constexpr int AS = 352 + 8;   // padded row stride of the activation tile (bf16)
constexpr int GS = 256 + 8;   // padded row stride of the gradient tile (bf16)
constexpr int COL_X = 0;      // activation columns: [x 0..63 | h 64..319]
constexpr int COL_H = 64;
constexpr float HALF_PI = 1.5707963267948966f;

// Activation stash features: x, a0..a7, bottleneck, v, hv ([bottleneck | v]
// is view_0's input, contiguous).
constexpr int A_X = 0;
constexpr int A_TRUNK = 64;  // + 256 l
constexpr int A_BNECK = A_TRUNK + 8 * 256;
constexpr int A_V = A_BNECK + 256;
constexpr int A_HV = A_V + 32;
constexpr int A_FEATS = A_HV + 128;
// Gradient stash features: the rgb and sigma head gradients (4 each), the
// view layer's, the bottleneck's, then trunk_0..7's output gradients.
constexpr int G_RGB = 0;
constexpr int G_SIG = 4;
constexpr int G_V = 8;
constexpr int G_B = G_V + 128;
constexpr int G_TRUNK = G_B + 256;  // + 256 l
constexpr int G_FEATS = G_TRUNK + 8 * 256;

// Gradient buffer: FusedMLPWeights' fields in order, padded [in][out], float32.
constexpr long long GW0 = 0;                      // [64][256]
constexpr long long GW1 = GW0 + 64 * 256;         // w1..w4 [256][256]
constexpr long long GW5 = GW1 + 4 * 256 * 256;    // [320][256]
constexpr long long GW6 = GW5 + 320 * 256;        // w6, w7
constexpr long long GWSIG = GW6 + 2 * 256 * 256;  // [256][128]
constexpr long long GWB = GWSIG + 256 * 128;      // [256][256]
constexpr long long GWV = GWB + 256 * 256;        // [288][128]
constexpr long long GWRGB = GWV + 288 * 128;      // [128][128]
constexpr long long GB0 = GWRGB + 128 * 128;      // b0..b7 [256]
constexpr long long GBSIG = GB0 + 8 * 256;        // [128]
constexpr long long GBB = GBSIG + 128;            // [256]
constexpr long long GBV = GBB + 256;              // [128]
constexpr long long GBRGB = GBV + 128;            // [128]
constexpr long long GRAD_ELEMS = GBRGB + 128;

constexpr int FWD_SMEM_BYTES = (BM * AS + 2 * 256 * WS) * 2;
constexpr int DX_MAX_BLOCKS = 264;  // fixed, so the bias sums' order does not depend on the card
constexpr int DW_TILE = 128;
constexpr int DW_SMEM_BYTES = 2 * 2 * DW_TILE * WS * 2;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// Primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// 16 bytes from gmem, or 16 zero bytes when !valid (gmem is not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
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
__device__ __forceinline__ void load_slice(bf16* dst, const bf16* wt, int K, int k0) {
  constexpr int PARTS = KS / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < N * PARTS; c += THREADS) {
    const int n = c / PARTS, part = c % PARTS;
    cp_async16(dst + n * WS + part * 8, wt + static_cast<long long>(n) * K + k0 + part * 8);
  }
  cp_async_commit();
}

// acc = tile[:, in_col:in_col+K] @ wt^T for a 64-row bf16 tile (row
// stride lda) and wt [N][K]. Warp w owns rows (w>>2)*32..+32 and columns
// (w&3)*N/4..+N/4. Ends with every warp past its last read of the tile,
// so the caller may overwrite it.
template <int N>
__device__ __forceinline__ void gemm_tile(const bf16* tile, int lda, int in_col, bf16* wbuf,
                                          const bf16* wt, int K, float (&acc)[2][N / 32][4]) {
  constexpr int NT = N / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 32;
  const int col0 = (warp & 3) * (N / 4);
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
    const bf16* ws = wbuf + (s & 1) * 256 * WS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = tile + (row0 + mt * 16 + g) * lda + in_col + s * KS + kk + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * lda);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * lda + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* q = ws + (col0 + nt * 8 + g) * WS + kk + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }
}

// act[:, in_col:in_col+K] @ wt^T + bias (relu optional), rounded to bf16
// into act[:, out_col:out_col+N]; ends synchronised.
template <int N, bool RELU>
__device__ __forceinline__ void dense_layer(bf16* act, bf16* wbuf, const bf16* wt,
                                            const bf16* bias, int K, int in_col, int out_col) {
  constexpr int NT = N / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 32;
  const int col0 = (warp & 3) * (N / 4);
  float acc[2][NT][4];
  gemm_tile<N>(act, AS, in_col, wbuf, wt, K, acc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = col0 + nt * 8 + 2 * t;
    const float bias0 = bf(bias[n]);
    const float bias1 = bf(bias[n + 1]);
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

// Copy columns col..col+ncols of a 64-row bf16 tile (row stride ld_tile)
// to stash features feat..feat+ncols, rows row_base..row_base+63 (stash
// row stride ld). Reads the tile only.
__device__ __forceinline__ void stash_cols(const bf16* tile, int ld_tile, int col, int ncols,
                                           bf16* stash, int feat, long long ld,
                                           long long row_base) {
  for (int i = threadIdx.x; i < ncols * (BM / 2); i += THREADS) {
    const int c = i / (BM / 2), rp = (i % (BM / 2)) * 2;
    __nv_bfloat162 val;
    val.x = tile[rp * ld_tile + col + c];
    val.y = tile[(rp + 1) * ld_tile + col + c];
    *reinterpret_cast<__nv_bfloat162*>(stash + (feat + c) * ld + row_base + rp) = val;
  }
}

// Block-layout positional encoding of column c of a point p (3 live):
// [p(3), sin(2^f p) f<F, sin(2^f p + pi/2) f<F], zero past 3 + 6F
// (ops/pallas/fused_mlp.py::_encode_tile). The wgmma core's raw input
// mode encodes with it.
__device__ __forceinline__ float encode_col(const float* p, int c, int n_freqs) {
  if (c < 3) return p[c];
  const int k = c - 3;
  if (k < 6 * n_freqs) {
    const bool is_cos = k >= 3 * n_freqs;
    const int j = is_cos ? k - 3 * n_freqs : k;
    const float xb = p[j % 3] * static_cast<float>(1 << (j / 3));
    return sinf(is_cos ? xb + HALF_PI : xb);
  }
  return 0.f;
}

// ---------------------------------------------------------------------------
// Backward, pass 2: the gradient down the layers (dX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool positive(const bf16* A, int feat, long long ld, long long row) {
  return bf(A[static_cast<long long>(feat) * ld + row]) > 0.f;
}

// Epilogue of a dX product over a 64-row tile: acc times the relu mask of
// activation feature mask_feat.., rounded to bf16 into gt; the float32
// column sums go to db_acc[g_feat..] in a fixed order. Ends synchronised.
__device__ __forceinline__ void dx_epilogue(float (&acc)[2][8][4], bf16* gt, const bf16* A, int mask_feat,
                                            long long ld, long long row_base, float* colsum, float* db_acc,
                                            int g_feat) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 32;
  const int col0 = (warp & 3) * 64;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = col0 + nt * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 16 + g + 8 * half;
        float v0 = acc[mt][nt][2 * half];
        float v1 = acc[mt][nt][2 * half + 1];
        if (!positive(A, mask_feat + n, ld, row_base + r)) v0 = 0.f;
        if (!positive(A, mask_feat + n + 1, ld, row_base + r)) v1 = 0.f;
        *reinterpret_cast<__nv_bfloat162*>(gt + r * GS + n) = __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(FULL, s0, o);
      s1 += __shfl_xor_sync(FULL, s1, o);
    }
    if (g == 0) {
      colsum[(warp >> 2) * 256 + n] = s0;
      colsum[(warp >> 2) * 256 + n + 1] = s1;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 256; c += THREADS) db_acc[g_feat + c] += colsum[c] + colsum[256 + c];
}

// ---------------------------------------------------------------------------
// Backward, pass 3: dW = A^T G, split over rows (a table of DW_ENTRIES
// products, fused_sh_bwd.cu's), then the fixed-order sums (the wgmma core's
// too)
// ---------------------------------------------------------------------------

struct DwEntry {
  int a_feat, m;       // activation features a_feat..a_feat+m: dW's rows
  int g_feat, n;       // gradient features g_feat..g_feat+n: dW's live columns
  long long out_off;   // first element in the gradient buffer
  int out_ld;          // dW's padded width; columns n..out_ld are written as 0
};
constexpr int DW_ENTRIES = 11;
struct DwTable {
  DwEntry e[DW_ENTRIES];
  int first_tile[DW_ENTRIES + 1];
};

// Stage src features feat0..feat0+128 (those below `valid`; zeros past
// it), rows k0..k0+KS, into a padded [128][WS] slice.
__device__ __forceinline__ void load_dw_slice(bf16* dst, const bf16* src, int feat0, int valid,
                                              long long ld, long long k0) {
  constexpr int PARTS = KS / 8;
  for (int c = threadIdx.x; c < DW_TILE * PARTS; c += THREADS) {
    const int row = c / PARTS, part = c % PARTS;
    const bool ok = row < valid;
    const bf16* p = ok ? src + static_cast<long long>(feat0 + row) * ld + k0 + part * 8 : src;
    cp_async16_zfill(dst + row * WS + part * 8, p, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    mlp_dw_kernel(const bf16* __restrict__ A, const bf16* __restrict__ G, long long ld,
                  long long rows_per_split, float* __restrict__ part, DwTable tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [2][128][WS]
  bf16* gs = as + 2 * DW_TILE * WS;              // [2][128][WS]
  int e = 0;
  while (static_cast<int>(blockIdx.x) >= tab.first_tile[e + 1]) ++e;
  const DwEntry en = tab.e[e];
  const int local = blockIdx.x - tab.first_tile[e];
  const int col_tiles = (en.out_ld + DW_TILE - 1) / DW_TILE;
  const int m0 = (local / col_tiles) * DW_TILE, n0 = (local % col_tiles) * DW_TILE;
  const long long k_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long k_end = k_begin + rows_per_split < ld ? k_begin + rows_per_split : ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int nsteps = k_end > k_begin ? static_cast<int>((k_end - k_begin) / KS) : 0;
  if (nsteps > 0) {
    load_dw_slice(as, A, en.a_feat + m0, en.m - m0, ld, k_begin);
    load_dw_slice(gs, G, en.g_feat + n0, en.n - n0, ld, k_begin);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      const int nb = (s + 1) & 1;
      load_dw_slice(as + nb * DW_TILE * WS, A, en.a_feat + m0, en.m - m0, ld, k_begin + (s + 1) * KS);
      load_dw_slice(gs + nb * DW_TILE * WS, G, en.g_feat + n0, en.n - n0, ld, k_begin + (s + 1) * KS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = as + (s & 1) * DW_TILE * WS;
    const bf16* g_s = gs + (s & 1) * DW_TILE * WS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p = a_s + (wm + mt * 16 + g) * WS + kk + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * WS);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * WS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* q = g_s + (wn + nt * 8 + g) * WS + kk + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  float* out = part + static_cast<long long>(blockIdx.y) * GB0 + en.out_off;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mt * 16 + g + 8 * half;
        const int c = n0 + wn + nt * 8 + 2 * t;
        if (m < en.m && c < en.out_ld) {
          out[static_cast<long long>(m) * en.out_ld + c] = acc[mt][nt][2 * half];
          out[static_cast<long long>(m) * en.out_ld + c + 1] = acc[mt][nt][2 * half + 1];
        }
      }
}

// Gradient-stash feature whose float32 sum is bias element b (-1: padding).
__device__ __forceinline__ int bias_feature(int b) {
  if (b < 8 * 256) return G_TRUNK + b;
  b -= 8 * 256;
  if (b < 128) return b < 4 ? G_SIG + b : -1;
  b -= 128;
  if (b < 256) return G_B + b;
  b -= 256;
  if (b < 128) return G_V + b;
  b -= 128;
  return b < 4 ? G_RGB + b : -1;
}

__global__ void mlp_grad_reduce_kernel(const float* __restrict__ part, int splits,
                                       const float* __restrict__ db_part, int db_blocks,
                                       float* __restrict__ grads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= GRAD_ELEMS) return;
  float s = 0.f;
  if (i < GB0) {
    for (int k = 0; k < splits; ++k) s += part[k * GB0 + i];
  } else {
    const int f = bias_feature(static_cast<int>(i - GB0));
    if (f >= 0)
      for (int b = 0; b < db_blocks; ++b) s += db_part[static_cast<long long>(b) * G_FEATS + f];
  }
  grads[i] = s;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline long long align256(long long bytes) { return (bytes + 255) / 256 * 256; }
inline long long padded_rows(long long n) { return (n + BM - 1) / BM * BM; }
inline int max_splits(long long npad) {
  const long long s = npad / 16384;
  return s < 1 ? 1 : (s > 16 ? 16 : static_cast<int>(s));
}

}  // namespace mlp
