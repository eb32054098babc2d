// Fused NeRF-SH trunk weight-gradient backward for Hopper (sm_90a), bf16
// tensor-core products with float32 accumulation.
//
// Replaces: nerf_projects_tpu/ops/pallas/fused_sh_mlp.py::_fused_sh_bwd
// (kernel _bwd_kernel): given the inputs x [n, 63] and the output
// gradients g_rgb [n, num_rgb] and g_sig [n] of fused_sh_fwd, the float32
// gradients of the ten padded weights and ten biases. x gets none, as on
// the TPU. Like the TPU kernel it recomputes the forward; its rounding
// points are _bwd_kernel's: dW = mmT rounds both operands to bf16, the dX
// products (mmBT) round g, the relu masks come from the sign of the
// activation, the bias gradients are float32 sums of the unrounded g.
//
// Bound: per row the recomputed trunk (491,008 multiply-adds), the dX
// products (7 x 65,536 + 256 (num_rgb + 1)) and dW (491,008 + 256 (num_rgb
// + 1)): 1,465,856 at sh_deg 3, ~2.9 MFLOP, against (63 + num_rgb + 1) * 4
// bytes of input a row and 2.2 MB of gradients for the call: bound by
// tensor-core operations.
//
// Design (mlp_tile.cuh's three passes, as K1b): the trunk writes a bf16
// activation stash (x, a0..a7: 4.1 KB a row), a dX pass writes a bf16
// gradient stash (the heads' and dense 0..7's output gradients: 4.3 KB a
// row) and per-block float32 bias sums, and mlp_dw_kernel writes split-K
// partial products that sh_grad_reduce_kernel sums in a fixed order. The
// result is the same bits on every run, with no atomics.

#include "fused_sh_tile.cuh"

namespace sh {

using mlp::GS;
using mlp::WS;

constexpr int DX_SMEM_BYTES = (BM * GS + 2 * 256 * WS) * 2 + (BM + 2 * 256 + G_FEATS) * 4;

// g_rgb [n, num_rgb], g_sig [n] float32 -> the gradient stash G (bf16,
// [G_FEATS][ld]) and, per block, the float32 bias-gradient sums
// db_part[blockIdx.x][G_FEATS].
template <int RN>
__global__ void __launch_bounds__(THREADS, 2)
    sh_dx_kernel(const float* __restrict__ g_rgb, const float* __restrict__ g_sig, long long n,
                 int num_rgb, const bf16* __restrict__ wt, const bf16* __restrict__ A,
                 bf16* __restrict__ G, long long ld, int n_tiles, float* __restrict__ db_part) {
  using mlp::A_TRUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gt = reinterpret_cast<bf16*>(smem_raw);
  bf16* wbuf = gt + BM * GS;
  float* gsig = reinterpret_cast<float*>(wbuf + 2 * 256 * WS);
  float* colsum = gsig + BM;
  float* db_acc = colsum + 2 * 256;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 32, col0 = (warp & 3) * 64;

  for (int i = tid; i < G_FEATS; i += THREADS) db_acc[i] = 0.f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row_base = static_cast<long long>(tile) * BM;
    __syncthreads();
    for (int i = tid; i < BM * RN; i += THREADS) {
      const int r = i / RN, c = i % RN;
      const long long row = row_base + r;
      const float v = (row < n && c < num_rgb) ? g_rgb[row * num_rgb + c] : 0.f;
      gt[r * GS + c] = __float2bfloat16_rn(v);
    }
    for (int r = tid; r < BM; r += THREADS) gsig[r] = row_base + r < n ? g_sig[row_base + r] : 0.f;
    __syncthreads();
    // the heads' bias gradients: float32 sums of the unrounded g, rows in order
    if (tid < num_rgb) {
      float s = 0.f;
      for (int r = 0; r < BM && row_base + r < n; ++r) s += g_rgb[(row_base + r) * num_rgb + tid];
      db_acc[G_RGB + tid] += s;
    } else if (tid == MAX_RGB) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += gsig[r];
      db_acc[G_SIG] += s;
    }
    mlp::stash_cols(gt, GS, 0, RN, G, G_RGB, ld, row_base);
    if (tid < BM) G[static_cast<long long>(G_SIG) * ld + row_base + tid] = __float2bfloat16_rn(gsig[tid]);

    // dense 7: (g_rgb @ wrgb^T + g_sig wsig^T) * (a7 > 0)
    float acc[2][8][4];
    mlp::gemm_tile<256>(gt, GS, 0, wbuf, wt + OFFT_WRGB, RN, acc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = col0 + nt * 8 + 2 * t;
      const float w0 = mlp::bf(wt[OFFT_WSIG + c]), w1 = mlp::bf(wt[OFFT_WSIG + c + 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float gs = mlp::round_bf16(gsig[row0 + mt * 16 + g + 8 * half]);
          acc[mt][nt][2 * half] += gs * w0;
          acc[mt][nt][2 * half + 1] += gs * w1;
        }
    }
    mlp::dx_epilogue(acc, gt, A, A_TRUNK + 7 * 256, ld, row_base, colsum, db_acc, G_TRUNK + 7 * 256);
    mlp::stash_cols(gt, GS, 0, 256, G, G_TRUNK + 7 * 256, ld, row_base);
    // dense l for l = 6..0: (g_{l+1} @ w_{l+1}^T) * (a_l > 0); for l = 4
    // the product takes w5's h rows only (x carries no gradient)
    for (int l = 6; l >= 0; --l) {
      mlp::gemm_tile<256>(gt, GS, 0, wbuf, wt + offt_trunk(l + 1), 256, acc);
      mlp::dx_epilogue(acc, gt, A, A_TRUNK + l * 256, ld, row_base, colsum, db_acc, G_TRUNK + l * 256);
      mlp::stash_cols(gt, GS, 0, 256, G, G_TRUNK + l * 256, ld, row_base);
    }
  }
  __syncthreads();
  for (int i = tid; i < G_FEATS; i += THREADS)
    db_part[static_cast<long long>(blockIdx.x) * G_FEATS + i] = db_acc[i];
}

// dW = A^T G for every weight, in mlp_dw_kernel's table of 11 entries.
inline mlp::DwTable dw_table(int num_rgb) {
  using mlp::A_TRUNK;
  using mlp::A_X;
  constexpr int E = 11;
  static_assert(E <= mlp::DW_ENTRIES, "mlp_dw_kernel's table is too small");
  const mlp::DwEntry e[E] = {
      {A_X, 64, G_TRUNK + 0 * 256, 256, GW0, 256},
      {A_TRUNK + 0 * 256, 256, G_TRUNK + 1 * 256, 256, GW1 + 0 * 65536, 256},
      {A_TRUNK + 1 * 256, 256, G_TRUNK + 2 * 256, 256, GW1 + 1 * 65536, 256},
      {A_TRUNK + 2 * 256, 256, G_TRUNK + 3 * 256, 256, GW1 + 2 * 65536, 256},
      {A_TRUNK + 3 * 256, 256, G_TRUNK + 4 * 256, 256, GW1 + 3 * 65536, 256},
      {A_X, 64, G_TRUNK + 5 * 256, 256, GW5, 256},                         // w5: x rows
      {A_TRUNK + 4 * 256, 256, G_TRUNK + 5 * 256, 256, GW5 + 64 * 256, 256},  // w5: h rows
      {A_TRUNK + 5 * 256, 256, G_TRUNK + 6 * 256, 256, GW6, 256},
      {A_TRUNK + 6 * 256, 256, G_TRUNK + 7 * 256, 256, GW6 + 65536, 256},
      {A_TRUNK + 7 * 256, 256, G_SIG, 1, GWSIG, 128},
      {A_TRUNK + 7 * 256, 256, G_RGB, num_rgb, GWRGB, 128},
  };
  mlp::DwTable tab{};
  int tiles = 0;
  for (int i = 0; i < mlp::DW_ENTRIES; ++i) {
    tab.first_tile[i] = tiles;
    if (i < E) {
      tab.e[i] = e[i];
      tiles += ((e[i].m + mlp::DW_TILE - 1) / mlp::DW_TILE) *
               ((e[i].out_ld + mlp::DW_TILE - 1) / mlp::DW_TILE);
    }
  }
  tab.first_tile[mlp::DW_ENTRIES] = tiles;
  return tab;
}

// Gradient-stash feature whose float32 sum is bias element b (-1: padding).
__device__ __forceinline__ int bias_feature(int b) {
  if (b < 8 * 256) return G_TRUNK + b;
  b -= 8 * 256;
  if (b < 128) return b == 0 ? G_SIG : -1;
  return G_RGB + (b - 128);
}

__global__ void sh_grad_reduce_kernel(const float* __restrict__ part, int splits,
                                      const float* __restrict__ db_part, int db_blocks,
                                      float* __restrict__ grads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= GRAD_ELEMS) return;
  float s = 0.f;
  if (i < GB0) {
    for (int k = 0; k < splits; ++k) s += part[k * mlp::GB0 + i];
  } else {
    const int f = bias_feature(static_cast<int>(i - GB0));
    if (f >= 0)
      for (int b = 0; b < db_blocks; ++b) s += db_part[static_cast<long long>(b) * G_FEATS + f];
  }
  grads[i] = s;
}

struct Workspace {
  bf16* A;         // [A_FEATS][npad]
  bf16* G;         // [G_FEATS][npad]
  float* part;     // [splits][mlp::GB0]
  float* db_part;  // [DX_MAX_BLOCKS][G_FEATS]
};

inline long long workspace_bytes(long long n) {
  using mlp::align256;
  const long long npad = mlp::padded_rows(n);
  return align256(A_FEATS * npad * 2) + align256(G_FEATS * npad * 2) +
         align256(mlp::max_splits(npad) * mlp::GB0 * 4) + align256(mlp::DX_MAX_BLOCKS * G_FEATS * 4LL);
}

inline Workspace carve(void* base, long long n) {
  using mlp::align256;
  const long long npad = mlp::padded_rows(n);
  char* p = static_cast<char*>(base);
  Workspace ws{};
  ws.A = reinterpret_cast<bf16*>(p);
  p += align256(A_FEATS * npad * 2);
  ws.G = reinterpret_cast<bf16*>(p);
  p += align256(G_FEATS * npad * 2);
  ws.part = reinterpret_cast<float*>(p);
  p += align256(mlp::max_splits(npad) * mlp::GB0 * 4);
  ws.db_part = reinterpret_cast<float*>(p);
  return ws;
}

template <int RN>
inline cudaError_t launch_dx(const float* g_rgb, const float* g_sig, long long n, int num_rgb,
                             const bf16* wt, const Workspace& ws, long long npad, int blocks, int n_tiles,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sh_dx_kernel<RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DX_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  sh_dx_kernel<RN><<<blocks, THREADS, DX_SMEM_BYTES, stream>>>(g_rgb, g_sig, n, num_rgb, wt, ws.A, ws.G,
                                                                npad, n_tiles, ws.db_part);
  return cudaGetLastError();
}

}  // namespace sh

extern "C" {

long long fused_sh_bwd_weight_elems() { return sh::N_WEIGHTS; }
long long fused_sh_bwd_weight_t_elems(int num_rgb) { return sh::nt_weights((num_rgb + 31) / 32 * 32); }
long long fused_sh_bwd_grad_elems() { return sh::GRAD_ELEMS; }
long long fused_sh_bwd_workspace_bytes(long long n) { return sh::workspace_bytes(n); }

const char* fused_sh_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, 63], g_rgb [n, num_rgb], g_sig [n] float32; w, wt the bf16
// forward and backward weight buffers; grads [GRAD_ELEMS] float32;
// workspace of fused_sh_bwd_workspace_bytes(n) bytes, 256-byte aligned.
// Launched on `stream`; returns the first CUDA error, 0 on success.
int fused_sh_bwd(const void* x, const void* g_rgb, const void* g_sig, const void* w, const void* wt,
                 void* grads, long long n, int num_rgb, void* workspace, void* stream) {
  if (n <= 0 || num_rgb < 1 || num_rgb > sh::MAX_RGB) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sh::Workspace ws = sh::carve(workspace, n);
  const long long npad = mlp::padded_rows(n);
  const long long n_tiles = npad / sh::BM;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const sh::bf16* wb = static_cast<const sh::bf16*>(w);
  const sh::bf16* wtb = static_cast<const sh::bf16*>(wt);
  const float* gr = static_cast<const float*>(g_rgb);
  const float* gs = static_cast<const float*>(g_sig);

  // pass 1: the trunk, writing the activation stash
  cudaError_t err = sh::launch_forward(static_cast<const float*>(x), wb, n, ws.A, npad, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // pass 2: the gradient down the layers
  const int dx_blocks = n_tiles < mlp::DX_MAX_BLOCKS ? static_cast<int>(n_tiles) : mlp::DX_MAX_BLOCKS;
  const int nt = static_cast<int>(n_tiles);
  switch ((num_rgb + 31) / 32) {
    case 1: err = sh::launch_dx<32>(gr, gs, n, num_rgb, wtb, ws, npad, dx_blocks, nt, s); break;
    case 2: err = sh::launch_dx<64>(gr, gs, n, num_rgb, wtb, ws, npad, dx_blocks, nt, s); break;
    case 3: err = sh::launch_dx<96>(gr, gs, n, num_rgb, wtb, ws, npad, dx_blocks, nt, s); break;
    default: err = sh::launch_dx<128>(gr, gs, n, num_rgb, wtb, ws, npad, dx_blocks, nt, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // pass 3: dW split over rows, then the fixed-order sums
  const int splits_max = mlp::max_splits(npad);
  const long long rows_per_split = ((npad + splits_max - 1) / splits_max + sh::BM - 1) / sh::BM * sh::BM;
  const int splits = static_cast<int>((npad + rows_per_split - 1) / rows_per_split);
  const mlp::DwTable tab = sh::dw_table(num_rgb);
  err = cudaFuncSetAttribute(mlp::mlp_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mlp::DW_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp::mlp_dw_kernel<<<dim3(tab.first_tile[mlp::DW_ENTRIES], splits), sh::THREADS, mlp::DW_SMEM_BYTES, s>>>(
      ws.A, ws.G, npad, rows_per_split, ws.part, tab);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sh::sh_grad_reduce_kernel<<<static_cast<unsigned>((sh::GRAD_ELEMS + 255) / 256), 256, 0, s>>>(
      ws.part, splits, ws.db_part, dx_blocks, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
