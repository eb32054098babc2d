// Hopper (sm_90a) core of the fused NeRF and NeRF-SH MLPs: warpgroup
// matrix products (wgmma) fed by bulk copies into a ring of shared-memory
// stages. Every MLP kernel runs on it: the fused train level
// (fused_train.cu, K2), the encoded forward and weight-gradient backward
// (fused_mlp_fwd.cu, fused_mlp_bwd.cu: K1f, K1b), the raw-points forward
// and backward (fused_mlp_raw_fwd.cu, fused_mlp_raw_bwd.cu: K1rf, K1rb),
// and the NeRF-SH trunk's forward and backward (fused_sh_fwd.cu,
// fused_sh_bwd.cu: K5f, K5b), whose trunk is the same eight layers under
// another head. mlp_tile.cuh holds the stash feature maps, gradient
// layouts, encoder (encode_col) and fixed-order reduce it shares.
//
// What bounds the MLP on this card is tensor-core throughput: 593,408
// multiply-adds a row against 24-416 bytes of input; for the backward
// (K2, K1rb), also its stash bytes (~9.5 GB a training step). The first
// port's tile of warp-level products reached 0.13-0.21 of the operations
// bound: each 64-row block streamed all 1.2 MB of weights from L2 through a 32-deep
// slice behind two block barriers, loaded every fragment one 32-bit word
// at a time, and wrote its stashes with scattered stores. Here:
//   - a block holds two warpgroups of 64 rows (128 rows); each weight slab,
//     copied once into shared memory, feeds both: half the L2 weight
//     traffic a row. A persistent grid walks the 128-row tiles;
//   - weights are packed ahead of time (ops/kernels/fused_mlp.py::
//     kernel_weights_sm90 / kernel_weights_sm90_bwd) into 64-deep K-slabs
//     of wgmma's K-major core matrices (8x8, 128 bytes, no swizzle), each
//     layer in passes of at most 128 rows of N, so one cp.async.bulk stages
//     a slab; a ring of stages with one mbarrier each keeps the next slabs
//     in flight, and the last warp to release a stage issues its refill (no
//     block barrier). The weights are read under an evict_last L2 policy,
//     the stashes written under evict_first: without it K2's stash stream
//     pushes the weights out of L2, and its forward reads them again from
//     device memory;
//   - a layer's float32 accumulator, biased, relu'd (or masked) and rounded
//     to bf16, is the next layer's A fragment (A from registers, B from
//     shared memory); a 256-wide layer runs as two passes of 128 columns;
//   - the backward's stashes are [64-row tile][feature / 8][row][8
//     features] bf16: its forward and dX stage each layer's output in
//     shared memory in that layout and store it with one bulk copy; the dX
//     pass's relu mask loads are whole 128-byte lines; dW reads a 64-row
//     slab of 8 features as one 1 KB block in wgmma's MN-major layout and
//     runs dW = A^T G with both operands from shared memory.
// Every product takes bf16 operands and accumulates in float32, with the
// reference's rounding points; only the order of the sums over K differs.
// The backward's forward (K2, K1b, K1rb, K5b) and dW add each 64-deep
// slab's products into float32 registers (PROMOTE, mma_layer): the
// float64-sums rule needs it.
// The bias gradients are float32 sums in a fixed order, and dW goes
// through split-K partials and a fixed-order reduce: the same bits on
// every run.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include "mlp_tile.cuh"

namespace sm90 {

using mlp::bf16;

// ---------------------------------------------------------------------------
// Primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory operand descriptor without swizzle: lbo is the stride
// between core matrices along K, sbo along M or N, for the K-major form
// (rows of K contiguous in 16-byte pieces) and the MN-major one (8 M or N
// values contiguous per K row) alike (cute's canonical GMMA layouts; both
// forms held against products on the card).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// L2 policies: the weights, read by every block, stay (evict_last); the
// stashes, written once and read once, stream through (evict_first).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// bytes (a multiple of 16) from global src to shared dst; completes on bar.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same under L2 policy pol.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// Shared to global, bytes (a multiple of 16), in this thread's bulk group,
// streaming through L2.
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes), "l"(l2_evict_first())
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory, visible to a later bulk copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the calling warpgroup's 128 threads (ids 1 and 2).
__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The A operand of one m64k16 step as this thread holds it: rows g and
// g + 8 of its warp's 16, columns 2t, 2t + 1 (r[0], r[1]) and 2t + 8,
// 2t + 9 (r[2], r[3]), low half the lower column.
struct Frag {
  uint32_t r[4];
};

// wgmma m64nNk16, bf16 operands, float32 accumulators d (N / 2 a thread:
// d[4j + 2h + e] is row g + 8h, column 8j + 2t + e). rs: A from
// registers, B K-major from shared memory; ss_t: A and B MN-major from
// shared memory. The products accumulate into d (scale-d 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The NeRF-SH coefficient head's widths (32, 64, 96 columns; 128 is above).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t_n8(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// Layouts
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;       // two consumer warpgroups
constexpr int BLOCK_ROWS = 128;    // 64 rows a warpgroup
constexpr int ARRIVALS = THREADS / 32;  // warps that release a stage
constexpr int NP_MAX = 128;               // columns of a layer's pass: N 256 runs as two
constexpr int SLAB_BYTES = NP_MAX * 64 * 2;  // the largest weight slab: N 128 x 64-deep K

// Forward weight buffer (ops/kernels/fused_mlp.py::SM90_LAYOUT): each
// layer's [N][K] matrix (nn.Linear's [out][in], the inputs padded as in
// KERNEL_LAYOUT; the heads' N padded to 8) in passes of at most 128 rows of
// N, each pass [128][K] as K-slabs of depth KD (the last may be
// shallower), each slab [KD / 8][128 / 8][8 n][8 k]; then the biases.
constexpr long long SW_W0 = 0;                         // [256][64]
constexpr long long SW_W1 = SW_W0 + 256 * 64;          // w1..w4, [256][256] each
constexpr long long SW_W5 = SW_W1 + 4 * 256 * 256;     // [256][320]: [x | h4]
constexpr long long SW_W6 = SW_W5 + 256 * 320;         // w6, w7
constexpr long long SW_WSIG = SW_W6 + 2 * 256 * 256;   // [8][256]
constexpr long long SW_WB = SW_WSIG + 8 * 256;         // [256][256]
constexpr long long SW_WV = SW_WB + 256 * 256;         // [128][288]: [bottleneck | v]
constexpr long long SW_WRGB = SW_WV + 128 * 288;       // [8][128]
constexpr long long SW_B = SW_WRGB + 8 * 128;          // b0..b7, [256] each
constexpr long long SW_BB = SW_B + 8 * 256;            // [256]
constexpr long long SW_BV = SW_BB + 256;               // [128]
constexpr long long SW_BSIG = SW_BV + 128;             // [8]
constexpr long long SW_BRGB = SW_BSIG + 8;             // [8]
constexpr long long SW_WEIGHTS = SW_BRGB + 8;

// NeRF-SH forward buffer (ops/kernels/fused_sh_mlp.py::SM90_LAYOUT): the
// same trunk (dense 0..7 at SW_W0..SW_W6 + 65536, dense 5's input columns
// permuted to [x | h4]) and sigma head (dense 8, row 0 live), then the
// coefficient head (dense 9) as [128][256], rows past num_rgb zero, and
// the biases.
constexpr int SH_MAX_RGB = 128;
constexpr long long SH_WRGB = SW_WSIG + 8 * 256;       // [128][256]
constexpr long long SH_B = SH_WRGB + 128 * 256;        // b0..b7, [256] each
constexpr long long SH_BSIG = SH_B + 8 * 256;          // [8], entry 0 live
constexpr long long SH_BRGB = SH_BSIG + 8;             // [128]
constexpr long long SH_WEIGHTS = SH_BRGB + 128;

// dX weight buffer (SM90_LAYOUT_BWD): the [N = in][K = out] matrices of the
// dX products, slabbed the same way.
constexpr long long SWT_WRGB = 0;                      // [128][16]: rgb head^T, K 3 live
constexpr long long SWT_WV = SWT_WRGB + 128 * 16;      // [256][128]: view_0's bottleneck rows^T
constexpr long long SWT_WB = SWT_WV + 256 * 128;       // [256][272]: [bottleneck^T | sigma head^T]
constexpr long long SWT_W7 = SWT_WB + 256 * 272;       // w7, w6, w5 (h rows), w4, w3, w2, w1 ^T
constexpr long long SWT_WEIGHTS = SWT_W7 + 7 * 256 * 256;
__host__ __device__ constexpr long long swt_trunk(int l) { return SWT_W7 + (7 - l) * 256 * 256; }

// NeRF-SH dX weight buffer (ops/kernels/fused_sh_mlp.py::SM90_LAYOUT_BWD):
// the heads' [N = 256][K = 144] matrix [coefficient head^T (128 columns,
// those past num_rgb zero) | sigma head^T (16, the first live)], then w7,
// w6, w5 (h rows), w4, w3, w2, w1 ^T, slabbed the same way.
constexpr long long SWT_SH_HEADS = 0;
constexpr long long SWT_SH_W7 = SWT_SH_HEADS + 256 * 144;
constexpr long long SWT_SH_WEIGHTS = SWT_SH_W7 + 7 * 256 * 256;
static_assert(sh::MAX_RGB + 16 == 144, "the heads' product is 144 deep");

// Stashes: [npad / 64 tiles][features / 8][64 rows][8] bf16, features as
// mlp_tile.cuh's maps: mlp's A_* and G_*, or, for the NeRF-SH trunk (K5b),
// sh's (x and a0..a7; the heads' and dense 0..7's output gradients).
__host__ __device__ constexpr int a_feats(bool k5) { return k5 ? sh::A_FEATS : mlp::A_FEATS; }
__host__ __device__ constexpr int g_feats(bool k5) { return k5 ? sh::G_FEATS : mlp::G_FEATS; }
struct Feats {
  int a, g;  // activation and gradient features a row
};
constexpr Feats K1_FEATS{a_feats(false), g_feats(false)};
constexpr Feats K5_FEATS{a_feats(true), g_feats(true)};
static_assert(mlp::A_FEATS % 8 == 0 && mlp::G_FEATS % 8 == 0 && sh::A_FEATS % 8 == 0 && sh::G_FEATS % 8 == 0,
              "stash features come in groups of 8");

struct Layer {
  long long off;
  int n, k, kd;
};

// The NeRF forward's layers; the first TRUNK_LAYERS (dense 0..7) are the
// NeRF-SH forward's too, whose head layers follow them in SH_HEAD_LAYERS.
constexpr int TRUNK_LAYERS = 8;
constexpr Layer FWD_LAYERS[] = {
    {SW_W0, 256, 64, 64},
    {SW_W1 + 0 * 65536, 256, 256, 64}, {SW_W1 + 1 * 65536, 256, 256, 64},
    {SW_W1 + 2 * 65536, 256, 256, 64}, {SW_W1 + 3 * 65536, 256, 256, 64},
    {SW_W5, 256, 320, 64},
    {SW_W6, 256, 256, 64}, {SW_W6 + 65536, 256, 256, 64},
    {SW_WSIG, 8, 256, 256},
    {SW_WB, 256, 256, 64},
    {SW_WV, 128, 288, 64},
    {SW_WRGB, 8, 128, 128},
};
constexpr Layer SH_HEAD_LAYERS[] = {
    {SW_WSIG, 8, 256, 256},
    {SH_WRGB, 128, 256, 64},
};
constexpr Layer DX_LAYERS[] = {
    {SWT_WRGB, 128, 16, 16},
    {SWT_WV, 256, 128, 64},
    {SWT_WB, 256, 272, 64},
    {swt_trunk(7), 256, 256, 64}, {swt_trunk(6), 256, 256, 64}, {swt_trunk(5), 256, 256, 64},
    {swt_trunk(4), 256, 256, 64}, {swt_trunk(3), 256, 256, 64}, {swt_trunk(2), 256, 256, 64},
    {swt_trunk(1), 256, 256, 64},
};
constexpr Layer SH_DX_LAYERS[] = {
    {SWT_SH_HEADS, 256, 144, 64},
    {SWT_SH_W7 + 0 * 65536, 256, 256, 64}, {SWT_SH_W7 + 1 * 65536, 256, 256, 64},
    {SWT_SH_W7 + 2 * 65536, 256, 256, 64}, {SWT_SH_W7 + 3 * 65536, 256, 256, 64},
    {SWT_SH_W7 + 4 * 65536, 256, 256, 64}, {SWT_SH_W7 + 5 * 65536, 256, 256, 64},
    {SWT_SH_W7 + 6 * 65536, 256, 256, 64},
};

constexpr int count_slabs(const Layer* l, int nl) {
  int s = 0;
  for (int i = 0; i < nl; ++i) s += (l[i].n > NP_MAX ? l[i].n / NP_MAX : 1) * ((l[i].k + l[i].kd - 1) / l[i].kd);
  return s;
}
constexpr int FWD_SLABS = count_slabs(FWD_LAYERS, sizeof(FWD_LAYERS) / sizeof(Layer));
constexpr int DX_SLABS = count_slabs(DX_LAYERS, sizeof(DX_LAYERS) / sizeof(Layer));
constexpr int TRUNK_SLABS = count_slabs(FWD_LAYERS, TRUNK_LAYERS);  // K5b's forward: the trunk alone
constexpr int SH_SLABS = TRUNK_SLABS + count_slabs(SH_HEAD_LAYERS, 2);
constexpr int SH_DX_SLABS = count_slabs(SH_DX_LAYERS, sizeof(SH_DX_LAYERS) / sizeof(Layer));
constexpr int SLAB_TABLES[] = {FWD_SLABS, DX_SLABS, TRUNK_SLABS, SH_SLABS, SH_DX_SLABS};
constexpr bool distinct(const int* v, int n) {
  for (int i = 0; i < n; ++i)
    for (int k = i + 1; k < n; ++k)
      if (v[i] == v[k]) return false;
  return true;
}
static_assert(distinct(SLAB_TABLES, 5), "the rings tell their tables apart by length");

template <int NS>
struct SlabTable {
  long long off[NS];  // bf16 elements into the weight buffer
  int bytes[NS];
};

// The slabs of layers a[0..na) and then b[0..nb), in the order a kernel
// consumes them.
template <int NS>
constexpr SlabTable<NS> make_slabs(const Layer* a, int na, const Layer* b = nullptr, int nb = 0) {
  SlabTable<NS> t{};
  int j = 0;
  for (int i = 0; i < na + nb; ++i) {
    const Layer& l = i < na ? a[i] : b[i - na];
    const int np = l.n < NP_MAX ? l.n : NP_MAX;
    for (int p = 0; p < l.n / np; ++p)
      for (int k0 = 0; k0 < l.k; k0 += l.kd) {
        const int kd = l.k - k0 < l.kd ? l.k - k0 : l.kd;
        t.off[j] = l.off + static_cast<long long>(np) * (p * l.k + k0);
        t.bytes[j] = np * kd * 2;
        ++j;
      }
  }
  return t;
}

static __constant__ SlabTable<FWD_SLABS> kFwdSlabs = make_slabs<FWD_SLABS>(FWD_LAYERS, sizeof(FWD_LAYERS) / sizeof(Layer));
static __constant__ SlabTable<DX_SLABS> kDxSlabs = make_slabs<DX_SLABS>(DX_LAYERS, sizeof(DX_LAYERS) / sizeof(Layer));
static __constant__ SlabTable<TRUNK_SLABS> kTrunkSlabs = make_slabs<TRUNK_SLABS>(FWD_LAYERS, TRUNK_LAYERS);
static __constant__ SlabTable<SH_SLABS> kShSlabs = make_slabs<SH_SLABS>(FWD_LAYERS, TRUNK_LAYERS, SH_HEAD_LAYERS, 2);
static __constant__ SlabTable<SH_DX_SLABS> kShDxSlabs =
    make_slabs<SH_DX_SLABS>(SH_DX_LAYERS, sizeof(SH_DX_LAYERS) / sizeof(Layer));

// ---------------------------------------------------------------------------
// The weight ring: slab j of a block's stream sits in stage j % STAGES; its
// full barrier completes when its bytes land, and the last of the block's
// warps to release it issues slab j + STAGES into the same stage.
// ---------------------------------------------------------------------------

template <int STAGES, int NS>
struct WeightRing {
  unsigned char* buf;      // [STAGES][SLAB_BYTES]
  uint64_t* full;          // [STAGES]
  int* released;           // [STAGES] warps done with the stage's slab
  const bf16* w;
  int total;               // slabs the block consumes

  __device__ __forceinline__ void issue(int j) const {
    if (j >= total) return;
    const int st = j % STAGES, e = j % NS;
    const SlabTable<NS>& tab = table();
    mbar_expect_tx(&full[st], tab.bytes[e]);
    bulk_g2s(buf + st * SLAB_BYTES, w + tab.off[e], tab.bytes[e], &full[st], l2_evict_last());
  }
  static __device__ __forceinline__ const SlabTable<NS>& table() {
    if constexpr (NS == FWD_SLABS) {
      return kFwdSlabs;
    } else if constexpr (NS == DX_SLABS) {
      return kDxSlabs;
    } else if constexpr (NS == TRUNK_SLABS) {
      return kTrunkSlabs;
    } else if constexpr (NS == SH_SLABS) {
      return kShSlabs;
    } else {
      static_assert(NS == SH_DX_SLABS, "a ring over a table of its own length");
      return kShDxSlabs;
    }
  }
  // One thread, after the barriers are initialised and visible.
  __device__ __forceinline__ void prologue() const {
    for (int j = 0; j < STAGES; ++j) issue(j);
  }
  __device__ __forceinline__ uint32_t acquire(int j) const {
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    return smem_u32(buf + (j % STAGES) * SLAB_BYTES);
  }
  // The calling warp is done with slab j (its wgmmas have completed).
  __device__ __forceinline__ void release(int j) const {
    if ((threadIdx.x & 31) == 0) {
      const int st = j % STAGES;
      if (atomicAdd(&released[st], 1) == ARRIVALS - 1) {
        released[st] = 0;
        issue(j + STAGES);
      }
    }
    __syncwarp();
  }
};

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, int* released) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
}

template <int N>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128(d, a, b); }
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) { wgmma_ss_t_n128(d, a, b); }
};
template <>
struct Mma<96> {
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n96(d, a, b); }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b); }
};
template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n32(d, a, b); }
};
template <>
struct Mma<8> {
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n8(d, a, b); }
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t a, uint64_t b) { wgmma_ss_t_n8(d, a, b); }
};

// A [64 x K] (fragments af(kb), kb < K / 16) x B^T, B the layer's [N][K]
// matrix as the ring's next slabs (K-major), from slab j, in passes of NP =
// min(N, 128) columns: epi(acc, p) takes pass p's float32 accumulators.
// The fragments of a slab are gathered before its wgmma.fence (a register
// written under in-flight wgmmas makes ptxas serialise them). Without
// PROMOTE one slab's products stay in flight while the next is issued. With
// PROMOTE each slab's products go to a fresh accumulator, added into acc in
// float32 once they land: the tensor cores' float32 sums of a 256-deep chain
// stray further from exact sums than cuBLAS's float32 ones, a 64-deep
// chain's hardly (warpgroup and warp-level products alike). Taking the
// partials 64 columns at a time (32 registers fewer) cut the forward's
// spill but ran slower on the card (PERF.md). SR: the rows of N the staged
// slabs hold, of which the product reads the first NP (the NeRF-SH
// coefficient head: RN of 128).
template <int N, int K, int KD, bool PROMOTE, int SR = (N < NP_MAX ? N : NP_MAX), class Ring, class AF, class EPI>
__device__ __forceinline__ void mma_layer(AF af, EPI epi, const Ring& ring, int& j) {
  constexpr int NP = N < NP_MAX ? N : NP_MAX;
  constexpr int NSL = (K + KD - 1) / KD;
  constexpr int KB = KD / 16;
#pragma unroll
  for (int p = 0; p < N / NP; ++p) {
    float acc[NP / 2], part[PROMOTE ? NP / 2 : 1];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      Frag fr[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        if (s * KD + kk * 16 < K) fr[kk] = af(s * KB + kk);
      const uint32_t base = ring.acquire(j);
      if constexpr (PROMOTE) {
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) part[i] = 0.f;
        fence_regs(part);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (s * KD + kk * 16 < K) Mma<NP>::rs(part, fr[kk].r, make_desc(base + kk * (2 * SR * 16), SR * 16, 128));
        wg_commit();
        wg_wait<0>();
        fence_regs(part);
        ring.release(j);
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
      } else {
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (s * KD + kk * 16 < K) Mma<NP>::rs(acc, fr[kk].r, make_desc(base + kk * (2 * SR * 16), SR * 16, 128));
        wg_commit();
        if (s > 0) {
          wg_wait<1>();
          ring.release(j - 1);
        }
      }
      ++j;
    }
    if constexpr (!PROMOTE) {
      wg_wait<0>();
      ring.release(j - 1);
      fence_regs(acc);
    }
    epi(acc, p);
  }
}

// Fragment q = 2 jb + h of a layer's output (n8 block jb, row half h).
template <int Q>
__device__ __forceinline__ Frag frag_of(const uint32_t (&a)[Q], int kb) {
  return Frag{{a[4 * kb], a[4 * kb + 1], a[4 * kb + 2], a[4 * kb + 3]}};
}

// Thread coordinates in a consumer warpgroup.
struct Lane {
  int wg, warp, lane, g, t, ra;  // ra: the thread's first row in the 64-row tile (16 warp + g)
  __device__ __forceinline__ Lane() {
    wg = threadIdx.x >> 7;
    warp = (threadIdx.x >> 5) & 3;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    ra = 16 * warp + g;
  }
};

// The thread's u32 slot in a stash of f8 feature groups: tile64, group fg,
// tile row r, pair t (features 8 fg + 2t, + 1).
__device__ __forceinline__ long long slot(long long tile64, int f8, int fg, int r, int t) {
  return ((tile64 * f8 + fg) * 64 + r) * 4 + t;
}

// A warpgroup's staging block: a layer's output fragments, bf16 pairs in
// the stash layout (32 feature groups x 64 rows x 4 pairs = 32 KB; each
// thread's own slots), stored to a stash by one bulk copy and read back by
// the same threads as the next layer's fragments.
struct Staging {
  uint32_t* buf;
  int base;  // the thread's first slot: ra * 4 + t
  // Slot of fragment q = 32 p + 2 jb + h (pass p, n8 block jb, row half h).
  __device__ __forceinline__ uint32_t& at(int q) const {
    return buf[base + (q >> 5) * 4096 + ((q & 31) >> 1) * 256 + (q & 1) * 32];
  }
  // Before a layer's fragments are written: the last bulk store has read
  // the block, and every thread has read what it needs of it.
  __device__ __forceinline__ void begin() const {
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
    wg_bar();
  }
  // After they are written: one bulk copy of the first bytes to dst.
  __device__ __forceinline__ void store(void* dst, int bytes) const {
    wg_bar();
    if ((threadIdx.x & 127) == 0) {
      fence_proxy_async();
      bulk_s2g(dst, buf, bytes);
    }
  }
};


// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int XV_KB = 6;  // input fragments a thread keeps in shared memory: x k-blocks 0..3, v 4..5
constexpr int STAGING_BYTES = 32 * 64 * 4 * 4;  // a warpgroup's staging block
__host__ __device__ constexpr int fwd_stages(bool staged) { return staged ? 8 : 12; }
__host__ __device__ constexpr int fwd_smem(bool staged) {
  return fwd_stages(staged) * SLAB_BYTES + 2 * XV_KB * 128 * 16 + (staged ? 2 * STAGING_BYTES : 0) +
         fwd_stages(staged) * 16;
}

// bias, relu (RELU), round to bf16: fragment q0 + 2 jb + h (n8 block jb,
// row half h) of the next layer, handed to put(q, bf16 pair).
template <bool RELU, int NB, class PUT>
__device__ __forceinline__ void epi_act(const float (&acc)[4 * NB], PUT put, int q0, const bf16* bias,
                                        const Lane& L) {
#pragma unroll
  for (int jb = 0; jb < NB; ++jb) {
    const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + 8 * jb + 2 * L.t));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * jb + 2 * h] + b.x, v1 = acc[4 * jb + 2 * h + 1] + b.y;
      if (RELU) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      put(q0 + 2 * jb + h, pack_bf16(v0, v1));
    }
  }
}

// A head's four live columns (t < 2 holds them) plus its bias, to out
// columns col..col + 3 of the thread's rows below n.
__device__ __forceinline__ void head_out(const float (&acc)[4], const bf16* bias, float* out, int col,
                                         long long row_a, long long n, const Lane& L) {
  if (L.t >= 2) return;
  const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + 2 * L.t));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row_a + 8 * h;
    if (row < n)
      *reinterpret_cast<float2*>(out + row * 8 + col + 2 * L.t) =
          make_float2(acc[2 * h] + b.x, acc[2 * h + 1] + b.y);
  }
}

// The NeRF-SH sigma head: column 0 of its n8 product (t = 0 holds it) plus
// its bias, to sig [n] at the thread's rows below n.
__device__ __forceinline__ void sigma_out(const float (&acc)[4], const bf16* bias, float* sig, long long row_a,
                                          long long n, const Lane& L) {
  if (L.t != 0) return;
  const float b = __bfloat162float(bias[0]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (row_a + 8 * h < n) sig[row_a + 8 * h] = acc[2 * h] + b;
}

// The NeRF-SH coefficient head: columns c < num_rgb of its RN-column
// product plus their biases, to rgb [n, num_rgb] at the thread's rows below
// n. Rows of num_rgb floats start at any 4-byte offset: scalar stores.
template <int RN>
__device__ __forceinline__ void coef_out(const float (&acc)[RN / 2], const bf16* bias, float* rgb, int num_rgb,
                                         long long row_a, long long n, const Lane& L) {
#pragma unroll
  for (int jb = 0; jb < RN / 8; ++jb) {
    const int c = 8 * jb + 2 * L.t;
    const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + c));
    const bool live[2] = {c < num_rgb, c + 1 < num_rgb};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row_a + 8 * h;
      if (row >= n) continue;
      if (live[0]) rgb[row * num_rgb + c] = acc[4 * jb + 2 * h] + b.x;
      if (live[1]) rgb[row * num_rgb + c + 1] = acc[4 * jb + 2 * h + 1] + b.y;
    }
  }
}

// The forward's inputs. IN_ENCODED: x [n, 64], v [n, 32] per row (K1f, K1b).
// IN_TRAIN_RAW: x [n, 8] raw points, v = vt [T, 8, 8] raw directions of ray
// row / S at [ray / R][ray % R] (K2; per row at S = 1, R = 8: K1rf, K1rb).
// IN_TRAIN_ENC: x [n, 64], v = vt [T, 8, 32] (K2). IN_SH: x [n, 63] (its
// rows 252 bytes apart, so read a float at a time; column 63 zero), no v,
// and the NeRF-SH head (K5f).
enum InMode { IN_ENCODED = 0, IN_TRAIN_RAW = 1, IN_TRAIN_ENC = 2, IN_SH = 3 };

// Feature groups a row of the activation stash the forward writes: the
// NeRF-SH trunk's (K5b) holds sh's features, the others mlp's.
__host__ __device__ constexpr int a_f8(int mode) { return a_feats(mode == IN_SH) / 8; }

// The thread's input fragments, rounded to bf16, into xv[kb][thread]
// (x k-blocks 0..3, v 4..5; IN_SH: x only) and, with stash, the A_X and
// A_V stash. Rows past n are zeros, so every row of a stashed tile is
// written and finite.
template <int MODE>
__device__ __forceinline__ void load_inputs(const float* x, const float* v, long long n, int S, int R,
                                            long long tile64, uint4* xv, uint32_t* stash, const Lane& L) {
  const int wtid = threadIdx.x & 127;
  float p[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const float* vrow[2] = {nullptr, nullptr};
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = tile64 * 64 + L.ra + 8 * h;
    live[h] = row < n;
    if (!live[h]) continue;
    if (MODE == IN_TRAIN_RAW) {
#pragma unroll
      for (int d = 0; d < 3; ++d) p[h][d] = x[row * 8 + d];
    }
    if (MODE == IN_ENCODED) {
      vrow[h] = v + row * 32;
    } else if (MODE != IN_SH) {
      const long long ray = row / S;
      vrow[h] = v + ((ray / R) * 8 + ray % R) * (MODE == IN_TRAIN_RAW ? 8 : 32);
    }
  }
#pragma unroll
  for (int kb = 0; kb < (MODE == IN_SH ? 4 : XV_KB); ++kb) {
    uint32_t r4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1;
      const int c = 16 * (kb < 4 ? kb : kb - 4) + 8 * (i >> 1) + 2 * L.t;
      const long long row = tile64 * 64 + L.ra + 8 * h;
      float v0 = 0.f, v1 = 0.f;
      if (live[h]) {
        if (kb < 4) {
          if (MODE == IN_TRAIN_RAW) {
            v0 = mlp::encode_col(p[h], c, 10);
            v1 = mlp::encode_col(p[h], c + 1, 10);
          } else if (MODE == IN_SH) {
            v0 = x[row * 63 + c];
            v1 = c + 1 < 63 ? x[row * 63 + c + 1] : 0.f;
          } else {
            const float2 xx = *reinterpret_cast<const float2*>(x + row * 64 + c);
            v0 = xx.x;
            v1 = xx.y;
          }
        } else if (MODE == IN_ENCODED) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow[h] + c);
          v0 = vv.x;
          v1 = vv.y;
        } else if (MODE == IN_TRAIN_RAW) {
          v0 = c < 27 ? mlp::encode_col(vrow[h], c, 4) : 0.f;
          v1 = c + 1 < 27 ? mlp::encode_col(vrow[h], c + 1, 4) : 0.f;
        } else {
          v0 = c < 27 ? vrow[h][c] : 0.f;
          v1 = c + 1 < 27 ? vrow[h][c + 1] : 0.f;
        }
      }
      r4[i] = pack_bf16(v0, v1);
      if (stash) {
        const int fg = (kb < 4 ? mlp::A_X / 8 + 2 * kb : mlp::A_V / 8 + 2 * (kb - 4)) + (i >> 1);
        stash[slot(tile64, a_f8(MODE), fg, L.ra + 8 * h, L.t)] = r4[i];
      }
    }
    xv[kb * 128 + wtid] = make_uint4(r4[0], r4[1], r4[2], r4[3]);
  }
}

// The forward of a warpgroup's 64-row tile. The NeRF head: out [n, 8]
// float32 (columns 0..3 the rgb head, 4..7 the sigma head) and, with stash,
// every activation the backward reads (x, a0..a7, bottleneck, v, hv).
// IN_SH, the NeRF-SH head over the same trunk: out = rgb [n, num_rgb] and
// sig [n]. STAGED (a backward's forward): each layer's output goes through
// the warpgroup's staging block, which a bulk copy stores to the activation
// stash; otherwise it stays in registers. IN_SH and STAGED (K5b) stops at
// the trunk: its dW reads x and a0..a7 only.
template <int MODE, bool PROMOTE, bool STAGED, class Ring>
__device__ __forceinline__ void forward_tile(const float* x, const float* v, const bf16* w, float* out, float* sig,
                                             long long n, int num_rgb, uint32_t* stash, int S, int R,
                                             long long tile64, uint4* xv, const Staging& stg, const Ring& ring,
                                             int& j) {
  constexpr bool SH = MODE == IN_SH;
  const int B = SH ? SH_B : SW_B;  // the trunk's biases
  const Lane L;
  const int wtid = threadIdx.x & 127;
  load_inputs<MODE>(x, v, n, S, R, tile64, xv, stash, L);
  auto xf = [&](int kb) {
    const uint4 u = xv[kb * 128 + wtid];
    return Frag{{u.x, u.y, u.z, u.w}};
  };
  const long long row_a = tile64 * 64 + L.ra;

  uint32_t a[64], an[STAGED ? 1 : 64];
  auto put = [&](int q, uint32_t val) {
    if constexpr (STAGED) {
      stg.at(q) = val;
    } else {
      an[q] = val;
    }
  };
  // a layer's epilogue: bias, relu (RELU), into the staging block or an
  auto act = [&](int bias, auto relu) {
    return [&, bias](float (&acc)[64], int p) {
      if (STAGED && p == 0) stg.begin();
      epi_act<decltype(relu)::value, 16>(acc, put, 32 * p, w + bias + 128 * p, L);
    };
  };
  // after it: the block to the stash at feature feat, then the fragments
  // into the next layer's A (count of them)
  auto next = [&](uint32_t (&dst)[64], int feat, int count) {
    if constexpr (STAGED) {
      stg.store(stash + slot(tile64, a_f8(MODE), feat / 8, 0, 0), count * 512);
#pragma unroll
      for (int q = 0; q < 64; ++q)
        if (q < count) dst[q] = stg.at(q);
    } else {
#pragma unroll
      for (int q = 0; q < 64; ++q)
        if (q < count) dst[q] = an[q];
    }
  };
  using Relu = std::true_type;
  using Linear = std::false_type;
  auto fa = [&](int kb) { return frag_of(a, kb); };
  mma_layer<256, 64, 64, PROMOTE>(xf, act(B, Relu{}), ring, j);
  next(a, mlp::A_TRUNK, 64);
#pragma unroll 1
  for (int l = 1; l <= 4; ++l) {
    mma_layer<256, 256, 64, PROMOTE>(fa, act(B + l * 256, Relu{}), ring, j);
    next(a, mlp::A_TRUNK + l * 256, 64);
  }
  // trunk_5 reads [x | h4]
  mma_layer<256, 320, 64, PROMOTE>([&](int kb) { return kb < 4 ? xf(kb) : frag_of(a, kb - 4); },
                                   act(B + 5 * 256, Relu{}), ring, j);
  next(a, mlp::A_TRUNK + 5 * 256, 64);
#pragma unroll 1
  for (int l = 6; l <= 7; ++l) {
    mma_layer<256, 256, 64, PROMOTE>(fa, act(B + l * 256, Relu{}), ring, j);
    next(a, mlp::A_TRUNK + l * 256, 64);
  }
  if constexpr (SH && !STAGED) {
    mma_layer<8, 256, 256, PROMOTE>(
        fa, [&](float (&acc)[4], int) { sigma_out(acc, w + SH_BSIG, sig, row_a, n, L); }, ring, j);
    // the coefficient head over RN = num_rgb rounded up to 32 columns of
    // its 128-row slabs: one product a width, each a whole wgmma pipeline
    auto coef = [&](auto rn) {
      constexpr int RN = decltype(rn)::value;
      mma_layer<RN, 256, 64, PROMOTE, NP_MAX>(
          fa, [&](float (&acc)[RN / 2], int) { coef_out<RN>(acc, w + SH_BRGB, out, num_rgb, row_a, n, L); }, ring,
          j);
    };
    switch ((num_rgb + 31) / 32) {
      case 1: coef(std::integral_constant<int, 32>{}); break;
      case 2: coef(std::integral_constant<int, 64>{}); break;
      case 3: coef(std::integral_constant<int, 96>{}); break;
      default: coef(std::integral_constant<int, 128>{}); break;
    }
  } else if constexpr (!SH) {
    mma_layer<8, 256, 256, PROMOTE>(
        fa, [&](float (&acc)[4], int) { if (out) head_out(acc, w + SW_BSIG, out, 4, row_a, n, L); }, ring, j);
    mma_layer<256, 256, 64, PROMOTE>(fa, act(SW_BB, Linear{}), ring, j);
    next(a, mlp::A_BNECK, 64);
    // the view layer reads [bottleneck | v]; hv's 32 fragments land in a
    mma_layer<128, 288, 64, PROMOTE>([&](int kb) { return kb < 16 ? frag_of(a, kb) : xf(kb - 12); },
                                     act(SW_BV, Relu{}), ring, j);
    next(a, mlp::A_HV, 32);
    mma_layer<8, 128, 128, PROMOTE>(
        fa, [&](float (&acc)[4], int) { if (out) head_out(acc, w + SW_BRGB, out, 0, row_a, n, L); }, ring, j);
  }
}

template <int MODE, bool PROMOTE, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
    sm90_fwd_kernel(const float* __restrict__ x, const float* __restrict__ v, const bf16* __restrict__ w,
                    float* __restrict__ out, float* __restrict__ sig, long long n, int num_rgb,
                    uint32_t* __restrict__ stash, int S, int R) {
  constexpr int STAGES = fwd_stages(STAGED);
  constexpr int NSLABS = MODE == IN_SH ? (STAGED ? TRUNK_SLABS : SH_SLABS) : FWD_SLABS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem + STAGES * SLAB_BYTES;
  uint4* xv = reinterpret_cast<uint4*>(p) + (threadIdx.x >> 7) * XV_KB * 128;
  p += 2 * XV_KB * 128 * 16;
  const Staging stg{reinterpret_cast<uint32_t*>(p) + (threadIdx.x >> 7) * STAGING_BYTES / 4,
                    ((threadIdx.x >> 5) & 3) * 64 + ((threadIdx.x & 31) >> 2) * 4 + (threadIdx.x & 3)};
  p += STAGED ? 2 * STAGING_BYTES : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(p);
  int* released = reinterpret_cast<int*>(full + STAGES);
  const long long tiles = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int mine = static_cast<int>((tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const WeightRing<STAGES, NSLABS> ring{smem, full, released, w, mine * NSLABS};
  init_ring<STAGES>(full, released);
  if (threadIdx.x == 0) ring.prologue();
  int j = 0;
  for (int it = 0; it < mine; ++it) {
    const long long tile64 = (blockIdx.x + static_cast<long long>(it) * gridDim.x) * 2 + (threadIdx.x >> 7);
    forward_tile<MODE, PROMOTE, STAGED>(x, v, w, out, sig, n, num_rgb, stash, S, R, tile64, xv, stg, ring, j);
  }
  if (STAGED && (threadIdx.x & 127) == 0) bulk_wait();
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

inline long long padded_rows(long long n) { return (n + BLOCK_ROWS - 1) / BLOCK_ROWS * BLOCK_ROWS; }

// A persistent grid of one block per SM (or per 128-row tile, if fewer).
// With a stash, each layer's output goes out by bulk copies (STAGED); PROMOTE
// as mma_layer says. IN_SH also takes sig [n] and num_rgb (1..SH_MAX_RGB),
// out being the coefficients [n, num_rgb].
template <int MODE, bool PROMOTE>
inline cudaError_t launch_forward(const float* x, const float* v, const bf16* w, float* out, long long n,
                                  bf16* stash, int S, int R, cudaStream_t stream, float* sig = nullptr,
                                  int num_rgb = 0) {
  if (n <= 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  uint32_t* st = reinterpret_cast<uint32_t*>(stash);
  if (stash) {
    constexpr auto kernel = sm90_fwd_kernel<MODE, PROMOTE, true>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem(true));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, THREADS, fwd_smem(true), stream>>>(x, v, w, out, sig, n, num_rgb, st, S, R);
  } else {
    constexpr auto kernel = sm90_fwd_kernel<MODE, PROMOTE, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem(false));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, THREADS, fwd_smem(false), stream>>>(x, v, w, out, sig, n, num_rgb, st, S, R);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, pass 2: the gradient down the layers (dX)
// ---------------------------------------------------------------------------

constexpr int DX_STAGES = 8;
constexpr int DX_BLOCKS = 132;  // fixed, so the bias sums' order does not depend on the card
__host__ __device__ constexpr int dx_smem(int gf) {  // gf gradient features a row
  return DX_STAGES * SLAB_BYTES + 2 * STAGING_BYTES + (2 * 4 * 256 + 2 * gf + ARRIVALS * 8) * 4 + DX_STAGES * 16;
}

// One step of the column sums' butterfly: lanes with bit B set keep the
// upper HALF of cs and send the lower to the lane across the bit, which
// does the reverse; each adds what it receives.
template <int HALF, int B, int M>
__device__ __forceinline__ void butterfly(float (&cs)[M], int lane) {
  const bool up = lane & B;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? cs[i] : cs[i + HALF];
    const float keep = up ? cs[i + HALF] : cs[i];
    cs[i] = keep + __shfl_xor_sync(mlp::FULL, send, B);
  }
}

// The gradient epilogue of pass p: acc times the relu mask of the activation
// stash block at mask (MASK), rounded to bf16 into the staging block
// (fragment q0 + 2 jb + h); the float32 column sums over the warp's 16 rows
// into the warp's scratch row, columns 128 p on. Eight n8 blocks at a
// time: a butterfly over the lanes that share t leaves lane g the sums of
// block jb0 + g's two columns.
template <int NB, bool MASK>
__device__ __forceinline__ void epi_grad(const float (&acc)[4 * NB], const Staging& stg, int q0,
                                         const uint32_t* mask, float* scr, const Lane& L) {
#pragma unroll
  for (int jb0 = 0; jb0 < NB; jb0 += 8) {
    float cs[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int jb = jb0 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * jb + 2 * h], v1 = acc[4 * jb + 2 * h + 1];
        if (MASK) {
          const float2 m = unpack_bf16(mask[stg.base + jb * 256 + h * 32]);
          if (!(m.x > 0.f)) v0 = 0.f;
          if (!(m.y > 0.f)) v1 = 0.f;
        }
        stg.at(q0 + 2 * jb + h) = pack_bf16(v0, v1);
        cs[2 * jj] = h ? cs[2 * jj] + v0 : v0;
        cs[2 * jj + 1] = h ? cs[2 * jj + 1] + v1 : v1;
      }
    }
    butterfly<8, 16>(cs, L.lane);
    butterfly<4, 8>(cs, L.lane);
    butterfly<2, 4>(cs, L.lane);
    scr[4 * q0 + 8 * (jb0 + L.g) + 2 * L.t] = cs[0];
    scr[4 * q0 + 8 * (jb0 + L.g) + 2 * L.t + 1] = cs[1];
  }
}

// The heads' output gradients: K1's g8 [n, 8] (g; columns 0..3 the rgb
// head's, 4..7 the sigma head's), or K5's g_rgb [n, num_rgb] (g) and
// g_sig [n] (sig).
struct HeadGrad {
  const float* g;
  const float* sig;
  int num_rgb;
};

// The products need no PROMOTE: the float64-sums rule holds with the
// forward's sums promoted alone (the activations' bf16 roundings and relu
// masks are what carry the forward's sum order into the gradients). A
// warpgroup's 64-row tile: each layer's gradient goes through the staging
// block to G by one bulk copy and back as the next product's fragments;
// its float32 column sums go through the scratch rows (scr: [4 warps][256])
// into the warpgroup's db row, the warps added in a fixed order. K1 (SH
// false): the view layer, the bottleneck and trunk_7, the heads' sums into
// this warp's dbh row. K5 (SH): the heads' gradients, rounded to bf16, are
// G's G_RGB and G_SIG features and the fragments of one K = 144 product
// over [coefficient head^T | sigma head^T] into dense 7; their float32
// column sums go through the scratch rows like a layer's. Then both trunks
// down to dense 0 alike.
template <bool SH, class Ring>
__device__ __forceinline__ void dx_tile(const HeadGrad& hd, long long n, const uint32_t* A, uint32_t* G,
                                        long long tile64, const Staging& stg, float* scr, float* db, float* dbh,
                                        const Ring& ring, int& j) {
  constexpr int AF8 = a_feats(SH) / 8, GF8 = g_feats(SH) / 8;
  constexpr int G_TRUNK = SH ? sh::G_TRUNK : mlp::G_TRUNK;
  const Lane L;
  const int wtid = threadIdx.x & 127;
  auto ast = [&](int feat) { return A + slot(tile64, AF8, feat / 8, 0, 0); };
  auto gst = [&](int feat) { return G + slot(tile64, GF8, feat / 8, 0, 0); };
  auto prefetch = [&](int feat, int feats) {
    if (wtid == 0) prefetch_l2(ast(feat), feats * 128);
  };
  float* my_scr = scr + L.warp * 256;
  // a layer's epilogue: masked by the activation block of feature mfeat
  // (mfeat < 0: no mask)
  auto grad = [&](int mfeat) {
    return [&, mfeat](float (&acc)[64], int p) {
      if (p == 0) stg.begin();
      if (mfeat >= 0) {
        epi_grad<16, true>(acc, stg, 32 * p, ast(mfeat + 128 * p), my_scr, L);
      } else {
        epi_grad<16, false>(acc, stg, 32 * p, nullptr, my_scr, L);
      }
    };
  };
  // after it: the block to G at feature gfeat, the column sums into db,
  // the fragments (count) into a
  uint32_t a[64];
  auto next = [&](int gfeat, int count) {
    stg.store(gst(gfeat), count * 512);
    for (int c = wtid; c < count * 4; c += 128)
      db[gfeat + c] += scr[c] + scr[256 + c] + scr[512 + c] + scr[768 + c];
#pragma unroll
    for (int q = 0; q < 64; ++q)
      if (q < count) a[q] = stg.at(q);
  };
  if constexpr (SH) {
    prefetch(mlp::A_TRUNK + 7 * 256, 256);
    // g_rgb as a 128-column layer's output (zero past num_rgb and n): its
    // bf16 fragments 0..31 and column sums; g_sig as column 0 of the n8
    // block after it (fragments 32, 33; scratch columns 128..135)
    float hg[64], sg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = tile64 * 64 + L.ra + 8 * h;
      sg[h] = row < n && L.t == 0 ? hd.sig[row] : 0.f;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jb + 2 * L.t + e;
          hg[4 * jb + 2 * h + e] = row < n && c < hd.num_rgb ? hd.g[row * hd.num_rgb + c] : 0.f;
        }
    }
    stg.begin();
    epi_grad<16, false>(hg, stg, 0, nullptr, my_scr, L);
    float cs = sg[0] + sg[1];
#pragma unroll
    for (int b = 4; b < 32; b <<= 1) cs += __shfl_xor_sync(mlp::FULL, cs, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) stg.at(32 + h) = pack_bf16(sg[h], 0.f);
    if (L.g == 0) {
      my_scr[128 + 2 * L.t] = cs;
      my_scr[129 + 2 * L.t] = 0.f;
    }
    next(sh::G_RGB, 34);
    a[34] = a[35] = 0u;
    // dense 7: (g_rgb @ wrgb^T + g_sig @ wsig^T) * (a7 > 0)
    mma_layer<256, 144, 64, false>([&](int kb) { return frag_of(a, kb); }, grad(mlp::A_TRUNK + 7 * 256), ring, j);
  } else {
    prefetch(mlp::A_HV, 128);
    // the heads: columns 2t, 2t + 1 of g8 (rgb for t < 2, sigma for t >= 2)
    float2 hg[2], sg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = tile64 * 64 + L.ra + 8 * h;
      hg[h] = row < n ? *reinterpret_cast<const float2*>(hd.g + row * 8 + 2 * L.t) : make_float2(0.f, 0.f);
      sg[h] = row < n && L.t < 2 ? *reinterpret_cast<const float2*>(hd.g + row * 8 + 4 + 2 * L.t)
                                 : make_float2(0.f, 0.f);
      gst(mlp::G_RGB)[stg.base + h * 32] = pack_bf16(hg[h].x, hg[h].y);
    }
    {
      float cs[2] = {hg[0].x + hg[1].x, hg[0].y + hg[1].y};
#pragma unroll
      for (int b = 4; b < 32; b <<= 1) {
        cs[0] += __shfl_xor_sync(mlp::FULL, cs[0], b);
        cs[1] += __shfl_xor_sync(mlp::FULL, cs[1], b);
      }
      if (L.g == 0) {
        dbh[2 * L.t] += cs[0];
        dbh[2 * L.t + 1] += cs[1];
      }
    }
    const Frag frgb{{L.t < 2 ? pack_bf16(hg[0].x, hg[0].y) : 0u, L.t < 2 ? pack_bf16(hg[1].x, hg[1].y) : 0u, 0u, 0u}};
    const Frag fsig{{pack_bf16(sg[0].x, sg[0].y), pack_bf16(sg[1].x, sg[1].y), 0u, 0u}};
    // the view layer: g_hv = (g_rgb @ wrgb^T) * (hv > 0)
    mma_layer<128, 16, 16, false>([&](int) { return frgb; }, grad(mlp::A_HV), ring, j);
    next(mlp::G_V, 32);
    prefetch(mlp::A_TRUNK + 7 * 256, 256);
    // the bottleneck: g_bneck = (g_hv @ wv^T)[:, :256]
    mma_layer<256, 128, 64, false>([&](int kb) { return frag_of(a, kb); }, grad(-1), ring, j);
    next(mlp::G_B, 64);
    // trunk_7: (g_bneck @ wb^T + g_sig @ wsig^T) * (a7 > 0)
    mma_layer<256, 272, 64, false>([&](int kb) { return kb < 16 ? frag_of(a, kb) : fsig; },
                                  grad(mlp::A_TRUNK + 7 * 256), ring, j);
  }
  next(G_TRUNK + 7 * 256, 64);
  // trunk_l, l = 6..0: (g_{l+1} @ w_{l+1}^T) * (a_l > 0); for l = 4 the
  // product takes w5's h rows only (x carries no gradient)
#pragma unroll 1
  for (int l = 6; l >= 0; --l) {
    prefetch(mlp::A_TRUNK + l * 256, 256);
    mma_layer<256, 256, 64, false>([&](int kb) { return frag_of(a, kb); }, grad(mlp::A_TRUNK + l * 256), ring, j);
    next(G_TRUNK + l * 256, 64);
  }
}

// Writes G and, per block, the float32 bias-gradient sums
// db_part[blockIdx.x][G features] (warpgroups and warps summed in a fixed
// order).
template <bool SH>
__global__ void __launch_bounds__(THREADS, 1)
    sm90_dx_kernel(const HeadGrad hd, long long n, const bf16* __restrict__ wt, const uint32_t* __restrict__ A,
                   uint32_t* __restrict__ G, long long tiles, float* __restrict__ db_part) {
  constexpr int GF = g_feats(SH);
  constexpr int NSLABS = SH ? SH_DX_SLABS : DX_SLABS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wg = threadIdx.x >> 7;
  unsigned char* p = smem + DX_STAGES * SLAB_BYTES;
  const Staging stg{reinterpret_cast<uint32_t*>(p) + wg * STAGING_BYTES / 4,
                    ((threadIdx.x >> 5) & 3) * 64 + ((threadIdx.x & 31) >> 2) * 4 + (threadIdx.x & 3)};
  p += 2 * STAGING_BYTES;
  float* scr = reinterpret_cast<float*>(p);   // [2][4][256]
  float* db = scr + 2 * 4 * 256;              // [2][GF]
  float* dbh = db + 2 * GF;                   // [8 warps][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(dbh + ARRIVALS * 8);
  int* released = reinterpret_cast<int*>(full + DX_STAGES);
  for (int i = threadIdx.x; i < 2 * GF + ARRIVALS * 8; i += THREADS) db[i] = 0.f;
  const int mine = static_cast<int>((tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const WeightRing<DX_STAGES, NSLABS> ring{smem, full, released, wt, mine * NSLABS};
  init_ring<DX_STAGES>(full, released);
  if (threadIdx.x == 0) ring.prologue();
  int j = 0;
  for (int it = 0; it < mine; ++it) {
    const long long tile64 = (blockIdx.x + static_cast<long long>(it) * gridDim.x) * 2 + wg;
    dx_tile<SH>(hd, n, A, G, tile64, stg, scr + wg * 4 * 256, db + wg * GF, dbh + (threadIdx.x >> 5) * 8, ring, j);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
  __syncthreads();
  for (int i = threadIdx.x; i < GF; i += THREADS) {
    float s = db[i] + db[GF + i];
    if (!SH && i < 8)
      for (int wi = 0; wi < ARRIVALS; ++wi) s += dbh[wi * 8 + i];
    db_part[static_cast<long long>(blockIdx.x) * GF + i] = s;
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 3: dW = A^T G, split over rows, then fixed-order sums
// (mlp_tile.cuh's for K1, fused_sh_bwd.cu's for K5b)
// ---------------------------------------------------------------------------

// A block's share of one dW: each warpgroup 64 rows of dW (64 activation
// features), both over the same gradient features.
struct DwJob {
  int a_feat[2];     // first activation feature of each warpgroup's rows
  int m_live[2];     // rows each writes: 64, 32 or 0 (idle)
  long long out[2];  // first element of each warpgroup's rows in the gradient buffer
  int g_feat, n;     // gradient features g_feat..g_feat + n: the product's columns (n 8 or 128)
  int col0, n_live;  // product columns col0..col0 + n_live are dW's columns 0..n_live
  int out_ld;        // dW's row stride; with pad, columns n_live..out_ld are written as 0
  int pad;
};
constexpr int DW_MAX_JOBS = 42;  // K1's table; K5's holds 36
struct DwJobs {
  DwJob e[DW_MAX_JOBS];
  int n;  // jobs in the table
};
// row splits: 3 x K1's 42 jobs (126 blocks) or 3 x K5's 36 (108) fill one
// wave of 132 SMs
constexpr int DW_SPLITS = 3;
constexpr int DW_STAGES = 6;
constexpr int DW_STAGE_BYTES = 2 * 8192 + 16384;  // both warpgroups' activation slabs, the gradient slab
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + DW_STAGES * 16;

// A table of dW jobs, built layer by layer.
struct DwTable {
  DwJobs t{};
  // M tiles of 64 activation features -> dW rows; two to a job, the second
  // idle when the count is odd; a 256-wide dW as two jobs of 128 columns
  void add(const int* feats, const long long* outs, const int* live, int tiles, int g_feat, int n, int col0,
           int n_live, int out_ld) {
    for (int c0 = 0; c0 < n; c0 += 128) {
      for (int i = 0; i < tiles; i += 2) {
        DwJob& e = t.e[t.n++];
        for (int h = 0; h < 2; ++h) {
          const bool on = i + h < tiles;
          e.a_feat[h] = feats[on ? i + h : i];
          e.m_live[h] = on ? live[i + h] : 0;
          e.out[h] = outs[on ? i + h : i] + c0;
        }
        e.g_feat = g_feat + c0;
        e.n = n < 128 ? n : 128;
        e.col0 = col0;
        e.n_live = n_live < 128 ? n_live : 128;
        e.out_ld = out_ld;
        e.pad = n_live < out_ld ? out_ld - n_live : 0;
      }
    }
  }
  // a dW of `rows` rows (a multiple of 64) from activation features a_feat..
  void layer(int a_feat, long long out, int g_feat, int rows, int n, int col0, int n_live, int ld) {
    const int full4[4] = {64, 64, 64, 64};
    int feats[4];
    long long outs[4];
    for (int i = 0; i < rows / 64; ++i) {
      feats[i] = a_feat + 64 * i;
      outs[i] = out + 64LL * i * ld;
    }
    add(feats, outs, full4, rows / 64, g_feat, n, col0, n_live, ld);
  }
  // dense 0..7 of either MLP (mlp's GW0..GW6, which are sh's too): w5's
  // rows are [x | h4]; g_trunk is the gradient stash's dense 0 output
  void trunk(int g_trunk) {
    using mlp::A_TRUNK;
    using mlp::A_X;
    layer(A_X, mlp::GW0, g_trunk, 64, 256, 0, 256, 256);
    for (int l = 1; l <= 4; ++l)
      layer(A_TRUNK + (l - 1) * 256, mlp::GW1 + (l - 1) * 65536LL, g_trunk + l * 256, 256, 256, 0, 256, 256);
    const int feats[5] = {A_X, A_TRUNK + 4 * 256, A_TRUNK + 4 * 256 + 64, A_TRUNK + 4 * 256 + 128, A_TRUNK + 4 * 256 + 192};
    long long outs[5];
    for (int i = 0; i < 5; ++i) outs[i] = mlp::GW5 + 64LL * i * 256;
    const int live[5] = {64, 64, 64, 64, 64};
    add(feats, outs, live, 5, g_trunk + 5 * 256, 256, 0, 256, 256);
    layer(A_TRUNK + 5 * 256, mlp::GW6, g_trunk + 6 * 256, 256, 256, 0, 256, 256);
    layer(A_TRUNK + 6 * 256, mlp::GW6 + 65536, g_trunk + 7 * 256, 256, 256, 0, 256, 256);
  }
};

// K1's jobs: the trunk, the sigma head, the bottleneck, view_0 and the rgb head.
inline DwJobs dw_jobs() {
  using namespace mlp;
  DwTable b;
  b.trunk(G_TRUNK);
  // the sigma head: gradient features 0..7 hold [g_rgb | g_sig]
  b.layer(A_TRUNK + 7 * 256, GWSIG, G_RGB, 256, 8, G_SIG - G_RGB, 4, 128);
  b.layer(A_TRUNK + 7 * 256, GWB, G_B, 256, 256, 0, 256, 256);
  {  // view_0: [bottleneck | v], 288 rows
    const int feats[5] = {A_BNECK, A_BNECK + 64, A_BNECK + 128, A_BNECK + 192, A_BNECK + 256};
    long long outs[5];
    for (int i = 0; i < 5; ++i) outs[i] = GWV + 64LL * i * 128;
    const int live[5] = {64, 64, 64, 64, 32};
    b.add(feats, outs, live, 5, G_V, 128, 0, 128, 128);
  }
  b.layer(A_HV, GWRGB, G_RGB, 128, 8, 0, 4, 128);
  return b.t;
}

// K5's jobs: the trunk, then the sigma head (N = 8 from G_SIG) and the
// coefficient head (N = 128 from G_RGB), each dW row 128 wide with the
// columns past the live ones written 0. A live count is rounded up to
// even (the stores take column pairs): the extra column's gradient
// features are zero in the stash, so it too is written 0.
inline DwJobs sh_dw_jobs(int num_rgb) {
  DwTable b;
  b.trunk(sh::G_TRUNK);
  b.layer(mlp::A_TRUNK + 7 * 256, sh::GWSIG, sh::G_SIG, 256, 8, 0, 2, 128);
  b.layer(mlp::A_TRUNK + 7 * 256, sh::GWRGB, sh::G_RGB, 256, 128, 0, (num_rgb + 1) / 2 * 2, 128);
  return b.t;
}

// Each 64-row stage's products go to a fresh accumulator (two, in turn, so
// the next stage's wgmmas run while this one is added), which is added
// into the float32 total: the tensor cores' sums then never run over more
// than 64 rows.
template <int N>
__device__ __forceinline__ void dw_run(const bf16* A, const bf16* G, int a_f8, int g_f8, long long k0, int nk,
                                       float* part, const DwJob& e, unsigned char* buf, uint64_t* full,
                                       int* released) {
  const Lane L;
  const int wg = L.wg;
  auto issue = [&](int j) {
    if (j >= nk) return;
    const int st = j % DW_STAGES;
    const long long tile = k0 + j;
    unsigned char* dst = buf + st * DW_STAGE_BYTES;
    mbar_expect_tx(&full[st], 2 * 8192 + N * 128);
    bulk_g2s(dst, A + (tile * a_f8 + e.a_feat[0] / 8) * 512, 8192, &full[st]);
    bulk_g2s(dst + 8192, A + (tile * a_f8 + e.a_feat[1] / 8) * 512, 8192, &full[st]);
    bulk_g2s(dst + 16384, G + (tile * g_f8 + e.g_feat / 8) * 512, N * 128, &full[st]);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < DW_STAGES; ++j) issue(j);
  auto release = [&](int j) {
    if (L.lane == 0 && atomicAdd(&released[j % DW_STAGES], 1) == ARRIVALS - 1) {
      released[j % DW_STAGES] = 0;
      issue(j + DW_STAGES);
    }
    __syncwarp();
  };
  auto stage = [&](float (&acc)[N / 2], int j) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    mbar_wait(&full[j % DW_STAGES], (j / DW_STAGES) & 1);
    const uint32_t base = smem_u32(buf + (j % DW_STAGES) * DW_STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<N>::ss(acc, make_desc(base + wg * 8192 + kk * 256, 128, 1024), make_desc(base + 16384 + kk * 256, 128, 1024));
    wg_commit();
  };
  auto add = [&](float (&tot)[N / 2], float (&acc)[N / 2]) {
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
  };
  float tot[N / 2], acc0[N / 2], acc1[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
  if (nk > 0) stage(acc0, 0);
  int j = 0;
  for (; j + 1 < nk; j += 2) {  // stage j is in acc0, j + 1 goes to acc1
    stage(acc1, j + 1);
    wg_wait<1>();
    add(tot, acc0);
    release(j);
    if (j + 2 < nk) {
      stage(acc0, j + 2);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    add(tot, acc1);
    release(j + 1);
  }
  if (j < nk) {
    wg_wait<0>();
    add(tot, acc0);
    release(j);
  }
  // dW rows ra, ra + 8 of this warpgroup's 64; columns 8 jb + 2t + e
  const int m_live = e.m_live[wg];
  float* out = part + e.out[wg];
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = L.ra + 8 * h;
      const int c = 8 * jb + 2 * L.t - e.col0;
      if (m < m_live && c >= 0 && c < e.n_live)  // n_live even, col0 even: the pair is live together
        *reinterpret_cast<float2*>(out + static_cast<long long>(m) * e.out_ld + c) =
            make_float2(tot[4 * jb + 2 * h], tot[4 * jb + 2 * h + 1]);
    }
  for (int i = threadIdx.x & 127; i < m_live * e.pad; i += 128)
    out[static_cast<long long>(i / e.pad) * e.out_ld + e.n_live + i % e.pad] = 0.f;
}

// Block (job x, split y): its job's dW over split y's rows of the stashes
// (a_f8, g_f8 feature groups a row) into part[y][GB0 of mlp].
__global__ void __launch_bounds__(THREADS, 1)
    sm90_dw_kernel(const bf16* __restrict__ A, const bf16* __restrict__ G, int a_f8, int g_f8, long long tiles,
                   int tiles_per_split, float* __restrict__ part, const __grid_constant__ DwJobs jobs) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  int* released = reinterpret_cast<int*>(full + DW_STAGES);
  const DwJob& e = jobs.e[blockIdx.x];
  const long long k0 = static_cast<long long>(blockIdx.y) * tiles_per_split;
  const long long k1 = k0 + tiles_per_split < tiles ? k0 + tiles_per_split : tiles;
  const int nk = k1 > k0 ? static_cast<int>(k1 - k0) : 0;
  init_ring<DW_STAGES>(full, released);
  float* p = part + static_cast<long long>(blockIdx.y) * mlp::GB0;
  if (e.n == 128) {
    dw_run<128>(A, G, a_f8, g_f8, k0, nk, p, e, smem, full, released);
  } else {
    dw_run<8>(A, G, a_f8, g_f8, k0, nk, p, e, smem, full, released);
  }
}

// ---------------------------------------------------------------------------
// Host side: workspace and the backward passes
// ---------------------------------------------------------------------------

inline long long align256(long long bytes) { return (bytes + 255) / 256 * 256; }

struct Workspace {
  bf16* A;         // activation stash, npad x f.a features
  bf16* G;         // gradient stash, npad x f.g features
  float* part;     // [DW_SPLITS][mlp::GB0]
  float* db_part;  // [DX_BLOCKS][f.g]
  float* raw;      // [n, 8], with the composite (K2) only
  float* g8;       // [n, 8], with the composite (K2) only
};

// The backward's workspace for n rows and stashes of f features a row;
// with `composite` (the fused train level) also the head outputs and their
// gradient, which K1rb takes from its caller.
inline long long workspace_bytes(long long n, Feats f, bool composite) {
  const long long npad = padded_rows(n);
  return align256(npad * f.a * 2) + align256(npad * f.g * 2) + align256(DW_SPLITS * mlp::GB0 * 4) +
         align256(DX_BLOCKS * f.g * 4LL) + (composite ? 2 * align256(n * 8 * 4) : 0);
}

inline Workspace carve(void* base, long long n, Feats f, bool composite) {
  const long long npad = padded_rows(n);
  char* p = static_cast<char*>(base);
  Workspace ws{};
  ws.A = reinterpret_cast<bf16*>(p);
  p += align256(npad * f.a * 2);
  ws.G = reinterpret_cast<bf16*>(p);
  p += align256(npad * f.g * 2);
  ws.part = reinterpret_cast<float*>(p);
  p += align256(DW_SPLITS * mlp::GB0 * 4);
  ws.db_part = reinterpret_cast<float*>(p);
  p += align256(DX_BLOCKS * f.g * 4LL);
  if (composite) {
    ws.raw = reinterpret_cast<float*>(p);
    p += align256(n * 8 * 4);
    ws.g8 = reinterpret_cast<float*>(p);
  }
  return ws;
}

// The dX pass over a filled activation stash: K1's (SH false, hd.g the
// heads' g8 [n, 8]) or K5's (SH, hd.g g_rgb [n, num_rgb], hd.sig g_sig [n]).
template <bool SH>
inline cudaError_t launch_dx(const HeadGrad& hd, long long n, const bf16* wt, const Workspace& ws, int* dx_blocks,
                             cudaStream_t stream) {
  constexpr int smem = dx_smem(g_feats(SH));
  const long long tiles = padded_rows(n) / BLOCK_ROWS;
  *dx_blocks = static_cast<int>(tiles < DX_BLOCKS ? tiles : DX_BLOCKS);
  cudaError_t err = cudaFuncSetAttribute(sm90_dx_kernel<SH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sm90_dx_kernel<SH><<<*dx_blocks, THREADS, smem, stream>>>(hd, n, wt, reinterpret_cast<const uint32_t*>(ws.A),
                                                            reinterpret_cast<uint32_t*>(ws.G), tiles, ws.db_part);
  return cudaGetLastError();
}

// The dW pass over both stashes (f features a row) into the split-K
// partials ws.part; *splits gets their number.
inline cudaError_t launch_dw_parts(long long n, const Workspace& ws, Feats f, const DwJobs& jobs, int* splits,
                                   cudaStream_t stream) {
  const long long tiles = padded_rows(n) / 64;
  const long long per = (tiles + DW_SPLITS - 1) / DW_SPLITS;
  *splits = static_cast<int>((tiles + per - 1) / per);
  cudaError_t err = cudaFuncSetAttribute(sm90_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return err;
  sm90_dw_kernel<<<dim3(jobs.n, *splits), THREADS, DW_SMEM, stream>>>(ws.A, ws.G, f.a / 8, f.g / 8, tiles,
                                                                      static_cast<int>(per), ws.part, jobs);
  return cudaGetLastError();
}

// K1's dW pass, then mlp_tile.cuh's fixed-order sums into grads
// [GRAD_ELEMS] float32.
inline cudaError_t launch_dw(long long n, const Workspace& ws, int dx_blocks, float* grads, cudaStream_t stream) {
  int splits = 0;
  cudaError_t err = launch_dw_parts(n, ws, K1_FEATS, dw_jobs(), &splits, stream);
  if (err != cudaSuccess) return err;
  mlp::mlp_grad_reduce_kernel<<<static_cast<unsigned>((mlp::GRAD_ELEMS + 255) / 256), 256, 0, stream>>>(
      ws.part, splits, ws.db_part, dx_blocks, grads);
  return cudaGetLastError();
}

}  // namespace sm90
