// Hopper (sm_90a) flash attention: softmax(q k^T / sqrt(D)) v over
// (B, H, N, D) tokens, with the online softmax over K/V tiles.
//
// Replaces the Pallas TPU kernel flash_attention of
// generative_turbulence_tpu/ops/pallas_kernels.py:49-146 (_flash_kernel and
// its wrapper).  The TPU kernel pads a ragged N with a -1e9 key-bias
// channel; here keys >= N are masked to -inf in the last K/V tile only, and
// queries >= N are computed on zero rows and not stored.
//
// What bounds it on an H100.  At the path shape (the 2-level U-Net's
// bottleneck: B=8, H=4, N=6912, D=32) one call is 4*B*H*N^2*D = 195.7 GFLOP
// and B*H*N^2 = 1.53e9 exponentials over 57 MB of q, k, v and out.
//   - bf16: the products take 0.20 ms at 989 TFLOP/s, but each score costs
//     only 4*D = 128 FLOP of products against one exponential, and the MUFU
//     computes about 3.9e12 ex2/s: 0.39 ms.  The exponentials set the floor,
//     so everything else (products, max, sum, conversions, loads) has to hide
//     behind the MUFU.
//   - f32 (no tensor cores: the JAX kernel runs its products at HIGHEST
//     precision and TF32 would miss the f32 tolerance): 195.7 GFLOP on the
//     FMA units at 67 TFLOP/s, 2.92 ms.
//
// What the designs do about it.
//   - bf16 (flash_attn_bf16_kernel): persistent blocks of three consumer
//     warpgroups (64 query rows each, 192 per work item) and one producer
//     thread.  The producer fills a ring of 4 shared-memory stages of K and
//     V (128 keys at D <= 32, 64 above) by TMA, one box of keys x 8 columns
//     per column group through a 4-d tensor map over the strided view, and
//     the copy engine completes each stage on its full mbarrier (keys >= N
//     arrive as zeros); the consumers release a stage on its empty mbarrier.
//     Q, K and V are staged as one plane per 8 columns with one 16-byte row
//     per token, the no-swizzle core-matrix layout, so that
//       * S = Q K^T is wgmma m64nBKVk16 with Q and K read from shared memory
//         by descriptor (K's row-major tile is the K-major B operand), and
//       * O += P V is wgmma m64nDk16 with P as the register A operand (the S
//         accumulator, converted to bf16 pairs, has the A fragment layout) and
//         V read by descriptor as the MN-major B operand (the transpose bit),
//         straight from its row-major tile: no transposed copy of V.
//     The softmax costs one FFMA and one ex2.approx.ftz per score
//     (p = 2^(s*c - m*c), c = log2(e)/sqrt(D), m the running max of the raw
//     scores); p is rounded to bf16 for P V, the row sum l is taken over the
//     unrounded f32 p.  Each warpgroup runs S, wait, softmax, P V, wait per
//     stage; the overlap of the exponentials with the products comes from
//     the three warpgroups, each in another phase of its chain.
//     Measured at the path shape (H100 SXM, 700 W) with flash_ab.py, which
//     times timing-only ablations of this kernel in turns (0.70 ms): with
//     each exponential replaced by its FFMA argument it runs in 0.80x the
//     time, without P V in 0.79x, without the whole softmax in 0.62x; with
//     two warpgroups in 1.31x, with 64-key stages in 1.15x.  So the MUFU
//     costs a fifth and each warpgroup's serial chain the rest.  Before
//     TMA, a producer warp's cp.async (~25 instructions of 64-bit address
//     arithmetic per pair of 16-byte copies) took 0.92 ms where TMA takes
//     0.77 in the same run, and with it the kernel ran no faster without
//     exponentials.  Pipelining within a warpgroup (S of the next keys
//     issued before the softmax of these, or P V of the previous keys under
//     the softmax, P double-buffered in registers) made it 1.3-1.8x slower:
//     ptxas serialises the wgmmas (C7514) or injects warpgroup arrives
//     (C7519) and spills.
//   - f32 (flash_attn_f32_kernel): 128 queries per block, K/V tiles
//     double-buffered by cp.async.  Each thread computes an 8 x 8 tile of
//     scores at D <= 32 (4 x 8 at 64, 4 x 4 at 128) from 16-byte
//     shared-memory loads of q and k (16 FMAs per load), keeps its 8 rows
//     x D/8 columns of the output in registers, and passes its p through
//     shared memory to the P V product, blocked the same way (32 FMAs per 3
//     loads).  Shared memory, not the FMA units, is what a smaller tile runs
//     out of: 16 bytes a thread per load against 4 FMAs a thread per clock.
//     At the path shape the 4 x 8 tile took 6.23 ms, the 8 x 8 tile 5.57 ms
//     (H100 SXM, 700 W), against 2.92 ms for the FMA units alone.
// Both read q, k, v through their batch, head and token strides (the last
// stride must be 1), so the (B, N, 3, H, D) qkv views of the U-Net need no
// copy, and both sum in a fixed order: a second run is bit-equal.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

struct Strides {
  long long b, h, n;  // in elements; the d stride is 1
};

struct TmaSlots {
  int n, h, b;  // the dimension (1..3) of a K/V tensor map that holds each
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Arrive on the barrier and raise the bytes its phase waits for by bytes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box of the 4-d tensor map at coordinates c (innermost first) into
// shared memory at dst, completing its bytes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before later reads by wgmma, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching registers that an asynchronous wgmma
// writes (the accumulator) or still reads (the register A operand) across
// its wait: called right after wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: core matrices of 8 rows x 16
// bytes at start address addr; lbo bytes between core matrices adjacent in
// the K dimension, sbo bytes between core matrices adjacent in M or N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// WgmmaSS<N>: D (64 x N, f32) (+)= A (64 x 16) B (16 x N), both bf16 in
// shared memory, K-major; scale_d = 0 overwrites D.
// WgmmaRS<N>: D (64 x N, f32) += A (64 x 16, bf16 registers: the mma.sync
// m16n8k16 A fragment of each warp's 16 rows) B (16 x N), B MN-major in
// shared memory (the transpose bit).
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};
// ---- bf16 ------------------------------------------------------------------

constexpr int NWG = 3;                   // consumer warpgroups per block
constexpr int BQ = 64 * NWG;             // queries per work item
constexpr int THREADS = 128 * NWG + 32;  // + one producer warp

// Shared memory of one block: Q (DK / 8 planes of BQ 16-byte rows), the K/V
// ring (each stage DK / 8 planes of K, then DK / 8 of V, each BKV 16-byte
// rows: one TMA box each), the full and empty mbarriers.  A Q plane is
// padded by 16 bytes, so the column groups of one row, which neighbouring
// threads write, fall on different banks.
template <int DK>
struct Bf16Geometry {
  static constexpr int BKV = DK <= 32 ? 128 : 64;  // keys per stage
  static constexpr int PLANE = BKV * 16;
  static constexpr int QPLANE = BQ * 16 + 16;
  static constexpr int RING_OFF = (DK / 8 * QPLANE + 127) / 128 * 128;
  static constexpr int STAGE = 2 * (DK / 8) * PLANE;
  static constexpr int FIT = (227 * 1024 - RING_OFF - 128) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
};

// DK: D rounded up to a multiple of 16 (16, 32, 64 or 128); columns D..DK-1
// are zero in shared memory and contribute nothing.  Work item w (of
// total = B * H * n_qt) is queries [qt * BQ, qt * BQ + BQ) of head bh,
// w = bh * n_qt + qt; block i takes items i, i + gridDim.x, ...  K and V
// are read through their tensor maps (make_kv_map); slk, slv say which of
// each map's dimensions 1..3 is the token, the head and the batch.
template <int DK>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bf16_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, bf16* __restrict__ out, int N,
                       int H, int D, int n_qt, int total, Strides sq, TmaSlots slk,
                       TmaSlots slv, float c) {
  using G = Bf16Geometry<DK>;
  constexpr int BKV = G::BKV, STAGES = G::STAGES, KG = DK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem + G::RING_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_kv = (N + BKV - 1) / BKV;
  const int dg = D / 8;  // column groups that hold data

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);            // the producer's expect_tx
      mbar_init(empty + s, 4 * NWG);     // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The column groups dg..KG-1 of every stage are never loaded into: zero.
  for (int i = tid; i < STAGES * 2 * (KG - dg) * BKV; i += THREADS) {
    const int r = i % BKV, rest = i / BKV;
    const int j = dg + rest % (KG - dg), sv_ = rest / (KG - dg);  // sv_ = stage * 2 + (K or V)
    *reinterpret_cast<uint4*>(smem + G::RING_OFF + sv_ * (KG * G::PLANE) + j * G::PLANE + r * 16) =
        make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one thread loads the K/V tiles of every item, in the
    // consumers' order, by TMA: one box of BKV rows x 8 columns per column
    // group, rows >= N filled with zeros by the copy engine ----
    if (lane == 0) {
      const uint32_t bytes = 2 * dg * G::PLANE;
      int it = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        const int bh = w / n_qt, b = bh / H, h = bh - b * H;
        for (int t = 0; t < n_kv; ++t, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + slot, (it / STAGES - 1) & 1);
          const uint32_t kst = ring + slot * G::STAGE, vst = kst + KG * G::PLANE;
          auto at = [&](const TmaSlots& sl, int d) {  // the coordinate of map dimension d
            return d == sl.n ? t * BKV : d == sl.h ? h : b;
          };
          mbar_expect_tx(full + slot, bytes);
          for (int j = 0; j < dg; ++j) {
            tma_load_4d(kst + j * G::PLANE, &tmk, 8 * j, at(slk, 1), at(slk, 2), at(slk, 3),
                        full + slot);
            tma_load_4d(vst + j * G::PLANE, &tmv, 8 * j, at(slv, 1), at(slv, 2), at(slv, 3),
                        full + slot);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wg * 64 .. + 63 of an item ----
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t q_wg = smem_u32(smem) + wg * 64 * 16;
  int it = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int bh = w / n_qt, b = bh / H, h = bh - b * H;
    const int q0 = (w - bh * n_qt) * BQ + wg * 64;
    const bf16* qb = q + b * sq.b + h * sq.h;
    warpgroup_barrier(1 + wg);  // the previous item's wgmmas are done with Q
    for (int i = tid & 127; i < 64 * KG; i += 128) {
      const int r = i / KG, j = i % KG;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (q0 + r < N && j < dg) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq.n + 8 * j);
      *reinterpret_cast<uint4*>(smem + j * G::QPLANE + (wg * 64 + r) * 16) = val;
    }
    fence_proxy_async();
    warpgroup_barrier(1 + wg);

    // Rows g and g + 8 of this warp's 16: the running max of the raw scores,
    // this lane's share of the running sum, and the output accumulator.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float o[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) o[i] = 0.0f;

    for (int t = 0; t < n_kv; ++t, ++it) {
      const int slot = it % STAGES;
      mbar_wait(full + slot, (it / STAGES) & 1);
      __syncwarp();  // the waits diverge; wgmma needs the warp converged
      const uint32_t kst = ring + slot * G::STAGE, vst = kst + KG * G::PLANE;

      // ---- S = Q K^T (64 x BKV per warpgroup) ----
      float s[BKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        WgmmaSS<BKV>::mma(s, desc(q_wg + 2 * kk * G::QPLANE, G::QPLANE, 128),
                          desc(kst + 2 * kk * G::PLANE, G::PLANE, 128), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // ---- online softmax on the accumulator: s[4j + e] is row g, s[4j + 2
      // + e] row g + 8, both key 8j + 2 t4 + e of the tile ----
      const int n0 = t * BKV;
      if (n0 + BKV > N) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + 8 * j + 2 * t4 + e >= N) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // Every tile holds a key < N, so mx0, mx1 are finite; m = -inf before
      // the first tile gives alpha = 2^-inf = 0.
      const float mc0 = mx0 * c, mc1 = mx1 * c;
      const float a0 = ex2(fmaf(m0, c, -mc0)), a1 = ex2(fmaf(m1, c, -mc1));
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.0f, sum1 = 0.0f;
      uint32_t p[BKV / 4];  // bf16 pairs: p[2j] row g, p[2j + 1] row g + 8
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float p00 = ex2(fmaf(s[4 * j], c, -mc0)), p01 = ex2(fmaf(s[4 * j + 1], c, -mc0));
        const float p10 = ex2(fmaf(s[4 * j + 2], c, -mc1)), p11 = ex2(fmaf(s[4 * j + 3], c, -mc1));
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        p[2 * j] = pack_bf16(p00, p01);
        p[2 * j + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < DK / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // ---- O += P V: keys 16 ks .. 16 ks + 15 are key groups 2 ks, 2 ks + 1,
      // whose pairs are the A fragment {row g, row g + 8} x {lo, hi} ----
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
        WgmmaRS<DK>::mma(o, a, desc(vst + ks * 256, 128, G::PLANE));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the stage
    }

    // ---- epilogue: the quad's partial sums, then out = o / l ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float r0 = 1.0f / l0, r1 = 1.0f / l1;
    const int n_a = q0 + 16 * wq + g, n_b = n_a + 8;
    bf16* ob = out + (long long)bh * N * D;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      const int col = 8 * j + 2 * t4;  // D is a multiple of 8: col < D => col + 1 < D
      if (col < D) {
        if (n_a < N)
          *reinterpret_cast<uint32_t*>(ob + (long long)n_a * D + col) =
              pack_bf16(o[4 * j] * r0, o[4 * j + 1] * r0);
        if (n_b < N)
          *reinterpret_cast<uint32_t*>(ob + (long long)n_b * D + col) =
              pack_bf16(o[4 * j + 2] * r1, o[4 * j + 3] * r1);
      }
    }
  }
}

// ---- f32 -------------------------------------------------------------------

constexpr int F32_BQ = 128;  // queries per block

// Shared memory, in floats: Q (pre-scaled by c) and two K buffers with a row
// pitch of DK + 4, two V buffers of pitch DK, and P transposed (key-major,
// pitch BQ + 4).  The pads put the rows that the 8 threads of a query group
// read or write at once on different banks.
template <int DK>
struct F32Geometry {
  static constexpr int QPT = DK <= 32 ? 8 : 4;         // query rows per thread
  static constexpr int THREADS = F32_BQ / QPT * 8;     // thread (qg, kg) = (tid / 8, tid % 8)
  static constexpr int BK = DK == 128 ? 32 : 64;       // keys per tile
  static constexpr int KPT = BK / 8;                   // keys per thread: kg + 8 j
  static constexpr int QP = DK + 4, PP = F32_BQ + 4;
  static constexpr int K_OFF = F32_BQ * QP;
  static constexpr int V_OFF = K_OFF + 2 * BK * QP;
  static constexpr int P_OFF = V_OFF + 2 * BK * DK;
  static constexpr int BYTES = (P_OFF + BK * PP) * 4;
};

// DK: D rounded up to 32, 64 or 128.  Thread (qg, kg) owns query rows
// QPT qg .. QPT qg + QPT - 1 of the block: their scores against keys kg + 8 j
// of a tile and their output columns 4 kg + 32 u .. + 3.  The 8 threads of
// a query group are neighbouring lanes of one warp, so the row max and sum
// reduce with shuffles and P needs only a warp barrier.  Block w is query
// tile w % n_qt of head w / n_qt.
template <int DK>
__global__ void __launch_bounds__(F32Geometry<DK>::THREADS, DK <= 32 ? 2 : 1)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int N, int H, int D,
                      int n_qt, Strides sq, Strides sk, Strides sv, float c) {
  using G = F32Geometry<DK>;
  constexpr int QPT = G::QPT, THREADS = G::THREADS, BK = G::BK, KPT = G::KPT;
  constexpr int QP = G::QP, PP = G::PP, U = DK / 32;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = fsm + G::K_OFF;
  float* Vs = fsm + G::V_OFF;
  float* Ps = fsm + G::P_OFF;

  const int tid = threadIdx.x, qg = tid >> 3, kg = tid & 7;
  const int bh = blockIdx.x / n_qt, b = bh / H, h = bh - b * H;
  const int q0 = (blockIdx.x - bh * n_qt) * F32_BQ;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_kv = (N + BK - 1) / BK;

  // K and V rows n0 .. n0 + BK - 1 into buffer buf (zero beyond N and D).
  auto load_kv = [&](int n0, int buf) {
    for (int i = tid; i < BK * DK / 4; i += THREADS) {
      const int r = i / (DK / 4), col = 4 * (i % (DK / 4));
      const bool ok = n0 + r < N && col < D;
      const long long off = ok ? (n0 + r) * sk.n + col : 0;
      const long long voff = ok ? (n0 + r) * sv.n + col : 0;
      cp_async16(smem_u32(Ks + (buf * BK + r) * QP + col), kb + off, ok ? 16 : 0);
      cp_async16(smem_u32(Vs + (buf * BK + r) * DK + col), vb + voff, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  load_kv(0, 0);
  for (int i = tid; i < F32_BQ * DK / 4; i += THREADS) {
    const int r = i / (DK / 4), col = 4 * (i % (DK / 4));
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < N && col < D) {
      val = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.n + col);
      val.x *= c;
      val.y *= c;
      val.z *= c;
      val.w *= c;
    }
    *reinterpret_cast<float4*>(Qs + r * QP + col) = val;
  }

  // Scores come out in the log2 domain (q is pre-scaled by c).
  float m[QPT], l[QPT], o[QPT][4 * U];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * U; ++e) o[i][e] = 0.0f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_kv) {
      load_kv((t + 1) * BK, buf ^ 1);  // its buffer was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) are in shared memory
    const float* Kt = Ks + buf * BK * QP;
    const float* Vt = Vs + buf * BK * DK;

    float s[QPT][KPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DK; d += 4) {
      float4 kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = *reinterpret_cast<const float4*>(Kt + (kg + 8 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (QPT * qg + i) * QP + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    if ((t + 1) * BK > N) {
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        if (t * BK + kg + 8 * j >= N)
#pragma unroll
          for (int i = 0; i < QPT; ++i) s[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float alpha = ex2(m[i] - mx);  // the tile holds a key < N: mx is finite
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = ex2(s[i][j] - mx);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 4 * U; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
#pragma unroll
      for (int i = 0; i < QPT; i += 4)
        *reinterpret_cast<float4*>(Ps + (kg + 8 * j) * PP + QPT * qg + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    __syncwarp();  // P of this warp's query groups is written

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[QPT];
#pragma unroll
      for (int i = 0; i < QPT; i += 4)
        *reinterpret_cast<float4*>(pr + i) = *reinterpret_cast<const float4*>(Ps + j * PP + QPT * qg + i);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(Vt + j * DK + 4 * kg + 32 * u);
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          o[i][4 * u] = fmaf(pr[i], vv.x, o[i][4 * u]);
          o[i][4 * u + 1] = fmaf(pr[i], vv.y, o[i][4 * u + 1]);
          o[i][4 * u + 2] = fmaf(pr[i], vv.z, o[i][4 * u + 2]);
          o[i][4 * u + 3] = fmaf(pr[i], vv.w, o[i][4 * u + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with buffer buf and with P
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + QPT * qg + i;
    if (row >= N) continue;
    const float r = 1.0f / li;
    float* ob = out + ((long long)bh * N + row) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = 4 * kg + 32 * u;  // D is a multiple of 8: col < D => col + 3 < D
      if (col < D)
        *reinterpret_cast<float4*>(ob + col) = make_float4(o[i][4 * u] * r, o[i][4 * u + 1] * r,
                                                           o[i][4 * u + 2] * r, o[i][4 * u + 3] * r);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry-point
// query, so the library links no -lcuda.  Null where libcuda lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d bf16 tensor map over k or v ((B, H, N, D), element strides s, unit
// d stride) whose box is `rows` tokens x 8 columns of one head.  Dimension 0
// is d; dimensions 1..3 are the token, head and batch dimensions sorted by
// stride, each of extent 1 last with the stride that spans those below it,
// since the encoder wants every stride to span the dimensions below it (the
// U-Net's qkv views have a head stride below the token stride).  *slots
// says where each went.
cudaError_t make_kv_map(CUtensorMap* map, TmaSlots* slots, const void* base, int B, int H, int N,
                        int D, Strides s, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    long long extent, stride;
    int* slot;
  } dims[3] = {{N, s.n, &slots->n}, {H, s.h, &slots->h}, {B, s.b, &slots->b}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0; --j) {
      const Dim &a = dims[j - 1], &b = dims[j];
      const bool later = (a.extent == 1) != (b.extent == 1) ? a.extent == 1 : a.stride > b.stride;
      if (!later) break;
      const Dim tmp = a;
      dims[j - 1] = b;
      dims[j] = tmp;
    }
  cuuint64_t extent[4] = {(cuuint64_t)D, 0, 0, 0}, stride[3];
  cuuint32_t box[4] = {8, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  cuuint64_t span = (cuuint64_t)D * 2;  // bytes; D is a multiple of 8
  for (int i = 0; i < 3; ++i) {
    extent[i + 1] = (cuuint64_t)dims[i].extent;
    stride[i] = dims[i].extent == 1 ? span : (cuuint64_t)dims[i].stride * 2;
    span = stride[i] * extent[i + 1];
    *dims[i].slot = i + 1;
  }
  box[slots->n] = (cuuint32_t)rows;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            extent, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One block per SM that can hold one (persistent over the work items).
template <int DK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int N, int D, Strides sq, Strides sk, Strides sv, float c,
                        cudaStream_t stream) {
  using G = Bf16Geometry<DK>;
  auto kernel = flash_attn_bf16_kernel<DK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, G::BYTES)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_qt = (N + BQ - 1) / BQ, total = n_qt * B * H;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = total < (long long)sms * per_sm ? total : (long long)sms * per_sm;
  CUtensorMap tmk, tmv;
  TmaSlots slk, slv;
  if ((err = make_kv_map(&tmk, &slk, k, B, H, N, D, sk, G::BKV)) != cudaSuccess ||
      (err = make_kv_map(&tmv, &slv, v, B, H, N, D, sv, G::BKV)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)blocks, THREADS, G::BYTES, stream>>>(
      static_cast<const bf16*>(q), tmk, tmv, static_cast<bf16*>(out), N, H, D, (int)n_qt,
      (int)total, sq, slk, slv, c);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int N, int D, Strides sq, Strides sk, Strides sv, float c,
                       cudaStream_t stream) {
  using G = F32Geometry<DK>;
  auto kernel = flash_attn_f32_kernel<DK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return err;
  const long long n_qt = (N + F32_BQ - 1) / F32_BQ, blocks = n_qt * B * H;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, G::THREADS, G::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, H, D, (int)n_qt, sq, sk, sv, c);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, N, D) with element strides s*_b, s*_h, s*_n and unit d
// stride; out: contiguous (B, H, N, D) in the inputs' type.  is_f32 != 0:
// f32 tensors, else bf16.  D is a multiple of 8 in [8, 128]; the pointers
// are 16-byte aligned and the strides are multiples of 16 bytes (the
// wrapper checks).  Returns cudaErrorInvalidValue for a D it does not take
// or more than 2^31 - 1 work items.
extern "C" int gt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int is_f32, int B, int H, int N, int D,
                                  long long sqb, long long sqh, long long sqn,
                                  long long skb, long long skh, long long skn,
                                  long long svb, long long svh, long long svn,
                                  void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (D < 8 || D > 128 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * N == 0) return (int)cudaSuccess;
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn};
  const float c = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(D)
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    if (D <= 32) return (int)launch_f32<32>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
    if (D <= 64) return (int)launch_f32<64>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
    return (int)launch_f32<128>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
  }
  if (D <= 16) return (int)launch_bf16<16>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
  if (D <= 32) return (int)launch_bf16<32>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
  if (D <= 64) return (int)launch_bf16<64>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
  return (int)launch_bf16<128>(q, k, v, out, B, H, N, D, sq, sk, sv, c, s);
}
