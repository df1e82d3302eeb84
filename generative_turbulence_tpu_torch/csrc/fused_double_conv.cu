// Hopper (sm_90a) kernels of the fused ResnetBlock conv chain:
//   conv3x3x3 -> GroupNorm -> FiLM -> SiLU -> conv3x3x3 -> GroupNorm -> SiLU.
//
// Replaces the Pallas TPU kernels of generative_turbulence_tpu/ops/pallas_kernels.py
// reached from fused_double_conv_block:
//   - _pad_flatten (replicate pad + row flattening)      -> clamped halo staging
//                                                            in conv3x3x3_kernel
//   - _conv3x3_flat (_conv3x3_stats_kernel)               -> conv3x3x3_kernel
//   - _affine_silu_repad (_affine_silu_repad_kernel)      -> the SILU_IN prologue of
//                                                            conv3x3x3_kernel
//   - _affine_silu_std (_affine_silu_std_kernel)          -> affine_silu_kernel
// The GroupNorm + FiLM fold between them (_gn_affine) stays a few small torch ops.
// On the spatial axis (a grid-x slab per rank) the STATS conv takes its x halo
// from two plane pointers (HALO = true, the "halo variant"): a halo read at
// x = -1 or x = X takes the neighbour's plane, and only at a global x edge,
// where the pointer is null, does the clamp stay; with HALO = false the kernel
// is the one without the pointers.
// The same conv kernel with STATS = false replaces the standalone conv op
// conv3d_3x3 (_conv3d_3x3_pallas_raw, _conv3x3_kernel, and its _pad_flatten
// prep): no moments epilogue and no partials buffer, x read as bf16 or f32
// and rounded to bf16 as it is staged, the f32 accumulator + bias written in
// x's type.
//
// The conv is an implicit GEMM over channels-last activations: M = output
// voxels, N = output channels, K = 27 taps x C.  A block owns a brick of
// TX x TY x TZ = 8 x 4 x 8 output voxels (8 x 2 x 8 at BN = 128), one wgmma
// m64 tile per warpgroup, and BN output channels (32, 64 or 128); blocks are
// persistent and walk (batch, F tile, brick) work items.
//   - The input halo ((TX + 2) x (TY + 2) x (TZ + 2) voxels x KC channels) is
//     staged into shared memory once per work item with 16-byte cp.async
//     copies from clamped coordinates: clamping is the replicate pad, so
//     there is no pad pass.  C above KC = 64 is walked in chunks of KC; C
//     below is zero-filled to KC (32 or 64).  f32 input and C not a multiple
//     of 8 take a synchronous, converting, masked path.  The next item's
//     halo is staged into a second buffer while this item's taps run.
//   - SILU_IN applies bf16(silu(a*x + b)) to each staged element once, in
//     shared memory, spread between the taps' wgmmas, with a, b loaded once
//     per item: 2.3 silu per output element and channel instead of 27.
//     Exact at the edges, because clamping commutes with an elementwise map.
//   - The 27 taps run as wgmma m64nBNk16 with both operands in shared
//     memory.  A is read straight from the halo: it is stored as one plane
//     per 8 channels with one 16-byte row per voxel, so 8 consecutive voxels
//     along z are a core matrix, the 8 z lines of a warpgroup's tile lie one
//     halo x plane apart (the descriptor's stride), and a tap moves the
//     start address by whole rows.
//   - B, one tap's (KC, BN) weight slab, comes from a ring of 3-8 stages
//     that thread 0 fills with one TMA bulk copy per stage, tracked by
//     full/empty mbarriers.  The wrapper packs the weights once per call
//     into the exact shared-memory image of each stage (K-major 8x8 core
//     matrices, no swizzle), so each stage is one contiguous copy.
//   - The epilogue adds the bias to the accumulator registers, reduces the
//     per-channel moments of the f32 result with warp shuffles and one
//     shared-memory pass in a fixed order (STATS), and stores through a
//     shared-memory tile as 16-byte vectors.  Each block writes its bricks'
//     partial moments; torch sums them in a fixed order, so runs repeat bit
//     for bit.
//
// What bounds it on an H100 (batch 8, 194x50x50, 64 -> 64): the conv core
// runs at about 45% of the bf16 tensor peak, counting the rows of bricks
// that overhang Y and Z (about 20% at 50 x 50).  Each m64nBNk16 wgmma reads
// its A (2 KB) and its B (BN x 32 bytes) from shared memory, which at BN = 64
// asks for about as many bytes per clock as an SM's shared memory delivers;
// an extra read + write pass over the halo costs about 5%.  The SILU_IN
// prologue adds 13-17%: its shared-memory pass about a third, its
// conversions and FMAs the rest (the tanh itself costs nothing measurable).
// affine_silu is an elementwise pass bound by bytes (its note is below).
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

// The output brick of one block is TX x TY x TZ voxels: one y line of
// TX x TZ = 8 x 8 voxels (64 GEMM rows, one wgmma m64 tile) per consumer
// warpgroup, four warpgroups (TY = 4) up to BN = 64 and two (TY = 2) at
// BN = 128, where the 64 accumulators per thread leave registers for no
// more.  A warpgroup's tile rows are ordered (x, z): its eight 8-row core
// matrices are eight z lines one halo x plane apart, a constant stride, so
// wgmma reads A straight from the staged halo.
// ops/cuda_kernels.py::conv_brick holds the same shapes; the wrapper checks
// them against gt_conv3x3x3_brick when it loads the library.
constexpr int TX = 8, TZ = 8;

__host__ __device__ constexpr int warpgroups(int bn) { return bn == 128 ? 2 : 4; }

// One block: the brick, its threads, and its shared memory: two halo
// buffers of HBUF bytes (each also the epilogue's [output tile | moment
// partials]), the B ring, the mbarriers.  The ring takes what is left of
// the 227 KB of one block per SM, 2 to 8 stages.
template <int BN, int KC, typename Out>
struct Geometry {
  static constexpr int TY = warpgroups(BN);
  static constexpr int HY = TY + 2, HZ = TZ + 2;
  static constexpr int BM = TX * TY * TZ;           // GEMM rows
  static constexpr int HROWS = (TX + 2) * HY * HZ;  // halo voxels
  static constexpr int THREADS = 128 * TY;
  // The halo is KC / 8 planes, one per group of 8 channels, each holding
  // that group of every halo voxel as one 16-byte row: 8 consecutive halo
  // rows are one wgmma core matrix.  A plane is padded by 16 bytes, so the 8
  // groups of one voxel, which 8 neighbouring threads stage, fall on
  // distinct bank groups.
  static constexpr int PLANE = HROWS * 16 + 16;
  static constexpr int HALO_BYTES = KC / 8 * PLANE;
  static constexpr int TPS = KC == 32 ? 3 : 1;  // taps per ring stage
  static constexpr int STAGE_BYTES = TPS * KC * BN * 2;
  static constexpr int OUT_PITCH = BN + 16 / (int)sizeof(Out);  // elements
  static constexpr int TILE_BYTES = BM * OUT_PITCH * (int)sizeof(Out);
  static constexpr int EPI_BYTES = TILE_BYTES + 2 * (THREADS / 32) * BN * 4;
  static constexpr int HBUF =
      ((HALO_BYTES > EPI_BYTES ? HALO_BYTES : EPI_BYTES) + 127) / 128 * 128;
  static constexpr int FIT = (227 * 1024 - 2 * HBUF - 128) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static_assert(STAGES >= 2, "the B ring needs two stages");
  static constexpr int BAR_OFF = 2 * HBUF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// silu(2h) = h + h tanh(h) on the approximate tanh (one MUFU op, relative
// error about 2^-11), for the prologue, whose result is rounded to bf16:
// its error stays below that rounding except in the tail v < -2, where
// silu(v) is small and the absolute error is at most |v| 2^-12.
__device__ __forceinline__ float silu_half(float h) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }

// Eight consecutive f32 channels (16-byte aligned), rounded to bf16.
__device__ __forceinline__ void load8(const float* p, bf16 (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = __float2bfloat16(a.x); v[1] = __float2bfloat16(a.y);
  v[2] = __float2bfloat16(a.z); v[3] = __float2bfloat16(a.w);
  v[4] = __float2bfloat16(b.x); v[5] = __float2bfloat16(b.y);
  v[6] = __float2bfloat16(b.z); v[7] = __float2bfloat16(b.w);
}

template <typename Out>
__device__ __forceinline__ Out from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Two adjacent output channels into the shared-memory output tile.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
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

// TMA bulk copy of contiguous bytes, completion counted on the mbarrier.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before later reads by wgmma, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Keeps the compiler from touching the accumulators across the async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, K-major, no swizzle: core matrices of 8
// rows x 16 bytes (8 k values), start address addr; lbo bytes between the
// two k halves of a k16 slab, sbo bytes between successive groups of 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x N, f32) += A (64 x 16, bf16) * B (16 x N, bf16), both from shared
// memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

// ---- the conv ----------------------------------------------------------------

// Half the 8 prologue a, b of channels c .. c + 7 of batch element b, for
// silu_half (0 beyond C, which keeps the zero channels zero: silu(0) = 0).
__device__ __forceinline__ void load_prologue(float (&pa)[8], float (&pb)[8],
                                              const float* __restrict__ pro_a,
                                              const float* __restrict__ pro_b, int b, int c,
                                              int C) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j] = c + j < C ? 0.5f * pro_a[b * C + c + j] : 0.0f;
    pb[j] = c + j < C ? 0.5f * pro_b[b * C + c + j] : 0.0f;
  }
}

// Stage one unit's input halo (a brick's (TX + 2) x (TY + 2) x (TZ + 2)
// voxels, channels c0 .. c0 + KC - 1) into buf.  Clamped coordinates are the
// replicate pad; channels at and beyond C are zero.  HALO: x = -1 reads lob's
// plane and x = X hib's (this batch element's (Y, Z, C) planes) where they
// are not null.  bf16 vectors go by
// cp.async (committed here, waited for by the caller); f32 input and C not a
// multiple of 8 by a synchronous, converting, masked load.  A thread stages
// the vectors v = tid + k * THREADS, the same ones it passes through the
// prologue, so it needs its own cp.async wait and no barrier before that.
template <class G, int KC, bool HALO, typename In>
__device__ __forceinline__ void stage_halo(unsigned char* buf, const In* __restrict__ xb,
                                           const In* __restrict__ lob, const In* __restrict__ hib,
                                           int x0, int y0, int z0, int c0, int X, int Y, int Z,
                                           int C, int tid) {
  constexpr int VPR = KC / 8;  // 16-byte vectors per halo voxel
  const bool c_vec = (C % 8) == 0;
  for (int v = tid; v < G::HROWS * VPR; v += G::THREADS) {
    const int hr = v / VPR, cv = v % VPR;
    const int rx = x0 + hr / (G::HY * G::HZ) - 1;
    const int gx = clampi(rx, X - 1);
    const int gy = clampi(y0 + hr / G::HZ % G::HY - 1, Y - 1);
    const int gz = clampi(z0 + hr % G::HZ - 1, Z - 1);
    const int c = c0 + 8 * cv;
    const In* src = xb + ((int64_t)(gx * Y + gy) * Z + gz) * C + c;
    if (HALO && rx < 0 && lob != nullptr) src = lob + ((int64_t)gy * Z + gz) * C + c;
    if (HALO && rx >= X && hib != nullptr) src = hib + ((int64_t)gy * Z + gz) * C + c;
    unsigned char* dst = buf + cv * G::PLANE + hr * 16;
    alignas(16) bf16 v8[8];
    if (c_vec && c < C) {
      if constexpr (std::is_same<In, bf16>::value) {
        cp_async16(smem_u32(dst), src);
        continue;
      } else {
        load8(src, v8);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v8[j] = c + j < C ? to_bf16(src[j]) : __float2bfloat16(0.0f);
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v8);
  }
  cp_async_commit();
}

// The prologue on this thread's own staged vectors k0 .. k1 - 1:
// bf16(silu(a*x + b)), as the TPU repad kernel rounds it; pa, pb hold a/2,
// b/2.  THREADS is a multiple of KC / 8, so all of a thread's vectors hold
// the same 8 channels.
template <class G, int KC>
__device__ __forceinline__ void prologue(unsigned char* buf, const float (&pa)[8],
                                         const float (&pb)[8], int tid, int k0, int k1) {
  constexpr int VPR = KC / 8;
  for (int k = k0; k < k1; ++k) {
    const int v = tid + k * G::THREADS;
    if (v >= G::HROWS * VPR) break;
    uint4* p = reinterpret_cast<uint4*>(buf + v % VPR * G::PLANE + v / VPR * 16);
    alignas(16) bf16 v8[8];
    *reinterpret_cast<uint4*>(v8) = *p;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v8[j] = __float2bfloat16(silu_half(fmaf(pa[j], __bfloat162float(v8[j]), pb[j])));
    *p = *reinterpret_cast<const uint4*>(v8);
  }
}

// A work item: one brick of output voxels x BN output channels (F tile ft)
// of batch element b; consecutive items are neighbouring bricks.
template <class G>
struct Work {
  int b, ft, brick, x0, y0, z0;
  __device__ Work(int w, int nby, int nbz, int n_bricks, int n_ft) {
    b = w / (n_ft * n_bricks);
    ft = w / n_bricks % n_ft;
    brick = w % n_bricks;
    x0 = brick / (nby * nbz) * TX;
    y0 = brick / nbz % nby * G::TY;
    z0 = brick % nbz * TZ;
  }
};

// Persistent: each block walks the work items blockIdx.x, + gridDim.x, ...,
// each in units of one C chunk (KC channels).  grid.x = the blocks that fit
// on the card at once.  wpack: the weights packed by
// ops/cuda_kernels.py::pack_conv_weights for this (BN, KC): for each F tile,
// C chunk and group of TPS taps, one STAGE_BYTES image of a B ring stage.
// STATS: write each brick's channel sums and sums of squares of the f32
// result to stats (B, n_bricks, 2, F).  In: x's type; Out: the output's type.
//
// While a unit's taps run, the next unit's halo is staged into the other
// buffer by cp.async and passed through the prologue between the wgmmas;
// thread 0 keeps the B ring filled by TMA bulk copies; the epilogue reuses
// the computed unit's buffer as its output tile.
template <int BN, int KC, bool SILU_IN, bool STATS, bool HALO, typename In, typename Out>
__global__ void __launch_bounds__(Geometry<BN, KC, Out>::THREADS, 1)
conv3x3x3_kernel(const In* __restrict__ x,         // (B, X, Y, Z, C)
                 const In* __restrict__ lo,        // (B, 1, Y, Z, C) or null if HALO
                 const In* __restrict__ hi,        // (B, 1, Y, Z, C) or null if HALO
                 const bf16* __restrict__ wpack,   // packed (3, 3, 3, C, F)
                 const float* __restrict__ bias,   // (F,)
                 const float* __restrict__ pro_a,  // (B, C) if SILU_IN
                 const float* __restrict__ pro_b,  // (B, C) if SILU_IN
                 Out* __restrict__ out,            // (B, X, Y, Z, F)
                 float* __restrict__ stats,        // (B, n_bricks, 2, F) if STATS
                 int B, int X, int Y, int Z, int C, int F) {
  using G = Geometry<BN, KC, Out>;
  constexpr int TY = G::TY, HY = G::HY, HZ = G::HZ;
  constexpr int THREADS = G::THREADS, WARPS = THREADS / 32, STAGES = G::STAGES, TPS = G::TPS;
  constexpr int K16 = KC / 16;
  constexpr int SPU = 27 / TPS;  // ring stages per unit
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem + 2 * G::HBUF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // this warpgroup's brick line: y = wg
  const int nby = (Y + TY - 1) / TY, nbz = (Z + TZ - 1) / TZ;
  const int n_bricks = (X + TX - 1) / TX * nby * nbz;
  const int n_ft = (F + BN - 1) / BN;
  const int n_ch = (C + KC - 1) / KC;
  const int total = B * n_ft * n_bricks;
  const int per_item = n_ch * SPU;  // ring stages per work item
  const int n_loads = (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * per_item;

  // The B ring's loader, run by thread 0: load ld (this block's ld-th stage
  // image, in the order the warps take them) goes to slot ld_slot once
  // every warp has released the load before it in that slot.  Its cursor
  // moves by additions; only a new work item costs a division.
  auto images = [&](int w) {
    return reinterpret_cast<const unsigned char*>(wpack) +
           (int64_t)(w / n_bricks % n_ft) * per_item * G::STAGE_BYTES;
  };
  int ld = 0, ld_slot = 0, ld_round = 0, ld_j = 0, ld_w = blockIdx.x;
  const unsigned char* ld_item = images(ld_w);
  auto issue_next = [&]() {
    if (ld_round > 0) mbar_wait(empty + ld_slot, (ld_round - 1) & 1);
    mbar_expect_tx(full + ld_slot, G::STAGE_BYTES);
    bulk_copy_g2s(ring + ld_slot * G::STAGE_BYTES, ld_item + (int64_t)ld_j * G::STAGE_BYTES,
                  G::STAGE_BYTES, full + ld_slot);
    ++ld;
    if (++ld_slot == STAGES) {
      ld_slot = 0;
      ++ld_round;
    }
    if (++ld_j == per_item) {
      ld_j = 0;
      ld_w += gridDim.x;
      if (ld_w < total) ld_item = images(ld_w);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    while (ld < STAGES && ld < n_loads) issue_next();
  }
  __syncthreads();

  const int64_t BC = (int64_t)X * Y * Z * C;  // elements of x per batch element
  const int64_t PC = (int64_t)Y * Z * C;      // elements of a halo plane
  auto lo_of = [&](int b) { return HALO && lo != nullptr ? lo + b * PC : nullptr; };
  auto hi_of = [&](int b) { return HALO && hi != nullptr ? hi + b * PC : nullptr; };
  constexpr int NV = (G::HROWS * (KC / 8) + THREADS - 1) / THREADS;  // own vectors
  constexpr int P0 = 9;  // the prologue runs between taps P0 .. 26

  // This warpgroup's A at the centre tap: row 8 i + z of its m64 tile is
  // brick voxel (i, wg, z), halo row ((i + 1) HY + wg + 1) HZ + z + 1, so
  // core matrix i lies HY HZ rows after core matrix i - 1, and the second 8
  // channels of a k16 slab one plane further.  A tap shifts the start by
  // whole rows (16 bytes each).
  const int a_row = (HY + wg + 1) * HZ + 1;

  float acc[BN / 2];
  float pa[8], pb[8];  // the prologue's a/2, b/2 for the staged unit
  int w = blockIdx.x, ch = 0, cur = 0;
  // The warps' ring cursor: stages taken (cs), the slot and phase of the
  // next one, and the slot of the oldest stage not yet released.
  int cs = 0, cs_slot = 0, rel_slot = 0;
  uint32_t cs_phase = 0;
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty + rel_slot);
    if (++rel_slot == STAGES) rel_slot = 0;
  };
  {
    const Work<G> first(w, nby, nbz, n_bricks, n_ft);
    stage_halo<G, KC, HALO>(smem, x + first.b * BC, lo_of(first.b), hi_of(first.b), first.x0,
                            first.y0, first.z0, 0, X, Y, Z, C, tid);
    cp_async_wait_all();
    if (SILU_IN) {
      load_prologue(pa, pb, pro_a, pro_b, first.b, 8 * (tid % (KC / 8)), C);
      prologue<G, KC>(smem, pa, pb, tid, 0, NV);
    }
    fence_proxy_async();
    __syncthreads();
  }
  while (true) {
    const Work<G> wk(w, nby, nbz, n_bricks, n_ft);
    unsigned char* buf = smem + cur * G::HBUF;
    unsigned char* nbuf = smem + (cur ^ 1) * G::HBUF;
    // Stage the next unit into the other buffer; its copies land, and its
    // prologue runs, while this unit's wgmmas do.
    int nw = w, nch = ch + 1;
    if (nch == n_ch) {
      nch = 0;
      nw += gridDim.x;
    }
    const bool has_next = nw < total;
    if (has_next) {
      const Work<G> nx(nw, nby, nbz, n_bricks, n_ft);
      stage_halo<G, KC, HALO>(nbuf, x + nx.b * BC, lo_of(nx.b), hi_of(nx.b), nx.x0, nx.y0, nx.z0,
                              nch * KC, X, Y, Z, C, tid);
      if (SILU_IN) load_prologue(pa, pb, pro_a, pro_b, nx.b, nch * KC + 8 * (tid % (KC / 8)), C);
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    }

    // One tap per wgmma group, two groups in flight: tap t's group is
    // issued, the next unit's prologue takes its share, then tap t - 1's
    // group is waited for, which at the end of a ring stage frees the stage.
    const uint64_t a_desc = desc(smem_u32(buf) + a_row * 16, G::PLANE, HY * HZ * 16);
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      if (t % TPS == 0) {
        // Thread 0 waits only for slots its own warp has released: all the
        // stages it took but the last.
        if (tid == 0 && ld < n_loads && ld <= cs + STAGES - 2) issue_next();
        mbar_wait(full + cs_slot, cs_phase);
        __syncwarp();  // the waits diverge; wgmma needs the warp converged
      }
      const int shift = ((t / 9 - 1) * HY + t / 3 % 3 - 1) * HZ + t % 3 - 1;  // halo rows
      const uint64_t b_desc =
          desc(ring + cs_slot * G::STAGE_BYTES + t % TPS * K16 * BN * 32, 128, 256);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < K16; ++k)
        Wgmma<BN>::mma(acc, a_desc + shift + k * (2 * G::PLANE / 16), b_desc + k * (BN * 32 / 16));
      wgmma_commit();
      if (t % TPS == TPS - 1) {
        ++cs;
        if (++cs_slot == STAGES) {
          cs_slot = 0;
          cs_phase ^= 1;
        }
      }
      // The next unit's prologue, spread evenly over taps P0 .. 26.
      if (SILU_IN && t >= P0 && has_next) {
        if (t == P0) cp_async_wait_all();
        prologue<G, KC>(nbuf, pa, pb, tid, (t - P0) * NV / (27 - P0), (t - P0 + 1) * NV / (27 - P0));
      }
      wgmma_wait<1>();  // tap t - 1 is done
      if (t > 0 && (t - 1) % TPS == TPS - 1) release();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release();  // the stage of tap 26
    cp_async_wait_all();
    fence_proxy_async();  // the next unit's halo is read by wgmma
    __syncthreads();      // buf is read; the next unit is staged in nbuf

    if (ch == n_ch - 1) {
      // ---- epilogue: bias, moments (STATS), store through buf as a tile ----
      const int n0 = wk.ft * BN;
      Out* tile = reinterpret_cast<Out*>(buf);
      float* red = reinterpret_cast<float*>(buf + G::TILE_BYTES);  // [2][WARPS][BN]
      const int g = lane >> 2, q = lane & 3;
      // This lane's accumulator rows 16 (warp % 4) + g and + 8 of the
      // warpgroup's tile: brick voxels (2 (warp % 4) + h, wg, g), h = 0, 1;
      // the output tile's rows are ordered (x, y, z) with z fastest.
      int row[2];
      bool valid[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bx = 2 * (warp & 3) + h;
        row[h] = (bx * TY + wg) * TZ + g;
        valid[h] = wk.x0 + bx < X && wk.y0 + wg < Y && wk.z0 + g < Z;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float b0 = n0 + col < F ? bias[n0 + col] : 0.0f;
        const float b1 = n0 + col + 1 < F ? bias[n0 + col + 1] : 0.0f;
        // acc[4j], acc[4j + 1]: row[0]; acc[4j + 2], acc[4j + 3]: row[1].
        acc[4 * j] += b0;
        acc[4 * j + 1] += b1;
        acc[4 * j + 2] += b0;
        acc[4 * j + 3] += b1;
        store_pair(tile + row[0] * G::OUT_PITCH + col, acc[4 * j], acc[4 * j + 1]);
        store_pair(tile + row[1] * G::OUT_PITCH + col, acc[4 * j + 2], acc[4 * j + 3]);
        if (STATS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lo = valid[0] ? acc[4 * j + e] : 0.0f;
            const float hi = valid[1] ? acc[4 * j + 2 + e] : 0.0f;
            float s = lo + hi, ss = lo * lo + hi * hi;
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s += __shfl_xor_sync(0xffffffffu, s, m);
              ss += __shfl_xor_sync(0xffffffffu, ss, m);
            }
            if (g == 0) {
              red[warp * BN + col + e] = s;
              red[(WARPS + warp) * BN + col + e] = ss;
            }
          }
        }
      }
      __syncthreads();
      constexpr int VEC = 16 / (int)sizeof(Out);
      const int64_t S = (int64_t)X * Y * Z;
      for (int v = tid; v < G::BM * BN / VEC; v += THREADS) {
        const int r = v / (BN / VEC);
        const int n = n0 + v % (BN / VEC) * VEC;
        const int gx = wk.x0 + r / (TY * TZ), gy = wk.y0 + r / TZ % TY, gz = wk.z0 + r % TZ;
        if (gx >= X || gy >= Y || gz >= Z || n >= F) continue;
        Out* dst = out + (wk.b * S + (gx * Y + gy) * Z + gz) * F + n;
        const Out* src = tile + r * G::OUT_PITCH + (n - n0);
        if (F % VEC == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < VEC && n + j < F; ++j) dst[j] = src[j];
        }
      }
      if (STATS && tid < BN && n0 + tid < F) {
        float s = 0.0f, ss = 0.0f;
        for (int k = 0; k < WARPS; ++k) {
          s += red[k * BN + tid];
          ss += red[(WARPS + k) * BN + tid];
        }
        float* st = stats + ((int64_t)wk.b * n_bricks + wk.brick) * 2 * F;
        st[n0 + tid] = s;
        st[F + n0 + tid] = ss;
      }
      __syncthreads();  // buf is staged into again by the unit after next
    }
    if (!has_next) break;
    w = nw;
    ch = nch;
    cur ^= 1;
  }
}

// out = silu(a[b, f] * h + c[b, f]) over (B, S, F), written in Out.
//
// Replaces the Pallas TPU kernel _affine_silu_std (_affine_silu_std_kernel,
// generative_turbulence_tpu/ops/pallas_kernels.py:588): the second GroupNorm
// + SiLU of the chain, written in the block's output type.
//
// What bounds it on an H100: bytes.  At u_net.down_0 (8 x 194x50x50 x 64)
// it reads 62 MB of bf16 h and writes 62 MB, 0.296 ms at 3.35 TB/s; its
// 31 M exponentials take 8 us of the MUFU.  So the math stays silu's expf
// (no tanh.approx): the f32 output of the f32 eval path keeps its accuracy
// at no cost in time.
//
// What the design does about it.  blockIdx.y is the batch element, so a and
// c are indexed without a 64-bit division; each thread step moves 8
// channels: one 16-byte load of h, two float4 loads each of a and c (from
// L1: B x F floats in all), one 16-byte store (two for f32 output).  A
// thread takes UNROLL steps, their loads issued before any math, so that
// 2,048 threads x 64 bytes are in flight per SM.  F not a multiple of 8
// (the vectors would straddle voxels and lose their alignment) takes a
// scalar path through the same steps.  per_batch = S * F is below
// 2^31 - SILU_UNROLL * SILU_THREADS * 8, so no 32-bit offset of a block's
// last steps overflows (gt_affine_silu checks).
constexpr int SILU_THREADS = 256, SILU_UNROLL = 4;

template <typename Out>
__device__ __forceinline__ void store8(Out* dst, const float (&y)[8]);
template <>
__device__ __forceinline__ void store8<bf16>(bf16* dst, const float (&y)[8]) {
  alignas(16) bf16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(y[j]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&y)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

template <typename Out>
__global__ void __launch_bounds__(SILU_THREADS)
affine_silu_kernel(const bf16* __restrict__ h, const float* __restrict__ a,
                   const float* __restrict__ c, Out* __restrict__ out, int per_batch, int F) {
  const int64_t base = (int64_t)blockIdx.y * per_batch;
  const bf16* hb = h + base;
  Out* ob = out + base;
  const float* ab = a + blockIdx.y * F;
  const float* cb = c + blockIdx.y * F;
  // Step u of this thread covers elements e .. e + 7 of the batch element.
  const int e0 = (blockIdx.x * SILU_UNROLL * SILU_THREADS + threadIdx.x) * 8;
  constexpr int STEP = SILU_THREADS * 8;
  if (F % 8 == 0) {  // then per_batch % 8 == 0: a step is all in or all out
    uint4 hv[SILU_UNROLL];
#pragma unroll
    for (int u = 0; u < SILU_UNROLL; ++u)
      if (e0 + u * STEP < per_batch) hv[u] = *reinterpret_cast<const uint4*>(hb + e0 + u * STEP);
#pragma unroll
    for (int u = 0; u < SILU_UNROLL; ++u) {
      const int e = e0 + u * STEP;
      if (e >= per_batch) break;
      const int f = e % F;
      const float4 a0 = *reinterpret_cast<const float4*>(ab + f);
      const float4 a1 = *reinterpret_cast<const float4*>(ab + f + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(cb + f);
      const float4 c1 = *reinterpret_cast<const float4*>(cb + f + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const bf16* x = reinterpret_cast<const bf16*>(&hv[u]);
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = silu(av[j] * __bfloat162float(x[j]) + cv[j]);
      store8<Out>(ob + e, y);
    }
  } else {
#pragma unroll
    for (int u = 0; u < SILU_UNROLL; ++u) {
      const int e = e0 + u * STEP;
      int f = e % F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (e + j >= per_batch) break;
        ob[e + j] = from_float<Out>(silu(ab[f] * __bfloat162float(hb[e + j]) + cb[f]));
        if (++f == F) f = 0;
      }
    }
  }
}

template <int BN, int KC, bool SILU_IN, bool STATS, bool HALO, typename In, typename Out>
cudaError_t launch_conv(const void* x, const void* lo, const void* hi, const void* w,
                        const void* bias, const void* pro_a, const void* pro_b, void* out,
                        void* stats, int B, int X, int Y, int Z, int C, int F,
                        cudaStream_t stream) {
  using G = Geometry<BN, KC, Out>;
  auto kernel = conv3x3x3_kernel<BN, KC, SILU_IN, STATS, HALO, In, Out>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::THREADS,
                                                            G::BYTES)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_bricks =
      (int64_t)((X + TX - 1) / TX) * ((Y + G::TY - 1) / G::TY) * ((Z + TZ - 1) / TZ);
  const int64_t total = n_bricks * ((F + BN - 1) / BN) * B;
  if (total >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  const int blocks = (int)(total < (int64_t)sms * per_sm ? total : (int64_t)sms * per_sm);
  kernel<<<blocks, G::THREADS, G::BYTES, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(lo), static_cast<const In*>(hi),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(pro_a), static_cast<const float*>(pro_b), static_cast<Out*>(out),
      static_cast<float*>(stats), B, X, Y, Z, C, F);
  return cudaGetLastError();
}

// (bn, kc) as ops/cuda_kernels.py::conv_tiling chose them and packed w for.
template <bool SILU_IN, bool STATS, bool HALO, typename In, typename Out>
cudaError_t launch_conv_tiled(int bn, int kc, const void* x, const void* lo, const void* hi,
                              const void* w, const void* bias, const void* pro_a,
                              const void* pro_b, void* out, void* stats, int B, int X, int Y,
                              int Z, int C, int F, cudaStream_t s) {
#define GT_CONV_CASE(BN_, KC_)                                                               \
  if (bn == BN_ && kc == KC_)                                                                \
    return launch_conv<BN_, KC_, SILU_IN, STATS, HALO, In, Out>(x, lo, hi, w, bias, pro_a,   \
                                                                pro_b, out, stats, B, X, Y, \
                                                                Z, C, F, s);
  GT_CONV_CASE(32, 32)
  GT_CONV_CASE(64, 32)
  GT_CONV_CASE(128, 32)
  GT_CONV_CASE(32, 64)
  GT_CONV_CASE(64, 64)
  GT_CONV_CASE(128, 64)
#undef GT_CONV_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The output brick (x, y, z) of one block of the conv at output tile bn.
extern "C" void gt_conv3x3x3_brick(int bn, int* xyz) {
  xyz[0] = TX;
  xyz[1] = warpgroups(bn);
  xyz[2] = TZ;
}

// Replicate-padded SAME 3x3x3 conv + bias with per-brick channel moments.
// w: pack_conv_weights(w, bn, kc); pro_a/pro_b: nullptr, or (B, C) f32 for
// the silu(a*x + b) input prologue; stats: (B, n_bricks, 2, F) f32, row 0 =
// sum, row 1 = sum of squares.  lo/hi: nullptr, or the (B, 1, Y, Z, C) bf16
// planes before and after x along grid-x (the halo variant, if either is
// set; the prologue maps them too).
extern "C" int gt_conv3x3x3_stats(const void* x, const void* lo, const void* hi, const void* w,
                                  const void* bias, const void* pro_a, const void* pro_b,
                                  void* out, void* stats, int B, int X, int Y, int Z, int C,
                                  int F, int bn, int kc, void* stream) {
  cudaGetLastError();  // start from a clean error state
  auto s = static_cast<cudaStream_t>(stream);
  const bool halo = lo != nullptr || hi != nullptr;
#define GT_STATS_CASE(SILU_IN_, HALO_)                                                        \
  if ((pro_a != nullptr) == SILU_IN_ && halo == HALO_)                                      \
    return (int)launch_conv_tiled<SILU_IN_, true, HALO_, bf16, bf16>(                       \
        bn, kc, x, lo, hi, w, bias, pro_a, pro_b, out, stats, B, X, Y, Z, C, F, s);
  GT_STATS_CASE(true, false)
  GT_STATS_CASE(false, false)
  GT_STATS_CASE(true, true)
  GT_STATS_CASE(false, true)
#undef GT_STATS_CASE
  return (int)cudaErrorInvalidValue;
}

// Replicate-padded SAME 3x3x3 conv + bias without moments (conv3d_3x3).
// x_f32 != 0: x and out are f32, else bf16; w: pack_conv_weights(w, bn, kc);
// bias: (F,) f32.
extern "C" int gt_conv3d_3x3(const void* x, const void* w, const void* bias, void* out,
                             int x_f32, int B, int X, int Y, int Z, int C, int F, int bn,
                             int kc, void* stream) {
  cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return (int)launch_conv_tiled<false, false, false, float, float>(
        bn, kc, x, nullptr, nullptr, w, bias, nullptr, nullptr, out, nullptr, B, X, Y, Z, C, F, s);
  return (int)launch_conv_tiled<false, false, false, bf16, bf16>(
      bn, kc, x, nullptr, nullptr, w, bias, nullptr, nullptr, out, nullptr, B, X, Y, Z, C, F, s);
}

// out_f32 != 0: out is f32, else bf16.  h: (B, S, F) bf16; a, c: (B, F) f32;
// all 16-byte aligned.  Returns cudaErrorInvalidValue unless
// S * F < 2^31 - SILU_UNROLL * SILU_THREADS * 8 and B < 65536 (the grid's y
// extent); launches nothing when S * F or B is 0.
extern "C" int gt_affine_silu(const void* h, const void* a, const void* c, void* out,
                              int out_f32, int B, long long S, int F, void* stream) {
  cudaGetLastError();
  const long long per_batch = S * F;
  if (per_batch >= (1LL << 31) - SILU_UNROLL * SILU_THREADS * 8 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (per_batch == 0 || B == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  constexpr long long per_block = SILU_UNROLL * SILU_THREADS * 8;
  const dim3 grid((unsigned)((per_batch + per_block - 1) / per_block), (unsigned)B);
  auto* hp = static_cast<const bf16*>(h);
  auto* ap = static_cast<const float*>(a);
  auto* cp = static_cast<const float*>(c);
  if (out_f32)
    affine_silu_kernel<float><<<grid, SILU_THREADS, 0, s>>>(hp, ap, cp, static_cast<float*>(out),
                                                            (int)per_batch, F);
  else
    affine_silu_kernel<bf16><<<grid, SILU_THREADS, 0, s>>>(hp, ap, cp, static_cast<bf16*>(out),
                                                           (int)per_batch, F);
  return (int)cudaGetLastError();
}
