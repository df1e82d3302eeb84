// Hopper (sm_90a) kernels of the fused ResnetBlock conv chain:
//   conv3x3x3 -> GroupNorm -> FiLM -> SiLU -> conv3x3x3 -> GroupNorm -> SiLU.
//
// Replaces the Pallas TPU kernels of generative_turbulence_tpu/ops/pallas_kernels.py
// reached from fused_double_conv_block:
//   - _pad_flatten (replicate pad + row flattening)      -> clamped input addressing
//                                                            in conv3x3x3_stats_kernel
//   - _conv3x3_flat (_conv3x3_stats_kernel)               -> conv3x3x3_stats_kernel
//   - _affine_silu_repad (_affine_silu_repad_kernel)      -> the SILU_IN prologue of
//                                                            conv3x3x3_stats_kernel
//   - _affine_silu_std (_affine_silu_std_kernel)          -> affine_silu_kernel
// The GroupNorm + FiLM fold between them (_gn_affine) stays a few small torch ops.
// The same conv kernel with STATS = false replaces the standalone conv op
// conv3d_3x3 (_conv3d_3x3_pallas_raw, _conv3x3_kernel, and its _pad_flatten
// prep): no moments epilogue and no partials buffer, x read as bf16 or f32
// and rounded to bf16 at load, the f32 accumulator + bias written in x's type.
//
// What bounds them on the card.  At the engaged blocks (C, F in {32, 64, 128}
// over 194x50x50 or 97x25x25 voxels, batch 8) one conv is 0.2-1.7 TFLOP
// against 0.1-1 GB of bf16 activations: about 100-1000 FLOP per byte, so the
// convs are bound by tensor-core throughput.  affine_silu reads and writes
// each element once with a handful of FLOPs: it is bound by memory bandwidth.
//
// What the design does about it.  The conv is an implicit GEMM over
// channels-last activations: M = output voxels (64 per block), N = output
// channels (32/64/128 per block), K = 27 taps x C input channels, walked in
// steps of 32 channels of one tap.  bf16 operands go through the tensor
// cores (WMMA 16x16x16, f32 accumulation).  Replicate padding is a clamp of
// the input coordinate, so there is no pad pass and no halo copy; the
// optional prologue applies silu(a*x + b) to every loaded element, which is
// exact at the edges because clamping commutes with an elementwise map.  The
// epilogue writes bf16 output and (STATS) each block's per-channel sum and
// sum of squares of the f32 result; blocks run in no order, so the
// cross-block GroupNorm reduction is a second pass in torch with a fixed
// summation order.
// This is the simple first form: one smem stage, no cp.async/TMA/wgmma.
// affine_silu is one grid-stride elementwise pass.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;        // output voxels per block (4 warps x 16 rows)
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;  // smem row pitch of the A tile, in bf16

template <int BN>
struct Tile {
  static constexpr int B_LD = BN + 8;  // bf16
  static constexpr int C_LD = BN + 4;  // f32
  static constexpr int A_BYTES = BM * A_LD * 2;
  static constexpr int B_BYTES = BK * B_LD * 2;
  static constexpr int C_BYTES = BM * C_LD * 4;
  static constexpr int BYTES =
      (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }

// Eight consecutive channels (16-byte aligned) as bf16.
__device__ __forceinline__ void load8(const bf16* p, bf16 (&v)[8]) {
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
}
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

// One block: BM consecutive output voxels of one batch element x BN output
// channels.  grid = (ceil(S / BM), ceil(F / BN), B) with S = X*Y*Z.
// STATS: write the per-block channel moments (the chain's convs); without it
// the kernel is the plain conv + bias (conv3d_3x3).  In: x's type, rounded to
// bf16 at load; Out: the output's type.
template <int BN, bool SILU_IN, bool STATS, typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
conv3x3x3_stats_kernel(const In* __restrict__ x,        // (B, X, Y, Z, C)
                       const bf16* __restrict__ w,      // (3, 3, 3, C, F)
                       const float* __restrict__ bias,  // (F,)
                       const float* __restrict__ pro_a, // (B, C) if SILU_IN
                       const float* __restrict__ pro_b, // (B, C) if SILU_IN
                       Out* __restrict__ out,           // (B, X, Y, Z, F)
                       float* __restrict__ stats,       // (B, n_mt, 2, F) if STATS
                       int X, int Y, int Z, int C, int F) {
  using T = Tile<BN>;
  __shared__ __align__(128) unsigned char smem[T::BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + T::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int S = X * Y * Z;
  const int YZ = Y * Z;
  const int mt = blockIdx.x;
  const int n_mt = gridDim.x;
  const int m0 = mt * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const bool c_vec = (C % 8) == 0;
  const bool f_vec = (F % 8) == 0;

  const In* xb = x + (int64_t)b * S * C;

  // A loader: rows r and r + 32, 8 channels starting at 8 * q of the K step.
  const int q = tid & 3;
  int rx[2], ry[2], rz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = m0 + (tid >> 2) + 32 * i;
    m = m < S ? m : S - 1;  // rows past the end load a valid voxel, masked later
    rx[i] = m / YZ;
    ry[i] = (m / Z) % Y;
    rz[i] = m % Z;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int tap = 0; tap < 27; ++tap) {
    const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
    const In* src[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xs = clampi(rx[i] + dx, X - 1);
      const int ys = clampi(ry[i] + dy, Y - 1);
      const int zs = clampi(rz[i] + dz, Z - 1);
      src[i] = xb + ((int64_t)(xs * Y + ys) * Z + zs) * C;
    }
    for (int c0 = 0; c0 < C; c0 += BK) {
      // ---- A tile: BM voxels x BK channels, replicate pad by clamping ----
      const int c = c0 + 8 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        alignas(16) bf16 v[8];
        if (c_vec && c + 8 <= C) {
          load8(src[i] + c, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = (c + j < C) ? to_bf16(src[i][c + j]) : __float2bfloat16(0.0f);
        }
        if (SILU_IN) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < C) {
              const float a = pro_a[b * C + c + j];
              const float s = pro_b[b * C + c + j];
              v[j] = __float2bfloat16(silu(a * __bfloat162float(v[j]) + s));
            }
          }
        }
        *reinterpret_cast<uint4*>(As + ((tid >> 2) + 32 * i) * A_LD + 8 * q) =
            *reinterpret_cast<const uint4*>(v);
      }
      // ---- B tile: BK input channels x BN output channels of this tap ----
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int idx = tid + THREADS * i;
        const int kr = idx / (BN / 8);
        const int cq = idx % (BN / 8);
        const int ci = c0 + kr;
        const int n = n0 + 8 * cq;
        alignas(16) bf16 v[8];
        if (ci < C) {
          const bf16* wp = w + ((int64_t)tap * C + ci) * F + n;
          if (f_vec && n + 8 <= F) {
            *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(wp);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = (n + j < F) ? wp[j] : __float2bfloat16(0.0f);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(0.0f);
        }
        *reinterpret_cast<uint4*>(Bs + kr * T::B_LD + 8 * cq) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncthreads();
      // ---- tensor cores: warp computes rows 16*warp .. +15, all BN columns ----
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (16 * warp) * A_LD + ks, A_LD);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs + ks * T::B_LD + 16 * j, T::B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: bias, store in Out, per-block channel moments (STATS) ----
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(Cs + (16 * warp) * T::C_LD + 16 * j, acc[j], T::C_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, cc = idx % BN;
    const int n = n0 + cc, m = m0 + r;
    float v = Cs[r * T::C_LD + cc] + (n < F ? bias[n] : 0.0f);
    if (STATS) Cs[r * T::C_LD + cc] = v;
    if (m < S && n < F) out[((int64_t)b * S + m) * F + n] = from_float<Out>(v);
  }
  if (!STATS) return;
  __syncthreads();
  const int rows = (S - m0) < BM ? (S - m0) : BM;
  for (int cc = tid; cc < BN; cc += THREADS) {
    const int n = n0 + cc;
    if (n >= F) continue;
    float s = 0.0f, ss = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float v = Cs[r * T::C_LD + cc];
      s += v;
      ss += v * v;
    }
    float* st = stats + ((int64_t)b * n_mt + mt) * 2 * F;
    st[n] = s;
    st[F + n] = ss;
  }
}

// out = silu(a[b, f] * h + c[b, f]) over (B, S, F), written in Out.
template <typename Out>
__global__ void affine_silu_kernel(const bf16* __restrict__ h,
                                   const float* __restrict__ a,
                                   const float* __restrict__ c,
                                   Out* __restrict__ out,
                                   int64_t n_total, int64_t per_batch, int F) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_total;
       i += stride) {
    const int64_t k = (i / per_batch) * F + i % F;
    out[i] = from_float<Out>(silu(a[k] * __bfloat162float(h[i]) + c[k]));
  }
}

template <int BN, bool SILU_IN, bool STATS, typename In, typename Out>
void launch_conv(const void* x, const void* w, const void* bias, const void* pro_a,
                 const void* pro_b, void* out, void* stats, int B, int X, int Y,
                 int Z, int C, int F, cudaStream_t stream) {
  const int S = X * Y * Z;
  dim3 grid((S + BM - 1) / BM, (F + BN - 1) / BN, B);
  conv3x3x3_stats_kernel<BN, SILU_IN, STATS, In, Out><<<grid, THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(pro_a),
      static_cast<const float*>(pro_b), static_cast<Out*>(out),
      static_cast<float*>(stats), X, Y, Z, C, F);
}

// The output-channel tile BN follows F: 32, 64 or 128.
template <bool SILU_IN, bool STATS, typename In, typename Out>
void launch_conv_bn(const void* x, const void* w, const void* bias, const void* pro_a,
                    const void* pro_b, void* out, void* stats, int B, int X, int Y,
                    int Z, int C, int F, cudaStream_t s) {
  if (F <= 32)
    launch_conv<32, SILU_IN, STATS, In, Out>(x, w, bias, pro_a, pro_b, out, stats, B,
                                             X, Y, Z, C, F, s);
  else if (F <= 64)
    launch_conv<64, SILU_IN, STATS, In, Out>(x, w, bias, pro_a, pro_b, out, stats, B,
                                             X, Y, Z, C, F, s);
  else
    launch_conv<128, SILU_IN, STATS, In, Out>(x, w, bias, pro_a, pro_b, out, stats, B,
                                              X, Y, Z, C, F, s);
}

}  // namespace

extern "C" int gt_conv3x3x3_tile_m() { return BM; }

// Replicate-padded SAME 3x3x3 conv + bias with per-block channel moments.
// pro_a/pro_b: nullptr, or (B, C) f32 for the silu(a*x + b) input prologue.
// stats: (B, ceil(S/BM), 2, F) f32, row 0 = sum, row 1 = sum of squares.
extern "C" int gt_conv3x3x3_stats(const void* x, const void* w, const void* bias,
                                  const void* pro_a, const void* pro_b, void* out,
                                  void* stats, int B, int X, int Y, int Z, int C,
                                  int F, void* stream) {
  cudaGetLastError();  // start from a clean error state
  auto s = static_cast<cudaStream_t>(stream);
  if (pro_a != nullptr)
    launch_conv_bn<true, true, bf16, bf16>(x, w, bias, pro_a, pro_b, out, stats, B, X,
                                           Y, Z, C, F, s);
  else
    launch_conv_bn<false, true, bf16, bf16>(x, w, bias, pro_a, pro_b, out, stats, B, X,
                                            Y, Z, C, F, s);
  return (int)cudaGetLastError();
}

// Replicate-padded SAME 3x3x3 conv + bias without moments (conv3d_3x3).
// x_f32 != 0: x and out are f32, else bf16; w: (3, 3, 3, C, F) bf16; bias: (F,) f32.
extern "C" int gt_conv3d_3x3(const void* x, const void* w, const void* bias, void* out,
                             int x_f32, int B, int X, int Y, int Z, int C, int F,
                             void* stream) {
  cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    launch_conv_bn<false, false, float, float>(x, w, bias, nullptr, nullptr, out,
                                               nullptr, B, X, Y, Z, C, F, s);
  else
    launch_conv_bn<false, false, bf16, bf16>(x, w, bias, nullptr, nullptr, out,
                                             nullptr, B, X, Y, Z, C, F, s);
  return (int)cudaGetLastError();
}

// out_f32 != 0: out is f32, else bf16.  h: (B, S, F) bf16; a, c: (B, F) f32.
extern "C" int gt_affine_silu(const void* h, const void* a, const void* c, void* out,
                              int out_f32, int B, long long S, int F, void* stream) {
  cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t per_batch = (int64_t)S * F;
  const int64_t n_total = per_batch * B;
  const int threads = 256;
  int64_t blocks = (n_total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  auto* hp = static_cast<const bf16*>(h);
  auto* ap = static_cast<const float*>(a);
  auto* cp = static_cast<const float*>(c);
  if (out_f32)
    affine_silu_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        hp, ap, cp, static_cast<float*>(out), n_total, per_batch, F);
  else
    affine_silu_kernel<bf16><<<(unsigned)blocks, threads, 0, s>>>(
        hp, ap, cp, static_cast<bf16*>(out), n_total, per_batch, F);
  return (int)cudaGetLastError();
}
