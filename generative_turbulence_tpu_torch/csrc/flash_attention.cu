// Hopper (sm_90a) flash attention: softmax(q k^T / sqrt(D)) v over
// (B, H, N, D) tokens, with the online softmax over K/V tiles.
//
// Replaces the Pallas TPU kernel flash_attention of
// generative_turbulence_tpu/ops/pallas_kernels.py:49-146 (_flash_kernel and
// its wrapper).  The TPU kernel pads a ragged N with a -1e9 key-bias
// channel; here keys >= N are masked to -inf in the scores instead, and
// queries >= N are neither loaded nor stored.
//
// What bounds it on the card.  At the path shape (the 2-level U-Net's
// bottleneck: B=8, H=4, N=6912, D=32) one call is 4*B*H*N^2*D = 195.7 GFLOP
// over about 57 MB of bf16 q, k, v and out: some 3,400 FLOP per byte, so it
// is bound by arithmetic, never by memory.  The plain version writes the
// (B, H, N, N) f32 score matrix, 6.1 GB, and reads it back several times.
//
// What the design does about it.  One block per (b*h, tile of 64 queries);
// a loop over K/V tiles staged in shared memory; the running max, sum and
// output accumulator live in f32 registers, so no score leaves the SM.
//   - bf16 (flash_attn_bf16_kernel): 4 warps x 16 query rows.  Both products
//     run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate).
//     The f32 scores stay in the accumulator fragments; the softmax works on
//     them in registers (row max and sum across the 4 lanes of a quad), and
//     the probabilities are rounded to bf16 to feed p.v on the tensor cores
//     from those same registers.  That rounding of p is the one rounding the
//     TPU kernel (f32 p.v at HIGHEST precision) does not make; the row sum l
//     is taken over the unrounded f32 p.  V is stored transposed in shared
//     memory so each B fragment is one 32-bit load.
//   - f32 (flash_attn_f32_kernel): full f32 FMA, never TF32 (the JAX kernel
//     runs its matmuls at HIGHEST precision and TF32 would miss the f32
//     tolerance).  One thread per query row holds q and the accumulator in
//     registers and reads K/V from shared memory as broadcasts; keys are
//     folded into the online softmax 16 at a time.
// Both kernels take the inputs' batch, head and token strides (the last
// stride must be 1), so the (B, N, 3, H, D) qkv views of the U-Net need no
// copy.  This is the simple first form: one shared-memory stage, no
// cp.async/TMA, no wgmma, no warp specialisation.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per K/V tile (bf16)
constexpr int BKV_F32 = 32;  // keys per K/V tile (f32)
constexpr int KCHUNK = 16;   // keys per online-softmax update (f32)

struct Strides {
  long long b, h, n;  // in elements; the d stride is 1
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// DK: D rounded up to a multiple of 16 (the mma depth); columns D..DK-1 are
// zero in shared memory and contribute nothing.
template <int DK>
__global__ void __launch_bounds__(128)
flash_attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int N, int H, int D, Strides sq, Strides sk, Strides sv,
                       float scale_log2) {
  constexpr int KP = DK + 8;   // row pitch of the K (and Q staging) tile, bf16
  constexpr int VP = BKV + 8;  // row pitch of the transposed V tile, bf16
  constexpr int DV = DK / 8;   // 8-column output tiles
  __shared__ __align__(16) bf16 Ks[BKV * KP];
  __shared__ __align__(16) bf16 Vt[DK * VP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // ---- Q tile, staged through the K buffer into A fragments ----
  for (int idx = tid; idx < BQ * DK / 8; idx += 128) {
    const int r = idx / (DK / 8), c = (idx % (DK / 8)) * 8;
    const int n = q0 + r;
    uint4 val = zero;
    if (n < N && c < D) val = *reinterpret_cast<const uint4*>(qb + n * sq.n + c);
    *reinterpret_cast<uint4*>(Ks + r * KP + c) = val;
  }
  __syncthreads();
  const int row0 = warp * 16;
  uint32_t qf[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    qf[kk][0] = ld_u32(Ks + (row0 + g) * KP + 16 * kk + 2 * t);
    qf[kk][1] = ld_u32(Ks + (row0 + g + 8) * KP + 16 * kk + 2 * t);
    qf[kk][2] = ld_u32(Ks + (row0 + g) * KP + 16 * kk + 8 + 2 * t);
    qf[kk][3] = ld_u32(Ks + (row0 + g + 8) * KP + 16 * kk + 8 + 2 * t);
  }

  // Rows g and g + 8 of the warp's 16: running max (log2 domain), this
  // lane's share of the running sum, and the output accumulator.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[DV][4];
#pragma unroll
  for (int j = 0; j < DV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += BKV) {
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    for (int idx = tid; idx < BKV * DK / 8; idx += 128) {
      const int r = idx / (DK / 8), c = (idx % (DK / 8)) * 8;
      const int n = n0 + r;
      uint4 kv = zero, vv = zero;
      if (n < N && c < D) {
        kv = *reinterpret_cast<const uint4*>(kb + n * sk.n + c);
        vv = *reinterpret_cast<const uint4*>(vb + n * sv.n + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * KP + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VP + r] = ve[j];
    }
    __syncthreads();

    // ---- S = Q K^T: 16 rows x 64 keys per warp, 8 tiles of 8 keys ----
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const bf16* kr = Ks + (nt * 8 + g) * KP + 16 * kk + 2 * t;
        mma_bf16_16816(s[nt], qf[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // ---- online softmax on the fragments (log2 domain) ----
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = n < N ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds at least one key < N, so mx0, mx1 are finite here.
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // ---- O += P V: the score fragments of key tiles 2ks, 2ks+1 are the A
    // fragment of k-step ks ----
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const bf16* vr = Vt + (j * 8 + g) * VP + 16 * ks + 2 * t;
        mma_bf16_16816(o[j], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  // ---- epilogue: the quad's partial sums, then out = o / l ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.0f / l0, r1 = 1.0f / l1;
  const int n_a = q0 + row0 + g, n_b = n_a + 8;
  bf16* ob = out + (long long)bh * N * D;
#pragma unroll
  for (int j = 0; j < DV; ++j) {
    const int c = j * 8 + 2 * t;  // D is a multiple of 8: c < D => c + 1 < D
    if (c < D) {
      if (n_a < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)n_a * D + c) =
            __floats2bfloat162_rn(o[j][0] * r0, o[j][1] * r0);
      if (n_b < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)n_b * D + c) =
            __floats2bfloat162_rn(o[j][2] * r1, o[j][3] * r1);
    }
  }
}

// DK: D rounded up to a multiple of 8; one thread per query row.
template <int DK>
__global__ void __launch_bounds__(BQ)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int N, int H, int D, Strides sq, Strides sk, Strides sv,
                      float scale_log2) {
  __shared__ __align__(16) float Ks[BKV_F32][DK];
  __shared__ __align__(16) float Vs[BKV_F32][DK];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n_q = blockIdx.x * BQ + tid;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // q pre-scaled into the log2 domain, so that scores come out ready for exp2.
  float qr[DK], acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    qr[d] = (n_q < N && d < D) ? qb[n_q * sq.n + d] * scale_log2 : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  for (int n0 = 0; n0 < N; n0 += BKV_F32) {
    __syncthreads();
    for (int idx = tid; idx < BKV_F32 * DK / 4; idx += BQ) {
      const int r = idx / (DK / 4), c = (idx % (DK / 4)) * 4;
      const int n = n0 + r;
      float4 kv = zero, vv = zero;
      if (n < N && c < D) {  // D is a multiple of 8: c < D => c + 3 < D
        kv = *reinterpret_cast<const float4*>(kb + n * sk.n + c);
        vv = *reinterpret_cast<const float4*>(vb + n * sv.n + c);
      }
      *reinterpret_cast<float4*>(&Ks[r][c]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    __syncthreads();
    const int n_valid = min(BKV_F32, N - n0);
    for (int j0 = 0; j0 < n_valid; j0 += KCHUNK) {
      float s[KCHUNK];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < KCHUNK; ++jj) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < DK; ++d) dot = fmaf(qr[d], Ks[j0 + jj][d], dot);
        s[jj] = (j0 + jj < n_valid) ? dot : -INFINITY;
        mc = fmaxf(mc, s[jj]);
      }
      // j0 < n_valid: the chunk holds a valid key and mc is finite.
      const float alpha = exp2f(m - mc);
      m = mc;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < KCHUNK; ++jj) {
        const float p = exp2f(s[jj] - mc);
        l += p;
#pragma unroll
        for (int d = 0; d < DK; ++d) acc[d] = fmaf(p, Vs[j0 + jj][d], acc[d]);
      }
    }
  }

  if (n_q < N) {
    float* ob = out + ((long long)bh * N + n_q) * D;
    const float r = 1.0f / l;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < D) ob[d] = acc[d] * r;
  }
}

template <int DK>
void launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                 int N, int D, Strides sq, Strides sk, Strides sv, float scale_log2,
                 cudaStream_t stream) {
  dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_attn_bf16_kernel<DK><<<grid, 128, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, H, D, sq, sk, sv,
      scale_log2);
}

template <int DK>
void launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                int N, int D, Strides sq, Strides sk, Strides sv, float scale_log2,
                cudaStream_t stream) {
  dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_attn_f32_kernel<DK><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, H, D, sq, sk, sv,
      scale_log2);
}

}  // namespace

// q, k, v: (B, H, N, D) with element strides s*_b, s*_h, s*_n and unit d
// stride; out: contiguous (B, H, N, D) in the inputs' type.  is_f32 != 0:
// f32 tensors, else bf16.  D is a multiple of 8 in [8, 128]; the pointers
// are 16-byte aligned and the strides are multiples of 16 bytes (the
// wrapper checks).  Returns cudaErrorInvalidValue for a D it does not take.
extern "C" int gt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int is_f32, int B, int H, int N, int D,
                                  long long sqb, long long sqh, long long sqn,
                                  long long skb, long long skh, long long skn,
                                  long long svb, long long svh, long long svn,
                                  void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (D < 8 || D > 128 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn};
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    if (D <= 16)
      launch_f32<16>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else if (D <= 32)
      launch_f32<32>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else if (D <= 64)
      launch_f32<64>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else
      launch_f32<128>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
  } else {
    if (D <= 16)
      launch_bf16<16>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else if (D <= 32)
      launch_bf16<32>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else if (D <= 64)
      launch_bf16<64>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
    else
      launch_bf16<128>(q, k, v, out, B, H, N, D, sq, sk, sv, scale_log2, s);
  }
  return (int)cudaGetLastError();
}
