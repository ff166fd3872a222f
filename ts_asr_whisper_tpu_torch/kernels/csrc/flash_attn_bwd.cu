// Encoder self-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q k^T) v, q already scaled by head_dim**-0.5, no mask.
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/attention.py::
// _flash_mha_bwd_pallas (body _attn_bwd_kernel): scores recomputed in fp32
// with max subtraction, p = e / sum(e), dp = g v^T in fp32,
// ds = p * (dp - rowsum(dp * p)), ds and p rounded to q's dtype before the
// three products dq = ds k, dk = ds^T q, dv = p^T g (fp32 accumulation),
// keys at or past T masked with finfo(float32).min, q rows at or past T
// removed by a select (never a multiply) before they reach dk or dv.
//
// What bounds it on the H100: the five products of the backward take
// 10 * B*H * T^2 * 64 FLOP against ~7 (B*H, T, 64) tensors of bytes; at the
// fine-tune shape (4, 20, 1500, 64) bf16 that is 1.15e11 FLOP, 0.116 ms at
// 989 TFLOP/s, against ~11 MB, 3.4 us at 3.35 TB/s. It is bound by
// arithmetic; the (T, T) scores, probabilities and their gradients must
// never reach device memory (2.9 GB each in fp32 at that shape).
//
// Design. The TPU kernel walks the q blocks of one (batch*head) in order and
// accumulates dk/dv in output blocks that stay resident across that
// sequential grid axis. Hopper runs blocks in parallel in no order, so the
// sum is split instead, with no atomics and a fixed summation order:
//   kernel A, one block per (batch*head, 64-row q tile):
//     sweep 1 over the K/V tiles: online row max m, row sum l of
//       e = exp(s - m), and Dsum = sum(e * dp) with dp = g v^T, so that
//       D = Dsum / l = rowsum(dp * p) with p unrounded, as the TPU kernel;
//     sweep 2: p = exp(s - m) / l, ds = p * (dp - D) rounded to q's dtype,
//       dq += ds k; writes dq and (m, l, D) as fp32 scratch of (B*H, T);
//   kernel B, one block per (batch*head, 64-key tile), loops over all q
//     tiles: recomputes s^T = k q^T, p from m and l, dp^T = v g^T,
//     dv += p^T g and dk += ds^T q in fp32 registers, cast at the end.
// Kernel A runs 5 products (S twice, dP twice, dQ) and kernel B 4, so the
// kernels do 9 of the 5 products' work: the price of no atomics and no
// saved statistics from the forward.
//   - bf16: 4 warps of 16 rows; every product is mma.sync m16n8k16 (bf16
//     in, fp32 accumulate) as in flash_attn_fwd.cu. An S-shaped fp32
//     accumulator fragment is repacked in registers as the A operand of the
//     next product after rounding to bf16 (p and ds, as the TPU kernel).
//   - fp32: no tensor cores (they would mean TF32); plain FMA, two threads
//     per row, each holding half of the head dim and completing dot
//     products with one shuffle; 32-row tiles in shared memory.
// Not yet used: wgmma, TMA, cp.async pipelining, the forward's statistics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;             // head dim, every Whisper size
constexpr float MASKED = -FLT_MAX;  // finfo(float32).min, as the TPU kernel

// ---------------------------------------------------------------- bf16 path
constexpr int BR = 64;             // rows (q in A, keys in B) per block
constexpr int BT = 64;             // rows per shared-memory tile
constexpr int LDS = HD + 8;        // padded row, in bf16 elements

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (16 rows x 64 head dims, 4 k-steps) of rows r0 and r1 = r0 + 8
// of a (t, 64) bf16 matrix; rows past t are zeros
__device__ __forceinline__ void load_a(uint32_t a[4][4], const uint16_t* x,
                                       int r0, int t, int tig) {
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    a[kk][0] = r0 < t ? x32[(r0 * HD + c) >> 1] : 0u;
    a[kk][1] = r1 < t ? x32[(r1 * HD + c) >> 1] : 0u;
    a[kk][2] = r0 < t ? x32[(r0 * HD + c + 8) >> 1] : 0u;
    a[kk][3] = r1 < t ? x32[(r1 * HD + c + 8) >> 1] : 0u;
  }
}

// rows [r0, r0 + BT) of two (t, 64) bf16 matrices -> shared memory, 16 bytes
// per load; rows past t are zeros
__device__ __forceinline__ void load_tiles(uint16_t* xs, uint16_t* ys,
                                           const uint16_t* x,
                                           const uint16_t* y, int r0, int t,
                                           int tid) {
  for (int i = tid; i < BT * HD / 8; i += 128) {
    const int row = i >> 3, c8 = (i & 7) * 8;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
    if (r0 + row < t) {
      const size_t off = (size_t)(r0 + row) * HD + c8;
      xv = *reinterpret_cast<const uint4*>(x + off);
      yv = *reinterpret_cast<const uint4*>(y + off);
    }
    *reinterpret_cast<uint4*>(&xs[row * LDS + c8]) = xv;
    *reinterpret_cast<uint4*>(&ys[row * LDS + c8]) = yv;
  }
}

// C[16 x 64] = A[16 x 64] * X^T for the 64 rows of a shared tile X: the
// B fragment (k = head dim, n = tile row) is two adjacent head dims of a row
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4],
                                        const uint16_t* xs, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const uint16_t* row = &xs[(nt * 8 + g) * LDS + tig * 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16_16816(c[nt], a[kk], b0, b1);
    }
  }
}

// C[16 x 64] += P[16 x 64 tile rows] * X for a shared tile X: the B fragment
// (k = tile row, n = head dim) gathers two tile rows
__device__ __forceinline__ void mma_ab(float c[8][4], const uint32_t p[4][4],
                                       const uint16_t* xs, int g, int tig) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const uint16_t* col = &xs[(tig * 2) * LDS + dt * 8 + g];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint16_t* xp = col + kk * 16 * LDS;
      const uint32_t b0 = (uint32_t)xp[0] | ((uint32_t)xp[LDS] << 16);
      const uint32_t b1 = (uint32_t)xp[8 * LDS] | ((uint32_t)xp[9 * LDS] << 16);
      mma_bf16_16816(c[dt], p[kk], b0, b1);
    }
  }
}

// S-shaped accumulator fragments of n-tiles 2kk, 2kk+1 -> the bf16 A
// fragment of k-step kk of the next product
__device__ __forceinline__ void repack(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const uint16_t* __restrict__ gr,
                 uint16_t* __restrict__ dq, float* __restrict__ stats, int t,
                 int bh) {
  __shared__ __align__(16) uint16_t ks[BT * LDS];
  __shared__ __align__(16) uint16_t vs[BT * LDS];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BR + warp * 16 + g;  // rows r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t qa[4][4], ga[4][4];
  load_a(qa, q + base, r0, t, tig);
  load_a(ga, gr + base, r0, t, tig);

  // sweep 1: m, l and Dsum = sum(e * dp), online over the key tiles
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < t; k0 += BT) {
    load_tiles(ks, vs, k + base, v + base, k0, t, tid);
    __syncthreads();
    mma_abt(s, qa, ks, g, tig);
    mma_abt(dp, ga, vs, g, tig);
    if (k0 + BT > t) {  // ragged last tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (k0 + nt * 8 + tig * 2 + j >= t) s[nt][j] = s[nt][2 + j] = MASKED;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float sc0 = expf(m0 - mx0), sc1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= sc0;
    d0 *= sc0;
    l1 *= sc1;
    d1 *= sc1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e0 = expf(s[nt][j] - m0), e1 = expf(s[nt][2 + j] - m1);
        l0 += e0;
        d0 += e0 * dp[nt][j];
        l1 += e1;
        d1 += e1 * dp[nt][2 + j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    d0 += __shfl_xor_sync(0xffffffffu, d0, sh);
    d1 += __shfl_xor_sync(0xffffffffu, d1, sh);
  }
  const float D0 = d0 / l0, D1 = d1 / l1;

  // sweep 2: dq = bf16(p * (dp - D)) k
  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int k0 = 0; k0 < t; k0 += BT) {
    load_tiles(ks, vs, k + base, v + base, k0, t, tid);
    __syncthreads();
    mma_abt(s, qa, ks, g, tig);
    mma_abt(dp, ga, vs, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + tig * 2 + j < t;
        const float p0 = ok ? expf(s[nt][j] - m0) / l0 : 0.f;
        const float p1 = ok ? expf(s[nt][2 + j] - m1) / l1 : 0.f;
        s[nt][j] = p0 * (dp[nt][j] - D0);
        s[nt][2 + j] = p1 * (dp[nt][2 + j] - D1);
      }
    }
    uint32_t dsa[4][4];
    repack(dsa, s);
    mma_ab(acc, dsa, ks, g, tig);
    __syncthreads();
  }

  uint32_t* dq32 = reinterpret_cast<uint32_t*>(dq + base);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r0 < t) dq32[(r0 * HD + c) >> 1] = pack_bf16(acc[dt][0], acc[dt][1]);
    if (r1 < t) dq32[(r1 * HD + c) >> 1] = pack_bf16(acc[dt][2], acc[dt][3]);
  }
  if (tig == 0) {
    const size_t n = (size_t)bh * t, row = (size_t)blockIdx.y * t;
    if (r0 < t) {
      stats[row + r0] = m0;
      stats[n + row + r0] = l0;
      stats[2 * n + row + r0] = D0;
    }
    if (r1 < t) {
      stats[row + r1] = m1;
      stats[n + row + r1] = l1;
      stats[2 * n + row + r1] = D1;
    }
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dkv_bf16(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v,
                  const uint16_t* __restrict__ gr, uint16_t* __restrict__ dk,
                  uint16_t* __restrict__ dv, const float* __restrict__ stats,
                  int t, int bh) {
  __shared__ __align__(16) uint16_t qs[BT * LDS];
  __shared__ __align__(16) uint16_t gs[BT * LDS];
  __shared__ float ms[BT], ls[BT], Ds[BT];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const size_t n = (size_t)bh * t, row = (size_t)blockIdx.y * t;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BR + warp * 16 + g;  // keys r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t ka[4][4], va[4][4];
  load_a(ka, k + base, r0, t, tig);
  load_a(va, v + base, r0, t, tig);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }
  float s[8][4], dp[8][4];
  for (int q0 = 0; q0 < t; q0 += BT) {
    load_tiles(qs, gs, q + base, gr + base, q0, t, tid);
    if (tid < BT) {  // statistics of the tile's q rows; safe values past t
      const bool ok = q0 + tid < t;
      ms[tid] = ok ? stats[row + q0 + tid] : 0.f;
      ls[tid] = ok ? stats[n + row + q0 + tid] : 1.f;
      Ds[tid] = ok ? stats[2 * n + row + q0 + tid] : 0.f;
    }
    __syncthreads();
    mma_abt(s, ka, qs, g, tig);   // s^T: keys x q rows
    mma_abt(dp, va, gs, g, tig);  // dp^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + tig * 2 + j;
        const bool ok = q0 + c < t;  // select, never multiply
        const float p0 = ok ? expf(s[nt][j] - ms[c]) / ls[c] : 0.f;
        const float p1 = ok ? expf(s[nt][2 + j] - ms[c]) / ls[c] : 0.f;
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        dp[nt][j] = ok ? p0 * (dp[nt][j] - Ds[c]) : 0.f;
        dp[nt][2 + j] = ok ? p1 * (dp[nt][2 + j] - Ds[c]) : 0.f;
      }
    }
    uint32_t pa[4][4];
    repack(pa, s);
    mma_ab(dva, pa, gs, g, tig);   // dv += bf16(p)^T g
    repack(pa, dp);
    mma_ab(dka, pa, qs, g, tig);   // dk += bf16(ds)^T q
    __syncthreads();
  }

  uint32_t* dk32 = reinterpret_cast<uint32_t*>(dk + base);
  uint32_t* dv32 = reinterpret_cast<uint32_t*>(dv + base);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r0 < t) {
      dk32[(r0 * HD + c) >> 1] = pack_bf16(dka[dt][0], dka[dt][1]);
      dv32[(r0 * HD + c) >> 1] = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (r1 < t) {
      dk32[(r1 * HD + c) >> 1] = pack_bf16(dka[dt][2], dka[dt][3]);
      dv32[(r1 * HD + c) >> 1] = pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int FR = 64;   // rows per block: two threads per row
constexpr int FT = 32;   // rows per shared-memory tile
constexpr int HH = HD / 2;  // head dims per thread

// full 64-dim dot product of a thread's half row with half row `half` of a
// shared row; the partner thread (lane ^ 1) holds the other half
__device__ __forceinline__ float dot_pair(const float x[HH], const float* srow) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float a = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HH / 4; ++d4) {
    const float4 y = s4[d4];
    a = fmaf(x[d4 * 4 + 0], y.x, a);
    a = fmaf(x[d4 * 4 + 1], y.y, a);
    a = fmaf(x[d4 * 4 + 2], y.z, a);
    a = fmaf(x[d4 * 4 + 3], y.w, a);
  }
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

__device__ __forceinline__ void load_half(float x[HH], const float* src,
                                          int r, int t, int half) {
#pragma unroll
  for (int d4 = 0; d4 < HH / 4; ++d4) {
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < t)
      y = *reinterpret_cast<const float4*>(src + (size_t)r * HD + half * HH + d4 * 4);
    x[d4 * 4 + 0] = y.x;
    x[d4 * 4 + 1] = y.y;
    x[d4 * 4 + 2] = y.z;
    x[d4 * 4 + 3] = y.w;
  }
}

__device__ __forceinline__ void store_half(float* dst, const float x[HH],
                                           int r, int t, int half) {
  if (r >= t) return;
#pragma unroll
  for (int d4 = 0; d4 < HH / 4; ++d4)
    *reinterpret_cast<float4*>(dst + (size_t)r * HD + half * HH + d4 * 4) =
        make_float4(x[d4 * 4 + 0], x[d4 * 4 + 1], x[d4 * 4 + 2], x[d4 * 4 + 3]);
}

__device__ __forceinline__ void load_tiles_f32(float* xs, float* ys,
                                               const float* x, const float* y,
                                               int r0, int t, int tid) {
  for (int i = tid; i < FT * HD / 4; i += 2 * FR) {
    const int row = i / (HD / 4), c4 = (i % (HD / 4)) * 4;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
    if (r0 + row < t) {
      const size_t off = (size_t)(r0 + row) * HD + c4;
      xv = *reinterpret_cast<const float4*>(x + off);
      yv = *reinterpret_cast<const float4*>(y + off);
    }
    *reinterpret_cast<float4*>(&xs[row * HD + c4]) = xv;
    *reinterpret_cast<float4*>(&ys[row * HD + c4]) = yv;
  }
}

__global__ void __launch_bounds__(2 * FR)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ gr,
                float* __restrict__ dq, float* __restrict__ stats, int t,
                int bh) {
  __shared__ __align__(16) float ks[FT * HD];
  __shared__ __align__(16) float vs[FT * HD];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tid = threadIdx.x, half = tid & 1;
  const int r = blockIdx.x * FR + (tid >> 1);

  float qh[HH], gh[HH];
  load_half(qh, q + base, r, t, half);
  load_half(gh, gr + base, r, t, half);

  float m = MASKED, l = 0.f, dsum = 0.f;
  for (int k0 = 0; k0 < t; k0 += FT) {
    load_tiles_f32(ks, vs, k + base, v + base, k0, t, tid);
    __syncthreads();
    float s[FT], dp[FT];
    float mx = m;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      s[j] = dot_pair(qh, &ks[j * HD + half * HH]);
      dp[j] = dot_pair(gh, &vs[j * HD + half * HH]);
      if (k0 + j >= t) s[j] = MASKED;
      mx = fmaxf(mx, s[j]);
    }
    const float sc = expf(m - mx);
    m = mx;
    l *= sc;
    dsum *= sc;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      const float e = expf(s[j] - m);
      l += e;
      dsum += e * dp[j];
    }
    __syncthreads();
  }
  const float D = dsum / l;

  float acc[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < t; k0 += FT) {
    load_tiles_f32(ks, vs, k + base, v + base, k0, t, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < FT; ++j) {
      const float* krow = &ks[j * HD + half * HH];
      const float sj = dot_pair(qh, krow);
      const float dpj = dot_pair(gh, &vs[j * HD + half * HH]);
      const float p = k0 + j < t ? expf(sj - m) / l : 0.f;
      const float ds = p * (dpj - D);
      const float4* k4 = reinterpret_cast<const float4*>(krow);
#pragma unroll
      for (int d4 = 0; d4 < HH / 4; ++d4) {
        const float4 kv = k4[d4];
        acc[d4 * 4 + 0] = fmaf(ds, kv.x, acc[d4 * 4 + 0]);
        acc[d4 * 4 + 1] = fmaf(ds, kv.y, acc[d4 * 4 + 1]);
        acc[d4 * 4 + 2] = fmaf(ds, kv.z, acc[d4 * 4 + 2]);
        acc[d4 * 4 + 3] = fmaf(ds, kv.w, acc[d4 * 4 + 3]);
      }
    }
    __syncthreads();
  }
  store_half(dq + base, acc, r, t, half);
  if (half == 0 && r < t) {
    const size_t n = (size_t)bh * t, row = (size_t)blockIdx.y * t + r;
    stats[row] = m;
    stats[n + row] = l;
    stats[2 * n + row] = D;
  }
}

__global__ void __launch_bounds__(2 * FR)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ gr,
                 float* __restrict__ dk, float* __restrict__ dv,
                 const float* __restrict__ stats, int t, int bh) {
  __shared__ __align__(16) float qs[FT * HD];
  __shared__ __align__(16) float gs[FT * HD];
  __shared__ float ms[FT], ls[FT], Ds[FT];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const size_t n = (size_t)bh * t, row = (size_t)blockIdx.y * t;
  const int tid = threadIdx.x, half = tid & 1;
  const int r = blockIdx.x * FR + (tid >> 1);  // this thread's key

  float kh[HH], vh[HH], dka[HH], dva[HH];
  load_half(kh, k + base, r, t, half);
  load_half(vh, v + base, r, t, half);
#pragma unroll
  for (int d = 0; d < HH; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < t; q0 += FT) {
    load_tiles_f32(qs, gs, q + base, gr + base, q0, t, tid);
    if (tid < FT) {  // statistics of the tile's q rows; safe values past t
      const bool ok = q0 + tid < t;
      ms[tid] = ok ? stats[row + q0 + tid] : 0.f;
      ls[tid] = ok ? stats[n + row + q0 + tid] : 1.f;
      Ds[tid] = ok ? stats[2 * n + row + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < FT; ++i) {
      const float* qrow = &qs[i * HD + half * HH];
      const float* grow = &gs[i * HD + half * HH];
      const float si = dot_pair(kh, qrow);
      const float dpi = dot_pair(vh, grow);
      const bool ok = q0 + i < t;  // select, never multiply
      const float p = ok ? expf(si - ms[i]) / ls[i] : 0.f;
      const float ds = ok ? p * (dpi - Ds[i]) : 0.f;
      const float4* q4 = reinterpret_cast<const float4*>(qrow);
      const float4* g4 = reinterpret_cast<const float4*>(grow);
#pragma unroll
      for (int d4 = 0; d4 < HH / 4; ++d4) {
        const float4 qv = q4[d4], gv = g4[d4];
        dka[d4 * 4 + 0] = fmaf(ds, qv.x, dka[d4 * 4 + 0]);
        dka[d4 * 4 + 1] = fmaf(ds, qv.y, dka[d4 * 4 + 1]);
        dka[d4 * 4 + 2] = fmaf(ds, qv.z, dka[d4 * 4 + 2]);
        dka[d4 * 4 + 3] = fmaf(ds, qv.w, dka[d4 * 4 + 3]);
        dva[d4 * 4 + 0] = fmaf(p, gv.x, dva[d4 * 4 + 0]);
        dva[d4 * 4 + 1] = fmaf(p, gv.y, dva[d4 * 4 + 1]);
        dva[d4 * 4 + 2] = fmaf(p, gv.z, dva[d4 * 4 + 2]);
        dva[d4 * 4 + 3] = fmaf(p, gv.w, dva[d4 * 4 + 3]);
      }
    }
    __syncthreads();
  }
  store_half(dk + base, dka, r, t, half);
  store_half(dv + base, dva, r, t, half);
}

}  // namespace

// q, k, v, g (the output's gradient), dq, dk, dv: contiguous
// (bh, t, head_dim) on `device`; stats: fp32 scratch of 3 * bh * t (row max,
// row sum, D). dtype 0 = float32, 1 = bfloat16. Launches the two kernels in
// order on `stream` and returns the launches' cudaError_t (0 on success); it
// neither allocates nor synchronises.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* g, void* dq, void* dk, void* dv,
                              void* stats, int bh, int t, int head_dim,
                              int dtype, int device, void* stream) {
  if (head_dim != HD || t <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 1) {
    using T = const uint16_t*;
    dim3 grid((t + BR - 1) / BR, bh);
    attn_bwd_dq_bf16<<<grid, 128, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), static_cast<uint16_t*>(dq), sp, t, bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_bf16<<<grid, 128, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), static_cast<uint16_t*>(dk),
        static_cast<uint16_t*>(dv), sp, t, bh);
  } else if (dtype == 0) {
    using T = const float*;
    dim3 grid((t + FR - 1) / FR, bh);
    attn_bwd_dq_f32<<<grid, 2 * FR, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), static_cast<float*>(dq), sp, t, bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_f32<<<grid, 2 * FR, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), static_cast<float*>(dk), static_cast<float*>(dv),
        sp, t, bh);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
