// Encoder self-attention forward for Hopper (sm_90a): out = softmax(q k^T) v.
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/attention.py::_flash_mha_fwd
// (body _attn_kernel): unmasked attention over (B*H, T, 64) with q already
// scaled by head_dim**-0.5, softmax in fp32 with max subtraction, the
// probabilities cast to v's dtype before p.v, the division by the row sum at
// the end, keys at or past T masked with finfo(float32).min.
//
// What bounds it on the H100: per (batch*head) pair at T=1500, hd=64 the two
// products take 2 * 2 * 1500^2 * 64 ~= 0.58 GFLOP against ~0.58 MB of q, k, v
// and out in bf16 -- about 1,000 FLOP per byte, far above the card's ~295
// FLOP/byte balance point. It is bound by arithmetic, not by memory; the
// (T, T) score matrix is what must never reach device memory (at the turbo
// shape (16, 20, 1500, 64), about 184 GFLOP per call, it would be 2.9 GB in
// fp32).
//
// Design. The TPU kernel keeps all of K and V for one (batch*head) in VMEM;
// at T=1500 that is 384 KB in bf16, more than the 227 KB of shared memory a
// block may use. So K/V stream through shared memory in 64-key tiles with an
// online softmax (running max and sum in fp32, fp32 accumulator), and no
// score ever leaves registers:
//   - bf16: one block per (batch*head, 64-row q tile), 4 warps of 16 q rows.
//     Both products run on the tensor cores through mma.sync m16n8k16 (bf16
//     in, fp32 accumulate). The S accumulator fragment is repacked in
//     registers as the A operand of P.V, rounded to bf16 as the TPU kernel
//     rounds p to v's dtype; the row sum is taken over the unrounded fp32 p.
//   - fp32: tensor cores would mean TF32, which keeps ~3 decimal digits; this
//     path uses plain FMA instead: one thread per q row (128 rows per block),
//     32-key tiles, K/V rows read from shared memory as broadcasts.
// The ragged last key tile and the ragged last q tile are masked here, with
// no padding on the host. Shared-memory rows of the bf16 path are padded to
// 72 elements so that the fragment reads are free of bank conflicts.
// Not yet used: wgmma, TMA, cp.async pipelining, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;             // head dim, every Whisper size
constexpr float MASKED = -FLT_MAX;  // finfo(float32).min, as the TPU kernel

// ---------------------------------------------------------------- bf16 path
constexpr int BQ = 64;             // q rows per block: 4 warps x 16
constexpr int BK = 64;             // keys per shared-memory tile
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

__global__ void __launch_bounds__(128)
attn_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int t) {
  __shared__ __align__(16) uint16_t ks[BK * LDS];
  __shared__ __align__(16) uint16_t vs[BK * LDS];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma group / thread in group
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8
  const int r1 = r0 + 8;

  // Q as A fragments for the 4 k-steps over the head dim; rows past t are 0
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + base);
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    qa[kk][0] = r0 < t ? q32[(r0 * HD + c) >> 1] : 0u;
    qa[kk][1] = r1 < t ? q32[(r1 * HD + c) >> 1] : 0u;
    qa[kk][2] = r0 < t ? q32[(r0 * HD + c + 8) >> 1] : 0u;
    qa[kk][3] = r1 < t ? q32[(r1 * HD + c + 8) >> 1] : 0u;
  }

  float acc[8][4];  // 16 x 64 output per warp: 8 n-tiles of 8 head dims
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < t; k0 += BK) {
    // K/V tile -> shared memory, 16 bytes per load; keys past t are zeros
    for (int i = tid; i < BK * HD / 8; i += 128) {
      const int row = i >> 3, c8 = (i & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + row < t) {
        const size_t off = base + (size_t)(k0 + row) * HD + c8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[row * LDS + c8]) = kv;
      *reinterpret_cast<uint4*>(&vs[row * LDS + c8]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* krow = &ks[(nt * 8 + g) * LDS + tig * 2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16_16816(s[nt], qa[kk], b0, b1);
      }
    }
    if (k0 + BK > t) {  // ragged last tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (k0 + nt * 8 + tig * 2 + j >= t) s[nt][j] = s[nt][2 + j] = MASKED;
    }

    // online softmax: new row max over the quad that shares a row
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
    l1 *= sc1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= sc0;
      acc[dt][1] *= sc0;
      acc[dt][2] *= sc1;
      acc[dt][3] *= sc1;
    }

    // P in registers: the S fragments of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk of P.V
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m1), p3 = expf(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: B fragment (k = key, n = head dim) gathers two key rows
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const uint16_t* vcol = &vs[(tig * 2) * LDS + dt * 8 + g];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint16_t* vp = vcol + kk * 16 * LDS;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[LDS] << 16);
        const uint32_t b1 =
            (uint32_t)vp[8 * LDS] | ((uint32_t)vp[9 * LDS] << 16);
        mma_bf16_16816(acc[dt], pa[kk], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  uint32_t* o32 = reinterpret_cast<uint32_t*>(o + base);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r0 < t) o32[(r0 * HD + c) >> 1] = pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    if (r1 < t) o32[(r1 * HD + c) >> 1] = pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int FQ = 128;  // q rows per block, one per thread
constexpr int FK = 32;   // keys per shared-memory tile

__global__ void __launch_bounds__(128)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int t) {
  __shared__ __align__(16) float ks[FK * HD];
  __shared__ __align__(16) float vs[FK * HD];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * FQ + tid;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < t) x = *reinterpret_cast<const float4*>(q + base + (size_t)row * HD + d4 * 4);
    qr[d4 * 4 + 0] = x.x;
    qr[d4 * 4 + 1] = x.y;
    qr[d4 * 4 + 2] = x.z;
    qr[d4 * 4 + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = MASKED, l = 0.f;

  for (int k0 = 0; k0 < t; k0 += FK) {
    for (int i = tid; i < FK * HD / 4; i += FQ) {
      const int kr = i / (HD / 4), c4 = (i % (HD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kr < t) {
        const size_t off = base + (size_t)(k0 + kr) * HD + c4;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[kr * HD + c4]) = kv;
      *reinterpret_cast<float4*>(&vs[kr * HD + c4]) = vv;
    }
    __syncthreads();

    float s[FK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j * HD]);
      float a = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kv = kr[d4];
        a = fmaf(qr[d4 * 4 + 0], kv.x, a);
        a = fmaf(qr[d4 * 4 + 1], kv.y, a);
        a = fmaf(qr[d4 * 4 + 2], kv.z, a);
        a = fmaf(qr[d4 * 4 + 3], kv.w, a);
      }
      s[j] = (k0 + j < t) ? a : MASKED;
      mx = fmaxf(mx, s[j]);
    }
    const float sc = expf(m - mx);
    m = mx;
    l *= sc;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= sc;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(s[j] - m);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j * HD]);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[d4 * 4 + 0] = fmaf(p, vv.x, acc[d4 * 4 + 0]);
        acc[d4 * 4 + 1] = fmaf(p, vv.y, acc[d4 * 4 + 1]);
        acc[d4 * 4 + 2] = fmaf(p, vv.z, acc[d4 * 4 + 2]);
        acc[d4 * 4 + 3] = fmaf(p, vv.w, acc[d4 * 4 + 3]);
      }
    }
    __syncthreads();
  }

  if (row < t) {
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      float4 x;
      x.x = acc[d4 * 4 + 0] / l;
      x.y = acc[d4 * 4 + 1] / l;
      x.z = acc[d4 * 4 + 2] / l;
      x.w = acc[d4 * 4 + 3] / l;
      *reinterpret_cast<float4*>(o + base + (size_t)row * HD + d4 * 4) = x;
    }
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, t, head_dim) on `device`; dtype 0 = float32,
// 1 = bfloat16. Launches on `stream` and returns the launch's cudaError_t
// (0 on success); it neither allocates nor synchronises.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, int bh, int t, int head_dim,
                              int dtype, int device, void* stream) {
  if (head_dim != HD || t <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((t + BQ - 1) / BQ, bh);
    attn_fwd_bf16<<<grid, 128, 0, st>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), t);
  } else if (dtype == 0) {
    dim3 grid((t + FQ - 1) / FQ, bh);
    attn_fwd_f32<<<grid, FQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
