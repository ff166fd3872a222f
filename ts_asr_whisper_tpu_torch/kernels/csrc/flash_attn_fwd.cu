// Encoder self-attention forward for Hopper (sm_90a): out = softmax(q k^T) v,
// and, when asked for, the row log-sum-exp lse = m + log(l) that the backward
// (flash_attn_bwd.cu) takes instead of recomputing the row statistics.
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
// FLOP/byte balance point. It is bound by arithmetic (the tensor cores), not
// by memory; the (T, T) score matrix never reaches device memory.
//
// Design of the bf16 path (the main path), warp-specialised:
//   - one block per (batch*head, 128-row q tile), three warpgroups: a
//     producer that drops to 40 registers (setmaxnreg) and issues every TMA
//     load from one thread, and two consumers of 64 q rows each (232
//     registers);
//   - the Q tile is loaded once by TMA; K and V tiles of 128 keys x 64 head
//     dims (16 KB each) stream through a STAGES-deep shared-memory ring
//     guarded by full (TMA bytes) and empty (8 consumer-warp arrivals)
//     mbarriers (lane 0 of each consumer warp releases a stage once its
//     products are done), so loads of the next tiles overlap this tile's
//     products;
//   - TMA maps are 3-D (64, T, B*H) with 128-byte swizzle: the ragged last
//     tile of one (batch*head) reads zeros, never the next one's rows;
//   - S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory
//     (K-major), 4 k-steps over the head dim;
//   - online softmax in fp32 registers; keys >= T of the last tile set to
//     -FLT_MAX explicitly (a zero-filled key would score 0, not masked);
//     exp2 (ex2.approx.ftz) with log2(e) folded into one FFMA; the row
//     sum over the unrounded fp32 p; one division by it per row, in the
//     epilogue;
//   - O += P V: wgmma m64n64k16, P from registers (the S accumulator
//     fragment repacked as the A fragment after rounding to bf16, as the TPU
//     kernel rounds p to v's dtype), V the MN-major ("transposed") B operand
//     in shared memory, 8 k-steps over the tile's keys;
//   - q rows >= T are computed and never stored.
//   - every wgmma group is waited for at once; the two consumers interleave,
//     so one's softmax runs while the other's products do. Issuing S of the
//     next tile before P V of this one inside a consumer (FA3's overlap)
//     measured slower on an H100 (0.625 against 0.537 ms of device time at
//     (16, 20, 1500, 64) in chip_smoke.py).
// Not yet used: clusters (K/V multicast), a persistent grid.
//
// fp32 path: tensor cores would mean TF32, which keeps ~3 decimal digits, so
// it uses plain FMA: one thread per q row (128 rows per block), 32-key tiles,
// K/V rows read from shared memory as broadcasts. Not a speed target.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr int HD = 64;              // head dim, every Whisper size
constexpr float MASKED = -FLT_MAX;  // finfo(float32).min, as the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16 path
constexpr int BQ = 128;               // q rows per block, 64 per consumer
constexpr int BK = 128;               // keys per K/V tile
constexpr int STAGES = 3;             // depth of the K/V ring
constexpr int TILE = BK * HD * 2;     // bytes of a 128-row bf16 tile
constexpr int OFF_K = TILE;           // Q tile first
constexpr int OFF_V = OFF_K + STAGES * TILE;
constexpr int OFF_BAR = OFF_V + STAGES * TILE;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + align
constexpr int THREADS = 384;

__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   uint16_t* __restrict__ o, float* __restrict__ lse, int t) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbar = base + OFF_BAR;
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (t + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(qbar, TILE);
      tma_load_3d(base, &qmap, qbar, 0, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, 2 * TILE);
        tma_load_3d(base + OFF_K + s * TILE, &kmap, full + 8 * s, 0, j * BK,
                    bh);
        tma_load_3d(base + OFF_V + s * TILE, &vmap, full + 8 * s, 0, j * BK,
                    bh);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = q0 + c * 64 + warp * 16 + g;  // rows r0 and r0 + 8
    const int r1 = r0 + 8;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    const uint64_t qdesc = desc_b128(base + c * (TILE / 2));
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      const uint32_t ks = base + OFF_K + s * TILE;
      const uint32_t vs = base + OFF_V + s * TILE;

      // S = Q K^T, 64 rows x 128 keys
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128_ss(sc, qdesc + 2 * kk, desc_b128(ks) + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();

      const int k0 = j * BK;
      if (k0 + BK > t) {  // ragged last tile: zero-filled keys -> masked
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = k0 + 8 * i + 2 * tq;
          if (col >= t) sc[4 * i] = sc[4 * i + 2] = MASKED;
          if (col + 1 >= t) sc[4 * i + 1] = sc[4 * i + 3] = MASKED;
        }
      }

      // online softmax: new row max over the quad that shares a row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float sc0 = exp2_approx((m0 - mx0) * LOG2E);
      const float sc1 = exp2_approx((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      const float nb0 = -mx0 * LOG2E, nb1 = -mx1 * LOG2E;
      l0 *= sc0;
      l1 *= sc1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[4 * i] *= sc0;
        acc[4 * i + 1] *= sc0;
        acc[4 * i + 2] *= sc1;
        acc[4 * i + 3] *= sc1;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[4 * i] = exp2_approx(fmaf(sc[4 * i], LOG2E, nb0));
        sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], LOG2E, nb0));
        sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], LOG2E, nb1));
        sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], LOG2E, nb1));
        l0 += sc[4 * i] + sc[4 * i + 1];
        l1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      uint32_t pa[32];
      acc_to_a<128>(pa, sc);

      // O += P V: 8 k-steps of 16 keys, V MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64_rs(acc, &pa[4 * kk], desc_b128(vs + kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(o + (size_t)bh * t * HD);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * tq;
      if (r0 < t)
        o32[((size_t)r0 * HD + col) >> 1] =
            pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r1 < t)
        o32[((size_t)r1 * HD + col) >> 1] =
            pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
    if (lse != nullptr && tq == 0) {
      if (r0 < t) lse[(size_t)bh * t + r0] = m0 + logf(l0);
      if (r1 < t) lse[(size_t)bh * t + r1] = m1 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int FQ = 128;  // q rows per block, one per thread
constexpr int FK = 32;   // keys per shared-memory tile

__global__ void __launch_bounds__(128)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int t) {
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
    if (lse != nullptr) lse[(size_t)blockIdx.y * t + row] = m + logf(l);
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, t, head_dim) on `device`; lse: fp32 (bh, t),
// written only when not null. dtype 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it neither
// allocates nor synchronises.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int t,
                              int head_dim, int dtype, int device,
                              void* stream) {
  if (head_dim != HD || t <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (dtype == 1) {
    static bool smem_set[64] = {};
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(attn_fwd_bf16_sm90,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      smem_set[device] = true;
    }
    CUtensorMap qm, km, vm;
    if (!map_rows(&qm, q, true, bh, t, BQ) || !map_rows(&km, k, true, bh, t, BK) ||
        !map_rows(&vm, v, true, bh, t, BK))
      return (int)cudaErrorInvalidValue;
    dim3 grid((t + BQ - 1) / BQ, bh);
    attn_fwd_bf16_sm90<<<grid, THREADS, SMEM_BYTES, st>>>(
        qm, km, vm, static_cast<uint16_t*>(out), lp, t);
  } else if (dtype == 0) {
    dim3 grid((t + FQ - 1) / FQ, bh);
    attn_fwd_f32<<<grid, FQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lp, t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
