// Encoder self-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q k^T) v, q already scaled by head_dim**-0.5, no mask, from
// the forward's saved output and row log-sum-exp (flash_attn_fwd.cu).
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/attention.py::
// _flash_mha_bwd_pallas (body _attn_bwd_kernel): fp32 scores,
// p = exp(s - lse), dp = g v^T in fp32, ds = p * (dp - D), ds and p rounded
// to q's dtype before the three products dq = ds k, dk = ds^T q, dv = p^T g
// (fp32 accumulation), keys at or past T masked, q rows at or past T removed
// by a select (never a multiply) before they reach dk or dv. D is
// rowsum(g * out), which equals the TPU kernel's rowsum(dp * p) because
// out = p v, up to the rounding of out to its dtype.
//
// What bounds it on the H100: the five products take 10 * B*H * T^2 * 64
// FLOP against ~8 (B*H, T, 64) tensors of bytes; at the fine-tune shape
// (4, 20, 1500, 64) bf16 that is 1.15e11 FLOP, 0.116 ms at 989 TFLOP/s,
// against ~12 MB, 3.7 us at 3.35 TB/s. It is bound by arithmetic; the (T, T)
// scores, probabilities and their gradients never reach device memory.
//
// Design. The TPU kernel walks the q blocks of one (batch*head) in order and
// accumulates dk/dv in resident output blocks. Here, with the forward's lse
// saved, each product is done once (5 products, not the 9 of a design that
// recomputes the row statistics), in three launches:
//   1. attn_bwd_prep: D = rowsum(g * out) in fp32 per q row, and (bf16) the
//      fp32 dq accumulator (B*H, T, 64) set to zero;
//   2. attn_bwd_bf16_sm90, one block per (batch*head, 128-key tile), three
//      warpgroups: a producer (setmaxnreg down to 40) and two consumers of
//      64 keys each (232 registers). K and V are loaded once by TMA and stay
//      in shared memory; the block loops over 64-row q tiles, Q and g by TMA
//      and lse and D by the producer warp through a three-stage ring (full and
//      empty mbarriers). Per q tile and consumer:
//        S^T = K Q^T and dP^T = V g^T (wgmma, both operands K-major in
//          shared memory);
//        P^T = exp2(S^T log2e - lse log2e), dS^T = P^T (dP^T - D), with keys
//          and q rows >= T selected to 0 (TMA zero-fills the reads past T);
//        dV += bf16(P^T) g and dK += bf16(dS^T) Q (wgmma, A from registers,
//          B = g or Q MN-major in shared memory);
//        dQ partial = bf16(dS) K: dS^T is written to shared memory as bf16
//          (128B-swizzled), multiplied by wgmma with both operands MN-major,
//          staged in fp32 and added into the accumulator as one 64 x 64 tile
//          by a TMA reduce-add (cp.reduce.async.bulk.tensor .add; rows past
//          T clipped by the map; double-buffered staging). One op a tile,
//          not one per row: the 64 row reduces took 17% longer on an H100
//          (scripts/probe_flash_bwd.py);
//      dk and dv are cast and stored at the end. Every TMA map is 3-D
//      (64, T, B*H), so the ragged last tile reads zeros, not the next
//      (batch*head)'s rows;
//   3. attn_bwd_dq_cast: the fp32 accumulator -> dq in bf16.
// dq's sums arrive from 12 key tiles (T = 1500) in an order that varies from
// run to run (fp32 adds in the L2), so dq is not bit-reproducible; dk and dv
// are.
// Every wgmma group is waited for before the next step of the same
// consumer; the two consumers interleave. Overlapping a tile's products
// with the next tile's S^T and dP^T inside one consumer needs ~190
// registers a thread, and ptxas allots 168 here (384 threads, one block per
// SM), so it spills. Not yet used: clusters, a persistent grid.
//
// fp32: no tensor cores (they would mean TF32); plain FMA, two threads per
// row, each holding half of the head dim and completing dot products with
// one shuffle; 32-row tiles in shared memory. It takes lse and D from
// outside as the bf16 path does: one kernel sweeps the keys once per q tile
// for dq, one the q rows once per key tile for dk and dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr int HD = 64;  // head dim, every Whisper size
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------ pre-pass and cast
__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const uint16_t* p, float x[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

// 16 threads per row, 4 head dims each: D[row] = sum(g * out) in fp32;
// zeroes the row of the dq accumulator when there is one
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_prep(const T* __restrict__ g, const T* __restrict__ out,
              float* __restrict__ dsum, float* __restrict__ dq_acc,
              int rows) {
  const int row = blockIdx.x * 16 + threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  float s = 0.f;
  if (row < rows) {
    float a[4], b[4];
    load4(g + (size_t)row * HD + part * 4, a);
    load4(out + (size_t)row * HD + part * 4, b);
    s = a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
  }
#pragma unroll
  for (int sh = 8; sh >= 1; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (row < rows) {
    if (part == 0) dsum[row] = s;
    if (dq_acc != nullptr)
      reinterpret_cast<float4*>(dq_acc + (size_t)row * HD)[part] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// n8 groups of 8 fp32 -> bf16
__global__ void __launch_bounds__(256)
attn_bwd_dq_cast(const float* __restrict__ acc, uint16_t* __restrict__ dq,
                 size_t n8) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  reinterpret_cast<uint4*>(dq)[i] =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                 pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// ---------------------------------------------------------------- bf16 path
constexpr int BKEY = 128;                 // keys per block, 64 per consumer
constexpr int BQT = 64;                   // q rows per ring tile
constexpr int STAGES = 3;
constexpr int KV_TILE = BKEY * HD * 2;    // 16 KB
constexpr int Q_TILE = BQT * HD * 2;      // 8 KB
constexpr int DQ_STAGE = BQT * HD * 4;   // fp32 dq tile, 16 KB
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + KV_TILE;
constexpr int OFF_Q = OFF_V + KV_TILE;
constexpr int OFF_G = OFF_Q + STAGES * Q_TILE;
constexpr int OFF_DS = OFF_G + STAGES * Q_TILE;  // one 64 x 64 bf16 each
constexpr int OFF_DQ = OFF_DS + 2 * Q_TILE;      // two buffers each
constexpr int OFF_STAT = OFF_DQ + 4 * DQ_STAGE;  // lse*log2e, D per stage
constexpr int OFF_BAR = OFF_STAT + STAGES * 2 * BQT * 4;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + align
constexpr int THREADS = 384;

__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_bf16_sm90(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap dqmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                   int t) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t kvbar = base + OFF_BAR;
  const uint32_t full = kvbar + 8, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, k0 = blockIdx.x * BKEY;
  const int nq = (t + BQT - 1) / BQT;
  const size_t row_base = (size_t)bh * t;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);    // the producer warp's lanes
      mbar_init(empty + 8 * s, 8);    // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * KV_TILE);
        tma_load_3d(base + OFF_K, &kmap, kvbar, 0, k0, bh);
        tma_load_3d(base + OFF_V, &vmap, kvbar, 0, k0, bh);
      }
      for (int it = 0; it < nq; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        float* st = reinterpret_cast<float*>(gbase + OFF_STAT) + s * 2 * BQT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, qr = it * BQT + r;
          st[r] = qr < t ? lse[row_base + qr] * LOG2E : 0.f;
          st[BQT + r] = qr < t ? dsum[row_base + qr] : 0.f;
        }
        if (lane == 0) {  // its arrival releases its own stores too
          mbar_arrive_expect_tx(full + 8 * s, 2 * Q_TILE);
          tma_load_3d(base + OFF_Q + s * Q_TILE, &qmap, full + 8 * s, 0,
                      it * BQT, bh);
          tma_load_3d(base + OFF_G + s * Q_TILE, &gmap, full + 8 * s, 0,
                      it * BQT, bh);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int kr = warp * 16 + g;          // local key rows kr and kr + 8
    const int key0 = k0 + c * 64 + kr, key1 = key0 + 8;
    const bool ok0 = key0 < t, ok1 = key1 < t;
    const uint32_t kw = base + OFF_K + c * Q_TILE;  // this consumer's keys
    const uint32_t vw = base + OFF_V + c * Q_TILE;
    const uint32_t dsb = base + OFF_DS + c * Q_TILE;
    uint8_t* ds_gen = gbase + OFF_DS + c * Q_TILE;

    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = 0; it < nq; ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t qs = base + OFF_Q + s * Q_TILE;
      const uint32_t gs = base + OFF_G + s * Q_TILE;
      const float* st = reinterpret_cast<const float*>(gbase + OFF_STAT) +
                        s * 2 * BQT;
      const int q0 = it * BQT;

      // S^T = K Q^T and dP^T = V g^T: 64 keys x 64 q rows each
      float sa[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss<0, 0>(sa, desc_b128(kw) + 2 * kk,
                              desc_b128(qs) + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss<0, 0>(dp, desc_b128(vw) + 2 * kk,
                              desc_b128(gs) + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      // staging buffer it % 2 is free once the reduce of two tiles ago has
      // read it (waited here, with no wgmma in flight: a branch between a
      // wgmma and its wait makes ptxas serialise them)
      if (tid == 0) bulk_wait_read<1>();

      // P^T and dS^T; keys and q rows >= T selected to 0, never multiplied
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * i + 2 * tq + e;
          const bool qok = q0 + qc < t;
          const float nl = -st[qc], dd = st[BQT + qc];
          const float p0 = (ok0 && qok) ? exp2_approx(fmaf(sa[4 * i + e], LOG2E, nl)) : 0.f;
          const float p1 = (ok1 && qok) ? exp2_approx(fmaf(sa[4 * i + 2 + e], LOG2E, nl)) : 0.f;
          dp[4 * i + e] = (ok0 && qok) ? p0 * (dp[4 * i + e] - dd) : 0.f;
          dp[4 * i + 2 + e] = (ok1 && qok) ? p1 * (dp[4 * i + 2 + e] - dd) : 0.f;
          sa[4 * i + e] = p0;
          sa[4 * i + 2 + e] = p1;
        }
      }
      uint32_t pa[16], da[16];
      acc_to_a<64>(pa, sa);
      acc_to_a<64>(da, dp);

      // dS^T -> shared memory for dQ: row = local key, its 64 q values in
      // 128B-swizzled chunks (chunk i of row r at i ^ (r % 8); r % 8 == g)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int off = ((i ^ g) << 4) + tq * 4;
        *reinterpret_cast<uint32_t*>(ds_gen + kr * 128 + off) =
            da[(i >> 1) * 4 + (i & 1) * 2];
        *reinterpret_cast<uint32_t*>(ds_gen + (kr + 8) * 128 + off) =
            da[(i >> 1) * 4 + (i & 1) * 2 + 1];
      }
      fence_proxy_async();

      // dV += P^T g, dK += dS^T Q: 4 k-steps of 16 q rows, B MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_rs(dva, &pa[4 * kk], desc_b128(gs + kk * 2048));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_rs(dka, &da[4 * kk], desc_b128(qs + kk * 2048));
      wgmma_commit();

      // dQ partial = dS K over this consumer's 64 keys, queued behind dV and
      // dK: A = dS (q rows contiguous, MN-major), B = K (head dims
      // contiguous, MN-major)
      named_bar_sync(1 + c, 128);  // all of dS^T is written, staging free
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss<1, 1>(dq, desc_b128(dsb + kk * 2048),
                              desc_b128(kw + kk * 2048), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // Q, g, lse and D of this stage are read
      if (lane == 0) mbar_arrive(empty + 8 * s);
      const int buf = OFF_DQ + (2 * c + (it & 1)) * DQ_STAGE;
      float* stage = reinterpret_cast<float*>(gbase + buf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * tq;
        *reinterpret_cast<float2*>(stage + kr * HD + col) =
            make_float2(dq[4 * i], dq[4 * i + 1]);
        *reinterpret_cast<float2*>(stage + (kr + 8) * HD + col) =
            make_float2(dq[4 * i + 2], dq[4 * i + 3]);
      }
      fence_proxy_async();
      named_bar_sync(1 + c, 128);
      if (tid == 0) {  // one reduce-add of the tile; rows >= T clipped
        tma_reduce_add_3d(&dqmap, base + buf, 0, q0, bh);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();

    uint32_t* dk32 = reinterpret_cast<uint32_t*>(dk + row_base * HD);
    uint32_t* dv32 = reinterpret_cast<uint32_t*>(dv + row_base * HD);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * tq;
      if (ok0) {
        dk32[((size_t)key0 * HD + col) >> 1] = pack_bf16(dka[4 * i], dka[4 * i + 1]);
        dv32[((size_t)key0 * HD + col) >> 1] = pack_bf16(dva[4 * i], dva[4 * i + 1]);
      }
      if (ok1) {
        dk32[((size_t)key1 * HD + col) >> 1] = pack_bf16(dka[4 * i + 2], dka[4 * i + 3]);
        dv32[((size_t)key1 * HD + col) >> 1] = pack_bf16(dva[4 * i + 2], dva[4 * i + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int FR = 64;      // rows per block: two threads per row
constexpr int FT = 32;      // rows per shared-memory tile
constexpr int HH = HD / 2;  // head dims per thread

// full 64-dim dot product of a thread's half row with the same half of a
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

// dq of FR q rows: one sweep over the key tiles
__global__ void __launch_bounds__(2 * FR)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ gr,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dq, int t) {
  __shared__ __align__(16) float ks[FT * HD];
  __shared__ __align__(16) float vs[FT * HD];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tid = threadIdx.x, half = tid & 1;
  const int r = blockIdx.x * FR + (tid >> 1);
  const size_t srow = (size_t)blockIdx.y * t + r;

  float qh[HH], gh[HH], acc[HH];
  load_half(qh, q + base, r, t, half);
  load_half(gh, gr + base, r, t, half);
  const float L = r < t ? lse[srow] : 0.f, D = r < t ? dsum[srow] : 0.f;
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
      const float p = k0 + j < t ? expf(sj - L) : 0.f;
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
}

// dk and dv of FR keys: one sweep over the q tiles
__global__ void __launch_bounds__(2 * FR)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ gr,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ dk, float* __restrict__ dv, int t) {
  __shared__ __align__(16) float qs[FT * HD];
  __shared__ __align__(16) float gs[FT * HD];
  __shared__ float ls[FT], Ds[FT];

  const size_t base = (size_t)blockIdx.y * t * HD;
  const size_t row = (size_t)blockIdx.y * t;
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
      ls[tid] = ok ? lse[row + q0 + tid] : 0.f;
      Ds[tid] = ok ? dsum[row + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < FT; ++i) {
      const float* qrow = &qs[i * HD + half * HH];
      const float* grow = &gs[i * HD + half * HH];
      const float si = dot_pair(kh, qrow);
      const float dpi = dot_pair(vh, grow);
      const bool ok = q0 + i < t;  // select, never multiply
      const float p = ok ? expf(si - ls[i]) : 0.f;
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

// q, k, v, g (the output's gradient), out (the forward's output), dq, dk,
// dv: contiguous (bh, t, head_dim) on `device`; lse: the forward's fp32
// (bh, t); dsum: fp32 scratch of bh * t (D); dq_acc: fp32 scratch of
// (bh, t, head_dim) for bf16, unused (may be null) for fp32. dtype 0 =
// float32, 1 = bfloat16. Launches the three kernels in order on `stream` and
// returns the launches' cudaError_t (0 on success); it neither allocates nor
// synchronises.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* g, const void* out, const void* lse,
                              void* dq, void* dk, void* dv, void* dsum,
                              void* dq_acc, int bh, int t, int head_dim,
                              int dtype, int device, void* stream) {
  if (head_dim != HD || t <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = bh * t;
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(dsum);
  if (dtype == 1) {
    using T = const uint16_t*;
    if (dq_acc == nullptr || device < 0 || device >= 64)
      return (int)cudaErrorInvalidValue;
    static bool smem_set[64] = {};
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(attn_bwd_bf16_sm90,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      smem_set[device] = true;
    }
    float* acc = static_cast<float*>(dq_acc);
    CUtensorMap km, vm, qm, gm, dqm;
    if (!map_rows(&km, k, true, bh, t, BKEY) ||
        !map_rows(&vm, v, true, bh, t, BKEY) ||
        !map_rows(&qm, q, true, bh, t, BQT) ||
        !map_rows(&gm, g, true, bh, t, BQT) ||
        !map_rows(&dqm, acc, false, bh, t, BQT))
      return (int)cudaErrorInvalidValue;
    attn_bwd_prep<uint16_t><<<(rows + 15) / 16, 256, 0, st>>>(
        static_cast<T>(g), static_cast<T>(out), dp, acc, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((t + BKEY - 1) / BKEY, bh);
    attn_bwd_bf16_sm90<<<grid, THREADS, SMEM_BYTES, st>>>(
        km, vm, qm, gm, dqm, lp, dp, static_cast<uint16_t*>(dk),
        static_cast<uint16_t*>(dv), t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t n8 = (size_t)rows * HD / 8;
    attn_bwd_dq_cast<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
        acc, static_cast<uint16_t*>(dq), n8);
  } else if (dtype == 0) {
    using T = const float*;
    attn_bwd_prep<float><<<(rows + 15) / 16, 256, 0, st>>>(
        static_cast<T>(g), static_cast<T>(out), dp, nullptr, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((t + FR - 1) / FR, bh);
    attn_bwd_dq_f32<<<grid, 2 * FR, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), lp, dp, static_cast<float*>(dq), t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_f32<<<grid, 2 * FR, 0, st>>>(
        static_cast<T>(q), static_cast<T>(k), static_cast<T>(v),
        static_cast<T>(g), lp, dp, static_cast<float*>(dk),
        static_cast<float*>(dv), t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
