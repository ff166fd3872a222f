// Beam-search decoder self-attention over an append-only KV cache, for
// Hopper (sm_90a): one new token per hypothesis attends to its ancestral
// history.
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/beam_attention.py::
// ancestry_attention (body _kernel). For hypothesis row b of a beam group of
// n rows, at cache position t < pos the key/value is the one written by row
// (b / n) * n + hist[b, t]; at t == pos it is this step's k_new / v_new (the
// cache slot there is stale: the caller appends after attention); t > pos is
// masked. Numerics as the TPU kernel: fp32 scores from a pre-scaled q, the
// softmax over t <= pos with the global max and sum, each history weight
// p_t / l rounded to the cache dtype before p.v, the history part of p.v
// summed in fp32, the self term (p_pos / l) * v_new added in fp32, the
// output cast to q's dtype.
//
// What bounds it on the H100: bytes and latency. One call reads the K and V
// rows of every hypothesis's history once: at Bb = 10, H = 20, pos = 224 in
// bf16 that is 11.5 MB, 3.4 us at 3.35 TB/s, for ~1 FLOP per byte, so the
// tensor cores have nothing to do. The rows are scattered (one 128-byte
// (bf16) or 256-byte (fp32) row per position, from the ancestor's slab), so
// what costs time is the number of dependent round trips to memory, not the
// transfer.
//
// Design: every byte a block needs is in flight after one round trip.
//   - The positions t < pos of one (hypothesis, head) are dealt over a
//     thread-block cluster of C CTAs (C = 4 in bf16, 8 in fp32: the fastest
//     of 1, 2, 4 and 8 on the H100 at the beam step's shapes, PERF.md;
//     scripts/probe_beam_kernels.py rebuilds with ANCESTRY_CLUSTER_BF16 /
//     _F32 defined to time the others): CTA r takes t = r, r + C, r + 2C, ..
//     below pos, so every CTA carries an equal share at any pos, and a CTA
//     with no position publishes max -inf, sum 0 and an empty output.
//   - Thread i of CTA r reads hist[b, r + C * i] in the same round trip as
//     pos (the address does not depend on pos), then issues two 1-D bulk
//     copies (cp.async.bulk) of that position's K row and V row into shared
//     memory, K on one mbarrier and V on another, so the scores start while
//     V is still landing. No load of the inner loops depends on another.
//   - Scores from shared memory with 16-byte reads: 8 (bf16) or 16 (fp32)
//     lanes per row, a shuffle reduction within the row's lanes; then the
//     CTA's max m_r and sum l_r = sum exp(s - m_r).
//   - The CTAs exchange (m_r, l_r) through distributed shared memory: each
//     stores its pair into every CTA of the cluster with st.async, which
//     lands on the receiver's mbarrier, so each CTA waits for its C pairs
//     and not for a cluster-wide barrier. Every CTA then holds the global
//     max m and sum l = sum_r l_r * exp(m_r - m), the same sum as
//     sum_t exp(s_t - m) up to fp32 rounding. Each weight is exp(s_t - m) / l
//     with the global m and l: no partial output is ever rescaled, so p is
//     rounded where the TPU kernel rounds it.
//   - Each CTA runs its p.v over its rows and stores its 64 fp32 partial
//     sums into the leader CTA's shared memory the same way; the leader
//     (rank 0, which also owns the self term t == pos) waits for the C
//     partials, adds them and the fp32 self term, and stores the row once.
//     The other CTAs are done as soon as their stores have left.
//   - The launch does not depend on pos: grid (Bb * H * C), cluster and
//     shared memory are sized from T, and the kernel reads pos from a device
//     int32. One launch captured in a CUDA graph replays at any position.
// Limits: head dim 64; ceil((T - 1) / C) rows of K and V (64 elements
// each) and their fp32 scores must fit SMEM_BUDGET (T <= 3,149 in bf16,
// 3,169 in fp32; ancestry_attn_max_len gives it; Whisper's decoder has
// T <= 448). hist must hold group-local rows in [0, n); a pos outside
// [0, T) read from the device gives a NaN output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_sm90.cuh"

#ifndef ANCESTRY_CLUSTER_BF16
#define ANCESTRY_CLUSTER_BF16 4
#endif
#ifndef ANCESTRY_CLUSTER_F32
#define ANCESTRY_CLUSTER_F32 8
#endif

namespace {

constexpr int HD = 64;        // head dim, every Whisper size
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_BUDGET = 200 * 1024;        // dynamic shared memory cap
// CTAs per (hypothesis, head), by the cache dtype: fp32 rows are twice as
// long, so twice as many CTAs; at most 8, the portable cluster size
template <typename T>
constexpr int CLUSTER = std::is_same<T, float>::value ? ANCESTRY_CLUSTER_F32
                                                      : ANCESTRY_CLUSTER_BF16;
static_assert(CLUSTER<float> >= 1 && CLUSTER<float> <= 8 &&
                  CLUSTER<__nv_bfloat16> >= 1 && CLUSTER<__nv_bfloat16> <= 8,
              "a cluster holds 1 to 8 CTAs");

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// reduce one value per thread across the CTA; every thread gets the result
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* stat) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = MAX ? warp_max(x) : warp_sum(x);
  if (lane == 0) stat[warp] = x;
  __syncthreads();
  float r = stat[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, stat[w]) : r + stat[w];
  __syncthreads();  // stat is reused by the next reduction
  return r;
}

// ---------------------------------------------------------------- clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster arrives, then waits for all: the
// arrival orders no memory (the mbarrier inits are published by their own
// release fence)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the same shared-memory variable in CTA `rank` of this cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(sm90::smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async_v2(uint32_t addr, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 x,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}

// `bytes` from global memory to this CTA's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------ 16-byte chunks of a row
template <typename T>
struct Chunk;  // E elements of a row as fp32
template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void load(const float* p, float (&x)[E]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float cast(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[E]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  // round to the cache dtype and back: the TPU kernel's weight rounding
  __device__ static float cast(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// shared-memory rows per CTA: the longest slice of the t - 1 history
// positions any pos can give
__host__ __device__ inline size_t rows_max(int t, int c) {
  return t > 1 ? (t - 1 + c - 1) / c : 1;
}

// K rows, V rows and fp32 scores of one CTA
template <typename T>
size_t smem_bytes(int t) {
  const size_t rows = rows_max(t, CLUSTER<T>);
  return rows * (2 * HD * sizeof(T) + sizeof(float));
}

// the longest cache whose slice fits SMEM_BUDGET
template <typename T>
int max_len() {
  const int rows = SMEM_BUDGET / (2 * HD * sizeof(T) + sizeof(float));
  return rows * CLUSTER<T> + 1;
}

// (m, l) of a softmax part: its max and its sum of exp(s - m); merging two
// rescales each sum to the larger max (an empty part is (-inf, 0))
__device__ __forceinline__ float rescaled(float l, float m, float to) {
  return l == 0.f ? 0.f : l * expf(m - to);
}
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  l = rescaled(l, m, mx) + rescaled(l2, m2, mx);
  m = mx;
}

template <typename T, int C = CLUSTER<T>>
__global__ void __launch_bounds__(THREADS)
    ancestry_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new,
                         const T* __restrict__ cache_k,
                         const T* __restrict__ cache_v,
                         const int* __restrict__ hist,
                         const int* __restrict__ pos_ptr, T* __restrict__ out,
                         int h, int t_len, int n) {
  using CK = Chunk<T>;
  constexpr int E = CK::E;            // elements per 16-byte chunk
  constexpr int LPR = HD / E;         // lanes per row: 8 (bf16), 16 (fp32)
  constexpr int GROUPS = THREADS / LPR;
  constexpr uint32_t ROW_BYTES = HD * sizeof(T);

  extern __shared__ __align__(128) unsigned char smem[];
  // K rows, V rows, the cluster's (m, l) pairs, (leader) its partial sums
  __shared__ __align__(8) uint64_t bars[4];
  __shared__ float warp_stat[WARPS];
  __shared__ __align__(8) float stats[C][2];       // every CTA's (m_r, l_r)
  __shared__ __align__(16) float part[WARPS][HD];  // per-warp partial p.v
  __shared__ __align__(16) float red[C][HD];       // leader: every CTA's p.v
  __shared__ float self_s;                         // leader: the self score

  const int bh = blockIdx.x / C;              // hypothesis * h + head
  const int b = bh / h, head = bh % h;
  const int rank = (int)cluster_rank();
  const bool leader = rank == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rmax = rows_max(t_len, C);
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + rmax * HD;
  float* s_p = reinterpret_cast<float*>(s_v + rmax * HD);  // scores, weights
  const size_t vec = (size_t)bh * HD;  // q / k_new / v_new / out offset

  // one round trip for what the copies need: pos, and the hist entry of
  // this thread's first position -- CTA r owns positions r, r + C, r + 2C,
  // .. below pos, so the address does not wait for pos. Beside them this
  // thread's chunk of q and (leader) the new token's k and v.
  const int pos = *pos_ptr;
  const int* hist_b = hist + (size_t)b * t_len;
  const int t0 = rank + C * tid;
  const int hist0 = t0 < t_len ? hist_b[t0] : 0;
  const int c = tid % LPR;             // this thread's chunk of a row
  float qc[E];
  CK::load(q + vec + c * E, qc);
  float kc[E];
  if (leader && tid < LPR) CK::load(k_new + vec + c * E, kc);
  const float vn = leader && tid < HD ? CK::to_f(v_new[vec + tid]) : 0.f;
  if (pos < 0 || pos >= t_len) {  // uniform over the cluster: no barrier
    if (leader && tid < HD)
      CK::store(out + vec + tid, __int_as_float(0x7fc00000));  // NaN
    return;
  }

  const int rows = pos > rank ? (pos - rank + C - 1) / C : 0;
  const uint32_t bar_k = sm90::smem_u32(&bars[0]);
  const uint32_t bar_v = sm90::smem_u32(&bars[1]);
  const uint32_t bar_s = sm90::smem_u32(&bars[2]);
  const uint32_t bar_o = sm90::smem_u32(&bars[3]);
  if (tid == 0) {
    sm90::mbar_init(bar_k, 1);
    sm90::mbar_init(bar_v, 1);
    sm90::mbar_init(bar_s, 1);
    if (leader) sm90::mbar_init(bar_o, 1);
    sm90::fence_mbar_init();
    sm90::mbar_arrive_expect_tx(bar_k, rows * ROW_BYTES);
    sm90::mbar_arrive_expect_tx(bar_v, rows * ROW_BYTES);
    sm90::mbar_arrive_expect_tx(bar_s, C * 2 * sizeof(float));
    if (leader) sm90::mbar_arrive_expect_tx(bar_o, C * HD * sizeof(float));
  }
  cluster_arrive_relaxed();  // this CTA's barriers are live for the others'
  __syncthreads();           // stores below

  // every K and V row of the slice in flight
  const size_t group0 = (size_t)(b / n) * n;
  for (int i = tid; i < rows; i += THREADS) {
    const int t = rank + C * i;
    const size_t row = group0 + (i == tid ? hist0 : hist_b[t]);
    const size_t off = ((row * h + head) * t_len + t) * HD;
    bulk_load(s_k + i * HD, cache_k + off, ROW_BYTES, bar_k);
    bulk_load(s_v + i * HD, cache_v + off, ROW_BYTES, bar_v);
  }

  // the self term's score (leader, first row group)
  float m = -INFINITY;
  if (leader && tid < LPR) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d += qc[e] * kc[e];
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      d += __shfl_xor_sync((1u << LPR) - 1u, d, o);
    m = d;
    if (tid == 0) self_s = d;
  }

  // scores over the slice and their max
  sm90::mbar_wait(bar_k, 0);
  for (int base = warp * (32 / LPR); base < rows; base += GROUPS) {
    const int i = base + lane / LPR;   // warp-uniform loop, per-group row
    float d = 0.f;
    if (i < rows) {
      float kx[E];
      CK::load(s_k + i * HD + c * E, kx);
#pragma unroll
      for (int e = 0; e < E; ++e) d += qc[e] * kx[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, o);
    if (i < rows) {
      if (c == 0) s_p[i] = d;
      m = fmaxf(m, d);
    }
  }
  m = block_reduce<true>(m, warp_stat);  // -inf for an empty slice
  float l = 0.f;
  if (m != -INFINITY) {
    for (int i = tid; i < rows; i += THREADS) l += expf(s_p[i] - m);
    if (leader && tid == 0) l += expf(self_s - m);
  }
  l = block_reduce<false>(l, warp_stat);

  // this CTA's (m_r, l_r) into every CTA of the cluster, each store landing
  // on the receiver's mbarrier
  cluster_wait();  // every CTA's barriers are live
  if (tid < C)
    st_async_v2(map_rank(&stats[rank][0], tid), m, l,
                map_rank(&bars[2], tid));
  sm90::mbar_wait(bar_s, 0);
  float gm = stats[0][0], gl = stats[0][1];  // the global max and sum
#pragma unroll
  for (int r = 1; r < C; ++r) merge(gm, gl, stats[r][0], stats[r][1]);

  // weights p_t / l rounded to the cache dtype
  for (int i = tid; i < rows; i += THREADS)
    s_p[i] = CK::cast(expf(s_p[i] - gm) / gl);
  __syncthreads();

  // p.v over the slice: thread (group g, chunk c) sums rows g, g + GROUPS..
  sm90::mbar_wait(bar_v, 0);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int i = tid / LPR; i < rows; i += GROUPS) {
    float vx[E];
    CK::load(s_v + i * HD + c * E, vx);
    const float w = s_p[i];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += w * vx[e];
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < LPR)
#pragma unroll
    for (int e = 0; e < E; ++e) part[warp][c * E + e] = acc[e];
  __syncthreads();
  // the CTA's 64 partial sums into the leader, 16 bytes a store; a
  // non-leader is then done (its stores leave from registers)
  if (tid < HD / 4) {
    float4 x = *reinterpret_cast<const float4*>(&part[0][4 * tid]);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 y = *reinterpret_cast<const float4*>(&part[w][4 * tid]);
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
    st_async_v4(map_rank(&red[rank][4 * tid], 0), x, map_rank(&bars[3], 0));
  }
  if (!leader) return;
  sm90::mbar_wait(bar_o, 0);
  if (tid < HD) {
    float x = red[0][tid];
#pragma unroll
    for (int r = 1; r < C; ++r) x += red[r][tid];
    x += expf(self_s - gm) / gl * vn;  // the self term stays fp32
    CK::store(out + vec + tid, x);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* cache_k, const void* cache_v, const int* hist,
                   const int* pos, void* out, int bb, int h, int t, int n,
                   cudaStream_t st) {
  constexpr int C = CLUSTER<T>;
  if (t > max_len<T>() || (size_t)bb * h * C > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto kernel = ancestry_attn_kernel<T>;
  const size_t smem = smem_bytes<T>(t);
  if (smem > 48 * 1024) {  // above the default cap only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bb * h * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const T*>(cache_k),
      static_cast<const T*>(cache_v), hist, pos, static_cast<T*>(out), h, t,
      n);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q, k_new, v_new, out: contiguous (bb, h, 1, 64); cache_k, cache_v:
// contiguous (bb, h, t, 64), 16-byte aligned, the layer's pre-update cache,
// t <= ancestry_attn_max_len(dtype); hist: contiguous (bb, t) int32 in
// [0, n); pos: one int32 on the device in [0, t). All on `device`; dtype
// 0 = float32, 1 = bfloat16. Launches on `stream` and returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for what it cannot
// take); it neither allocates nor synchronises.
extern "C" int ancestry_attn(const void* q, const void* k_new,
                             const void* v_new, const void* cache_k,
                             const void* cache_v, const void* hist,
                             const void* pos, void* out, int bb, int h, int t,
                             int n, int dtype, int device, void* stream) {
  if (bb <= 0 || h <= 0 || t <= 0 || n <= 0 || bb % n != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(cache_k) |
       reinterpret_cast<uintptr_t>(cache_v) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k_new)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* hi = static_cast<const int*>(hist);
  const int* po = static_cast<const int*>(pos);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_new, v_new, cache_k, cache_v, hi,
                                      po, out, bb, h, t, n, st);
  return (int)launch<float>(q, k_new, v_new, cache_k, cache_v, hi, po, out,
                            bb, h, t, n, st);
}

// The longest cache T the kernel takes in `dtype` (0 = float32,
// 1 = bfloat16), or 0 for another dtype.
extern "C" int ancestry_attn_max_len(int dtype) {
  return dtype == 1 ? max_len<__nv_bfloat16>()
                    : dtype == 0 ? max_len<float>() : 0;
}
