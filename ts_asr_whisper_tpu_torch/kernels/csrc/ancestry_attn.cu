// Beam-search decoder self-attention over an append-only KV cache, for
// Hopper (sm_90a): one new token per hypothesis attends to its ancestral
// history.
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/beam_attention.py::
// ancestry_attention (body _kernel). For hypothesis row b of a beam group of
// n rows, at cache position t < pos the key/value is the one written by row
// (b / n) * n + hist[b, t]; at t == pos it is this step's k_new / v_new (the
// cache slot there is stale: the caller appends after attention); t > pos is
// masked. Numerics as the TPU kernel: fp32 scores and softmax, history
// weights rounded to the cache dtype before p.v, the self term in fp32, the
// output cast to q's dtype. q is pre-scaled.
//
// What bounds it on the H100: memory latency and launch latency. One call
// reads at most Bb * H * T * 64 * 2 (K and V) elements: at Bb = 10, H = 20,
// T = 448 in bf16 that is 22.9 MB, ~6.8 us at 3.35 TB/s, against ~1 FLOP per
// byte -- far below the card's balance point, so the tensor cores have
// nothing to do. Each warp walks its positions with a dependent hist -> row
// load, so at these sizes latency, not bandwidth, sets the time.
//
// Design. The TPU kernel loads a beam group's n cache rows once and selects
// per position with a select-over-n (hist == c), because a TPU block cannot
// gather rows; here the ancestor row is address arithmetic, so each
// (hypothesis, head) block reads only the K/V rows of its own history -- one
// cache read in all, no n-fold work. One block of 8 warps per (hypothesis,
// head):
//   1. scores: one warp per key (lanes hold 2 of the 64 dims, so a key row is
//      one coalesced 128-byte (bf16) or 256-byte (fp32) read), a shuffle
//      reduction, the fp32 score into shared memory (T <= 448 floats);
//   2. block max and sum of exp over t <= pos; probabilities e / sum;
//   3. p.v: warps split the history positions, lanes hold 2 output dims, the
//      warps' partial sums meet in shared memory, and warp 0 adds the fp32
//      self term and stores.
// Not yet used: several (hypothesis, head) pairs per block, cp.async
// prefetch of the next key rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim, every Whisper size
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SMEM_T = 8 * 1024;  // 32 KB of scores: within the 48 KB default

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements 2 * lane and 2 * lane + 1 of a 64-element row, as fp32
__device__ __forceinline__ float2 load2(const float* row, int lane) {
  return *reinterpret_cast<const float2*>(row + 2 * lane);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, int lane) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + 2 * lane));
}

__device__ __forceinline__ void store2(float* row, int lane, float2 x) {
  *reinterpret_cast<float2*>(row + 2 * lane) = x;
}
__device__ __forceinline__ void store2(__nv_bfloat16* row, int lane,
                                       float2 x) {
  *reinterpret_cast<__nv_bfloat162*>(row + 2 * lane) =
      __floats2bfloat162_rn(x.x, x.y);
}

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

// reduce one value per warp across the block; every thread gets the result
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ancestry_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new,
                         const T* __restrict__ cache_k,
                         const T* __restrict__ cache_v,
                         const int* __restrict__ hist, T* __restrict__ out,
                         int h, int t_len, int pos, int n) {
  extern __shared__ float p[];        // scores, then probabilities: t <= pos
  __shared__ float part[WARPS][HD];   // per-warp partial p.v sums
  __shared__ float stat[WARPS];

  const int bh = blockIdx.x;          // hypothesis * h + head
  const int b = bh / h, head = bh % h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t vec = (size_t)bh * HD;  // q / k_new / v_new / out offset
  const int* hist_b = hist + (size_t)b * t_len;
  const int group0 = b / n * n;
  // element offset of (cache row, head, position t): ((row*h+head)*T + t)*HD
  auto cache_off = [&](int t) {
    const int row = group0 + hist_b[t];
    return (((size_t)row * h + head) * t_len + t) * HD;
  };

  // 1. scores
  const float2 qv = load2(q + vec, lane);
#pragma unroll 4
  for (int t = warp; t <= pos; t += WARPS) {
    const float2 kv = t < pos ? load2(cache_k + cache_off(t), lane)
                              : load2(k_new + vec, lane);
    const float s = warp_sum(qv.x * kv.x + qv.y * kv.y);
    if (lane == 0) p[t] = s;
  }
  __syncthreads();

  // 2. softmax over t <= pos (positions past pos carry no weight)
  float m = -FLT_MAX;
  for (int t = threadIdx.x; t <= pos; t += THREADS) m = fmaxf(m, p[t]);
  m = block_reduce<true>(m, &stat[0]);
  float l = 0.f;
  for (int t = threadIdx.x; t <= pos; t += THREADS) {
    const float e = expf(p[t] - m);
    p[t] = e;
    l += e;
  }
  l = block_reduce<false>(l, &stat[0]);  // its trailing barrier publishes p

  // 3. p.v over the history, weights rounded to the cache dtype
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int t = warp; t < pos; t += WARPS) {
    const float w = to_f(from_f<T>(p[t] / l));
    const float2 vv = load2(cache_v + cache_off(t), lane);
    acc.x += w * vv.x;
    acc.y += w * vv.y;
  }
  part[warp][2 * lane] = acc.x;
  part[warp][2 * lane + 1] = acc.y;
  __syncthreads();
  if (warp == 0) {
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sum.x += part[w][2 * lane];
      sum.y += part[w][2 * lane + 1];
    }
    const float p_self = p[pos] / l;  // the self term stays fp32
    const float2 vn = load2(v_new + vec, lane);
    sum.x += p_self * vn.x;
    sum.y += p_self * vn.y;
    store2(out + vec, lane, sum);
  }
}

}  // namespace

// q, k_new, v_new, out: contiguous (bb, h, 1, 64); cache_k, cache_v:
// contiguous (bb, h, t, 64), the layer's pre-update cache; hist: contiguous
// (bb, t) int32 in [0, n). All on `device`; dtype 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it neither allocates nor synchronises.
extern "C" int ancestry_attn(const void* q, const void* k_new,
                             const void* v_new, const void* cache_k,
                             const void* cache_v, const void* hist, void* out,
                             int bb, int h, int t, int pos, int n, int dtype,
                             int device, void* stream) {
  if (bb <= 0 || h <= 0 || t <= 0 || t > MAX_SMEM_T || pos < 0 || pos >= t ||
      n <= 0 || bb % n != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(bb * h);
  const size_t smem = (size_t)t * sizeof(float);
  const int* hi = static_cast<const int*>(hist);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    ancestry_attn_kernel<T><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<const T*>(cache_k),
        static_cast<const T*>(cache_v), hi, static_cast<T*>(out), h, t, pos,
        n);
  } else if (dtype == 0) {
    ancestry_attn_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), static_cast<const float*>(cache_k),
        static_cast<const float*>(cache_v), hi, static_cast<float*>(out), h,
        t, pos, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
