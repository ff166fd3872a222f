// Candidate-restricted CTC prefix probability (psi) for Hopper (sm_90a): a
// fused gather + dot over the vocab-major CTC posterior.
//
// Replaces the TPU kernel ts_asr_whisper_tpu/ops/psi_gather.py::gather_rows
// (body _gather_rows_kernel) together with the compact einsum that consumes
// its output (psi_gather.py:171-176). For each hypothesis b and candidate
// slot j it computes, in fp32,
//
//     out[b, j] = sum_t P[audio_idx[b], ids[b, j], t] * w[b, t]
//
// where P is the (B_audio, V, T) posterior (fp32, or bf16 under
// ctc_p_bf16) with unit stride along T and row stride ld >= T, ids the
// candidate ids and w the closed-form psi weights (ops/ctc_prefix.py::
// psi_weights). The log, the last-label correction and the scatter stay in
// PyTorch around it.
//
// What bounds it on the H100: bytes. At Bb = 10 hypotheses, K = 512 slots and
// T = 375 frames it reads 10 * 512 * 375 * 4 B = 7.7 MB of posterior rows in
// fp32 per beam step (half in bf16) for 2 FLOP per element: ~2.3 us at
// 3.35 TB/s, so launch latency is of the same order. The 5 beams of an audio
// row share most of their candidates, so many rows come from L2.
//
// Design. The TPU module copies each candidate row into a compact, time-folded
// tensor (pure DMA; a TPU fold pads T to 2048 to satisfy its DMA tiling) and
// then runs an einsum over it. Here nothing is copied: each warp reads its
// candidate's T-row straight from the unfolded posterior and reduces the dot
// in registers with a warp shuffle, so only the (Bb, K) sums reach device
// memory. One block of 8 warps per (hypothesis, 16 candidate slots); the
// hypothesis's weight row is staged once in shared memory. A T-row is 1,500 B
// in fp32 (750 B in bf16), not a multiple of 16 B, so the port stores the
// posterior with its row stride padded to a multiple of 8 elements, so every
// row starts 16-byte aligned and each lane reads 16-byte vectors (4 fp32 /
// 8 bf16); the last T % 4 (or % 8) elements of a row are read one by one, so
// nothing past T is read. Unaligned rows are refused. Out-of-range ids or
// audio rows give NaN.
// Not yet used: reuse of a row shared by several beams within one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // candidate slots per block
constexpr int MAX_T = 8 * 1024;              // 32 KB of weights in shared

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dot of one 16-byte vector of the row (elements e0 .. e0+E-1) with ws
__device__ __forceinline__ float vec_dot(const float* row, const float* ws,
                                         int e0) {
  const float4 x = *reinterpret_cast<const float4*>(row + e0);
  const float4 y = *reinterpret_cast<const float4*>(ws + e0);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
__device__ __forceinline__ float vec_dot(const __nv_bfloat16* row,
                                         const float* ws, int e0) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + e0);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 y0 = *reinterpret_cast<const float4*>(ws + e0);
  const float4 y1 = *reinterpret_cast<const float4*>(ws + e0 + 4);
  const float2 a = __bfloat1622float2(x[0]), b = __bfloat1622float2(x[1]);
  const float2 c = __bfloat1622float2(x[2]), d = __bfloat1622float2(x[3]);
  return a.x * y0.x + a.y * y0.y + b.x * y0.z + b.y * y0.w + c.x * y1.x +
         c.y * y1.y + d.x * y1.z + d.y * y1.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    psi_gather_dot_kernel(const T* __restrict__ p, const int* __restrict__ ids,
                          const int* __restrict__ audio_idx,
                          const float* __restrict__ w, float* __restrict__ out,
                          int k, int v, int t_len, int ld, int b_audio) {
  extern __shared__ __align__(16) float ws[];  // this hypothesis's weights
  const int b = blockIdx.x;
  const float* wb = w + (size_t)b * t_len;
  for (int t = threadIdx.x; t < t_len; t += THREADS) ws[t] = wb[t];
  __syncthreads();

  const int a = audio_idx[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int j = blockIdx.y * ROWS + r * WARPS + warp;
    if (j >= k) break;  // warp-uniform
    const int id = ids[(size_t)b * k + j];
    float s;
    if (a < 0 || a >= b_audio || id < 0 || id >= v) {
      s = __int_as_float(0x7fc00000);  // NaN
    } else {
      const T* row = p + ((size_t)a * v + id) * ld;
      const int nvec = t_len / E;
      s = 0.f;
#pragma unroll 4
      for (int i = lane; i < nvec; i += 32) s += vec_dot(row, ws, i * E);
      for (int t = nvec * E + lane; t < t_len; t += 32)
        s += to_f(row[t]) * ws[t];
      s = warp_sum(s);
    }
    if (lane == 0) out[(size_t)b * k + j] = s;
  }
}

template <typename T>
cudaError_t launch(const void* p, const int* ids, const int* audio_idx,
                   const float* w, float* out, int bb, int k, int v, int t,
                   int ld, int b_audio, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || ld % E != 0)
    return cudaErrorMisalignedAddress;  // rows must start 16-byte aligned
  const dim3 grid(bb, (k + ROWS - 1) / ROWS);
  const size_t smem = (size_t)t * sizeof(float);
  psi_gather_dot_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(p), ids, audio_idx, w, out, k, v, t, ld, b_audio);
  return cudaGetLastError();
}

}  // namespace

// p: (b_audio, v, t) with strides (v * ld, ld, 1), 16-byte aligned, ld a
// multiple of 16 bytes; ids: contiguous (bb, k)
// int32; audio_idx: (bb,) int32; w: contiguous (bb, t) float32; out:
// contiguous (bb, k) float32. All on `device`; dtype (of p) 0 = float32,
// 1 = bfloat16. Launches on `stream` and returns the launch's cudaError_t
// (0 on success); it neither allocates nor synchronises.
extern "C" int psi_gather_dot(const void* p, const void* ids,
                              const void* audio_idx, const void* w, void* out,
                              int bb, int k, int v, int t, int ld, int b_audio,
                              int dtype, int device, void* stream) {
  if (bb <= 0 || k <= 0 || (k + ROWS - 1) / ROWS > 65535 ||
      v <= 0 || t <= 0 || t > MAX_T || ld < t || b_audio <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* ai = static_cast<const int*>(audio_idx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(p, id, ai, wf, o, bb, k, v, t, ld,
                                      b_audio, st);
  if (dtype == 0)
    return (int)launch<float>(p, id, ai, wf, o, bb, k, v, t, ld, b_audio, st);
  return (int)cudaErrorInvalidValue;
}
