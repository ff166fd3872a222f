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
// ctc_p_bf16) with unit stride along T and row stride ld, ids the candidate
// ids and w the closed-form psi weights (ops/ctc_prefix.py::psi_weights),
// fp32 for either posterior dtype (as the JAX package's matmul path
// promotes a bf16 posterior; its gather path rounds w to bf16 first). The
// log, the last-label correction and the scatter stay in PyTorch around it.
//
// What bounds it on the H100: bytes and latency. At Bb = 10 hypotheses,
// K = 512 slots and T = 375 frames it reads 10 * 512 * 375 * 4 B = 7.7 MB of
// posterior rows in fp32 per beam step (half in bf16) for 2 FLOP per
// element: 2.3 us at 3.35 TB/s, the same order as one launch and a few
// memory round trips. The 5 beams of an audio row share most of their
// candidates, so many rows come from L2.
//
// Design: two round trips, every row of a warp in flight before any sum.
//   - Nothing is copied: each warp reads its candidates' T-rows straight from
//     the unfolded posterior (the TPU module copies them into a compact,
//     time-folded tensor first) and only the (Bb, K) sums reach memory.
//   - A block of 4 warps serves one hypothesis and 4 * R consecutive slots;
//     a warp owns R = 2 slots (the fastest of 1, 2, 4 and 8 on the H100 at
//     the beam step's shapes, PERF.md; scripts/probe_beam_kernels.py
//     rebuilds with PSI_ROWS_PER_WARP defined to time the others).
//   - Round trip 1: the warp's R ids (uniform loads), the audio row and the
//     lane's slice of w, all independent. Lane l always covers the same
//     16-byte vectors l, l + 32, .. of every row (3 float4 at T 375 fp32), so
//     its weights live in registers for the whole block (zero past T): no
//     shared-memory stage, no block barrier.
//   - Round trip 2: the R rows' vectors (R * NV 16-byte loads a lane), all
//     issued before the first product; then R shuffle reductions and one
//     store per slot.
//   - No scalar tail: the posterior's rows are stored with their stride
//     padded to a multiple of 16 bytes (ops/psi_gather.py::padded_posterior),
//     so the last vector of a row is read whole; its elements past T are
//     set to zero before the products, so whatever the padding holds (NaN
//     too) adds nothing.
//   - Rows longer than 32 * NV vectors (T > 512 fp32, 1,024 bf16) take
//     several such passes.
// Out-of-range ids or audio rows give NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NV = 4;  // 16-byte vectors of a row per lane and pass
#ifndef PSI_ROWS_PER_WARP
#define PSI_ROWS_PER_WARP 2
#endif
constexpr int R = PSI_ROWS_PER_WARP;  // candidate rows a warp has in flight

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// zero the elements of a row's last 16-byte vector past T (`valid` of them
// are inside the row, 1 .. E): 4 fp32 words, or 4 words of two bf16 each,
// element 2i in the low half of word i
__device__ __forceinline__ void zero_past(uint4& x, int valid, float) {
  if (valid < 4) x.w = 0u;
  if (valid < 3) x.z = 0u;
  if (valid < 2) x.y = 0u;
}
__device__ __forceinline__ uint32_t keep_pair(uint32_t w, int e, int valid) {
  return e >= valid ? 0u : e + 1 >= valid ? (w & 0xffffu) : w;
}
__device__ __forceinline__ void zero_past(uint4& x, int valid,
                                          __nv_bfloat16) {
  x.x = keep_pair(x.x, 0, valid);
  x.y = keep_pair(x.y, 2, valid);
  x.z = keep_pair(x.z, 4, valid);
  x.w = keep_pair(x.w, 6, valid);
}

// one 16-byte vector of a row: E elements, as fp32 products with E weights
__device__ __forceinline__ float vec_dot(const uint4& raw, const float* w,
                                         float) {
  const float4 x = *reinterpret_cast<const float4*>(&raw);
  return x.x * w[0] + x.y * w[1] + x.z * w[2] + x.w * w[3];
}
__device__ __forceinline__ float vec_dot(const uint4& raw, const float* w,
                                         __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x[i]);
    s += f.x * w[2 * i] + f.y * w[2 * i + 1];
  }
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
    psi_gather_dot_kernel(const T* __restrict__ p, const int* __restrict__ ids,
                          const int* __restrict__ audio_idx,
                          const float* __restrict__ w, float* __restrict__ out,
                          int k, int v, int t_len, int ld, int b_audio) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = (blockIdx.y * WARPS + warp) * R;
  if (j0 >= k) return;  // warp-uniform; the kernel has no block barrier

  // round trip 1: audio row, the warp's ids, the lane's weights
  const int a = audio_idx[b];
  int id[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    id[r] = j0 + r < k ? ids[(size_t)b * k + j0 + r] : 0;
  const float* wb = w + (size_t)b * t_len;
  float wr[NV][E];  // this lane's weights for vectors v0 + lane + 32 i
  auto load_w = [&](int v0) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = (v0 + lane + 32 * i) * E + e;
        wr[i][e] = t < t_len ? wb[t] : 0.f;
      }
  };
  load_w(0);
  const int nvec = (t_len + E - 1) / E;   // the last reaches into the pad
  const int last_valid = t_len - (nvec - 1) * E;  // its elements before T
  const bool a_ok = a >= 0 && a < b_audio;
  const T* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    rows[r] = a_ok && id[r] >= 0 && id[r] < v
                  ? p + ((size_t)a * v + id[r]) * ld : nullptr;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int v0 = 0;;) {   // one pass at T <= 32 * NV * E
    // round trip 2: every vector of the warp's R rows
    uint4 x[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = v0 + lane + 32 * i;
        x[r][i] = rows[r] && vi < nvec
                      ? *reinterpret_cast<const uint4*>(rows[r] + vi * E)
                      : make_uint4(0u, 0u, 0u, 0u);
        if (vi == nvec - 1) zero_past(x[r][i], last_valid, T());
      }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[r] += vec_dot(x[r][i], wr[i], T());
    v0 += 32 * NV;
    if (v0 >= nvec) break;
    load_w(v0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == r && j0 + r < k)
      out[(size_t)b * k + j0 + r] =
          rows[r] ? s : __int_as_float(0x7fc00000);  // NaN
  }
}

template <typename T>
cudaError_t launch(const void* pv, const int* ids, const int* ai,
                   const float* w, float* out, int bb, int k, int v, int t,
                   int ld, int b_audio, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = (t + E - 1) / E;
  if (reinterpret_cast<uintptr_t>(pv) % 16 != 0 || ld % E != 0 ||
      ld < nvec * E)
    return cudaErrorMisalignedAddress;  // rows must start 16-byte aligned
  const dim3 grid(bb, (k + WARPS * R - 1) / (WARPS * R));
  const T* p = static_cast<const T*>(pv);
  // the fewest vectors per lane that cover a row in one pass, at most MAX_NV
  const int nv = (nvec + 31) / 32;
  switch (nv < MAX_NV ? nv : MAX_NV) {
    case 1:
      psi_gather_dot_kernel<T, 1><<<grid, THREADS, 0, st>>>(
          p, ids, ai, w, out, k, v, t, ld, b_audio);
      break;
    case 2:
      psi_gather_dot_kernel<T, 2><<<grid, THREADS, 0, st>>>(
          p, ids, ai, w, out, k, v, t, ld, b_audio);
      break;
    case 3:
      psi_gather_dot_kernel<T, 3><<<grid, THREADS, 0, st>>>(
          p, ids, ai, w, out, k, v, t, ld, b_audio);
      break;
    default:
      psi_gather_dot_kernel<T, 4><<<grid, THREADS, 0, st>>>(
          p, ids, ai, w, out, k, v, t, ld, b_audio);
  }
  return cudaGetLastError();
}

}  // namespace

// p: (b_audio, v, t) with strides (v * ld, ld, 1), 16-byte aligned, ld a
// multiple of 16 bytes and at least t (the padding is read and ignored);
// ids: contiguous (bb, k) int32; audio_idx: (bb,) int32; w: contiguous
// (bb, t) float32; out: contiguous (bb, k) float32. All on `device`; dtype
// (of p) 0 = float32, 1 = bfloat16. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it neither allocates nor
// synchronises.
extern "C" int psi_gather_dot(const void* p, const void* ids,
                              const void* audio_idx, const void* w, void* out,
                              int bb, int k, int v, int t, int ld, int b_audio,
                              int dtype, int device, void* stream) {
  if (bb <= 0 || k <= 0 || v <= 0 || t <= 0 || b_audio <= 0 ||
      (k + WARPS * R - 1) / (WARPS * R) > 65535)
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
    return (int)launch<float>(p, id, ai, wf, o, bb, k, v, t, ld, b_audio,
                              st);
  return (int)cudaErrorInvalidValue;
}
