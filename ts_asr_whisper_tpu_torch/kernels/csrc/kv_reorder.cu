// Beam-search KV-cache reorder for Hopper (sm_90a): a gather-copy of the
// self-attention cache along its hypothesis axis, in two layouts.
//
// Replaces the TPU kernels ts_asr_whisper_tpu/ops/reorder.py::
// _reorder_pallas (kernel :44, layout 'bhtd') and _reorder_pallas_tbhd
// (kernel :76, layout 'tbhd'):
//
//     'bhtd'  cache (L, Bb, H, T, hd):  out[l, b]    = cache[l, idx[b]]
//     'tbhd'  cache (L, T, Bb, H, hd):  out[l, t, b] = cache[l, t, idx[b]]
//
// Both reduce to "out[o, b, :] = in[o, idx[b], :]" over contiguous slabs of
// `slab_bytes` bytes: the H*T*hd elements of one hypothesis per layer
// ('bhtd'), or the H*hd elements of one (layer, position, hypothesis)
// ('tbhd'; 2,560 bytes at large-v3-turbo in bf16). The copy moves bytes,
// so fp32 and bf16 share one code path.
//
// What bounds it on the H100: bytes. Each output byte is written once and
// each read once: at (4, 10, 20, 128, 64) bf16 that is 2 x 13.1 MB, 7.8 us at
// 3.35 TB/s; 27.4 us at T 448. No arithmetic.
//
// Design. idx is not a permutation (beam search often picks one ancestor
// for several rows), so the copy is out of place: `dst` must not overlap
// `src`. idx stays on the device and each block reads its own entries (the
// TPU kernels take it by scalar prefetch), so no host sync is needed.
// Every thread moves 16-byte vectors, neighbouring threads on neighbouring
// addresses; slabs and both base pointers must be 16-byte aligned (the
// wrapper refuses other tensors).
//   - 'bhtd': grid (chunks, Bb, L); the blocks of one (layer, hypothesis)
//     split its slab (327 KB at T 128 in bf16) and each thread keeps
//     UNROLL loads in flight before it stores them.
//   - 'tbhd': one block per (layer, position); it stages idx in shared
//     memory and copies the Bb slabs of its position, so consecutive
//     threads cover consecutive 16-byte pieces of the Bb * H * hd output
//     run.
// A source index outside [0, Bb) fills its output slab with all-ones bytes
// (NaN in fp32 and bf16) instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_CHUNKS = 65535;  // grid.x of the 'bhtd' kernel

__device__ __forceinline__ uint4 nan_vec() {
  return make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
}

__global__ void __launch_bounds__(THREADS)
    kv_reorder_bhtd_kernel(const uint4* __restrict__ src,
                           const int* __restrict__ idx,
                           uint4* __restrict__ dst, int bb, size_t slab_vec) {
  const int b = blockIdx.y;
  const size_t layer0 = (size_t)blockIdx.z * bb;
  const int s = idx[b];
  const bool ok = s >= 0 && s < bb;
  const uint4* in = src + (layer0 + (ok ? s : 0)) * slab_vec;
  uint4* out = dst + (layer0 + b) * slab_vec;
  const size_t step = (size_t)gridDim.x * THREADS * UNROLL;
  for (size_t base = (size_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < slab_vec; base += step) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)u * THREADS;
      if (i < slab_vec) v[u] = ok ? __ldg(in + i) : nan_vec();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)u * THREADS;
      if (i < slab_vec) out[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    kv_reorder_tbhd_kernel(const uint4* __restrict__ src,
                           const int* __restrict__ idx,
                           uint4* __restrict__ dst, int bb, int slab_vec) {
  extern __shared__ int s_idx[];  // this launch's bb source rows
  for (int b = threadIdx.x; b < bb; b += THREADS) s_idx[b] = idx[b];
  __syncthreads();
  const size_t row0 = (size_t)blockIdx.x * bb;  // (layer, position) row
  const int total = bb * slab_vec;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int b = i / slab_vec;
    const int j = i - b * slab_vec;
    const int s = s_idx[b];
    const uint4 v = (s >= 0 && s < bb)
                        ? __ldg(src + (row0 + s) * slab_vec + j)
                        : nan_vec();
    dst[(row0 + b) * slab_vec + j] = v;
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// src, dst: contiguous (outer, bb, slab_bytes / element size) caches, not
// overlapping, both 16-byte aligned, slab_bytes a multiple of 16; idx:
// contiguous (bb,) int32 source rows. 'bhtd': outer = L; 'tbhd': outer =
// L * T. All on `device`. Each launches on `stream` and returns the launch's
// cudaError_t (0 on success); neither allocates nor synchronises.
extern "C" int kv_reorder_bhtd(const void* src, const void* idx, void* dst,
                               int outer, int bb, int slab_bytes, int device,
                               void* stream) {
  if (outer <= 0 || outer > 65535 || bb <= 0 || bb > 65535 || slab_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(src) || !aligned(dst) || slab_bytes % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t slab_vec = (size_t)slab_bytes / 16;
  size_t chunks = (slab_vec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (chunks > MAX_CHUNKS) chunks = MAX_CHUNKS;
  const dim3 grid((unsigned)chunks, bb, outer);
  kv_reorder_bhtd_kernel<<<grid, THREADS, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(idx),
      static_cast<uint4*>(dst), bb, slab_vec);
  return (int)cudaGetLastError();
}

extern "C" int kv_reorder_tbhd(const void* src, const void* idx, void* dst,
                               int outer, int bb, int slab_bytes, int device,
                               void* stream) {
  if (outer <= 0 || bb <= 0 || bb > 8192 || slab_bytes <= 0 ||
      (long long)bb * (slab_bytes / 16) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned(src) || !aligned(dst) || slab_bytes % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  kv_reorder_tbhd_kernel<<<outer, THREADS, bb * sizeof(int),
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(idx),
      static_cast<uint4*>(dst), bb, slab_bytes / 16);
  return (int)cudaGetLastError();
}
