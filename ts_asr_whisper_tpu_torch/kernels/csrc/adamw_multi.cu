// Multi-tensor kernels of the fine-tune's optimizer step for Hopper (sm_90a):
// the sum of squares of many tensors in one launch (sq_norm_multi) and the
// clip and AdamW update of every trained leaf in one launch (adamw_multi).
//
// They replace no TPU kernel: on the TPU, XLA fused optax's
// clip_by_global_norm + adamw (ts_asr_whisper_tpu/training/optim.py) into a
// few fusions. The port's plain versions are utils/observability.py::_sq_sum
// and the per-leaf loop of training/optim.py::AdamW.step, ~12 eager launches
// a leaf over ~480 leaves plus a host sync for the clip.
//
// What bounds them on the H100: bytes. The update reads p, g, m and v and
// writes p, m and v: 28 bytes a fp32 parameter, 20.2 GB at the DiCoW v3
// fine-tune's ~720 M trained parameters, 6.0 ms at 3.35 TB/s. The norm reads
// every gradient once: 2.9 GB, 0.86 ms.
//
// Design. Both kernels take their leaves as one table passed by value as a
// kernel parameter (up to MAX_LEAVES leaves a launch; the 32 KB parameter
// space of CUDA 12.1+), so a launch needs no device-side table and nothing
// is copied to the card per update: the host writes the gradients' pointers
// into its table and launches. Every leaf is cut into blocks of CHUNK
// elements; `chunk_end[i]` is the running count of blocks through leaf i,
// and each block finds its leaf by a binary search of it. Threads move 4
// elements at a time (16-byte fp32, 8-byte bf16 accesses) where every
// pointer of the leaf is aligned, one at a time otherwise.
//
//   adamw_multi: optax's arithmetic as the plain loop computes it on the
//   card, each operation rounded on its own (no FMA contraction), a division
//   by a host scalar as PyTorch's eager op computes it (times the fp32
//   reciprocal the host computes), the bf16 roundings of the plain loop for
//   bf16 parameters (wd * p and the step are rounded to the parameter's
//   type before they are added), the first moment stored in its own dtype,
//   the second in fp32. The clip is decided on the card from the norm in
//   device memory, `clip = !(g_norm < max_norm)`, so a NaN norm clips. A
//   null gradient pointer reads as zeros.
//
//   sq_norm_multi: each block adds the fp32 squares of its chunk in double
//   and writes one partial; a second kernel adds each slot's partials (a
//   contiguous range: the host sorts the leaves by slot) in a fixed order
//   and writes the slot's sum as fp32. No atomics: the same inputs give the
//   same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int UNROLL = 2;
// elements of one leaf a block takes: a multiple of THREADS * VEC * UNROLL,
// so every chunk starts on a whole vector
constexpr int CHUNK = 16384;
constexpr int MAX_LEAVES = 768;
constexpr int MAX_SLOTS = 1024;

// bits of a leaf's `meta`
constexpr int GROUP1 = 1;  // the second learning-rate group
constexpr int P_BF16 = 2;
constexpr int M_BF16 = 4;
constexpr int G_BF16 = 8;

struct AdamTable {
  const void* g[MAX_LEAVES];
  void* p[MAX_LEAVES];
  void* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int numel[MAX_LEAVES];
  int chunk_end[MAX_LEAVES];
  unsigned char meta[MAX_LEAVES];
};

// the update's scalars, each as the plain loop hands it to the card: fp32
// values of the host's Python floats
struct Hyper {
  float c1, b1, c2, b2;    // 1 - b1, b1, 1 - b2, b2
  float inv_bc1, inv_bc2;  // 1.0f / bias correction, in fp32 on the host
  float eps, wd, max_norm;
  float neg_lr[2];         // -lr of each group
};

struct NormTable {
  const void* t[MAX_LEAVES];
  int numel[MAX_LEAVES];
  int chunk_end[MAX_LEAVES];
  unsigned char bf16[MAX_LEAVES];
};

struct SlotTable {
  int end[MAX_SLOTS];  // running count of blocks (partials) through slot s
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[VEC]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = bf16_bits_to_float(t.x & 0xffffu);
  x[1] = bf16_bits_to_float(t.x >> 16);
  x[2] = bf16_bits_to_float(t.y & 0xffffu);
  x[3] = bf16_bits_to_float(t.y >> 16);
}
__device__ __forceinline__ void store4(float* p, const float (&x)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[VEC]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
}

template <typename T>
__device__ __forceinline__ bool vec_aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(T) * VEC) == 0;
}

// the leaf of block `b`: the first i with chunk_end[i] > b
__device__ __forceinline__ int find_leaf(const int* chunk_end, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk_end[mid] > b) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// the end of the block that starts at `start` of a leaf of `numel`
__device__ __forceinline__ int64_t chunk_stop(int numel, int64_t start) {
  return start + CHUNK < (int64_t)numel ? start + CHUNK : (int64_t)numel;
}

// one element of the update, as training/optim.py::AdamW's plain loop
// computes it on the card
template <bool P_IS_BF16>
__device__ __forceinline__ void adam_elem(const Hyper& h, float neg_lr,
                                          bool clip, float gn, float g,
                                          float& p, float& m, float& v) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, gn), h.max_norm);
  const float mu = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1, m));
  const float nu = __fadd_rn(__fmul_rn(__fmul_rn(h.c2, g), g),
                             __fmul_rn(h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_bc2)), h.eps);
  float upd = __fdiv_rn(__fmul_rn(mu, h.inv_bc1), den);
  float wdp = __fmul_rn(h.wd, p);
  if (P_IS_BF16) wdp = round_bf16(wdp);
  upd = __fadd_rn(upd, wdp);
  float step = __fmul_rn(neg_lr, upd);
  if (P_IS_BF16) step = round_bf16(step);
  p = __fadd_rn(p, step);
  m = mu;
  v = nu;
}

template <typename P, typename M, typename G>
__device__ void adam_span(P* __restrict__ p, M* __restrict__ m,
                          float* __restrict__ v, const G* __restrict__ g,
                          int64_t start, int64_t end, const Hyper& h,
                          float neg_lr, bool clip, float gn) {
  constexpr bool PB = sizeof(P) == 2;
  const bool has_g = g != nullptr;
  const bool vec = vec_aligned(p) && vec_aligned(m) && vec_aligned(v) &&
                   (!has_g || vec_aligned(g));
  int64_t head = start;
  if (vec) {
    const int64_t vend = start + (end - start) / VEC * VEC;
    constexpr int64_t STRIDE = (int64_t)THREADS * VEC;
    for (int64_t i0 = start + (int64_t)threadIdx.x * VEC; i0 < vend;
         i0 += STRIDE * UNROLL) {
      float pv[UNROLL][VEC], mv[UNROLL][VEC], vv[UNROLL][VEC],
          gv[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * STRIDE;
        if (i < vend) {
          load4(p + i, pv[u]);
          load4(m + i, mv[u]);
          load4(v + i, vv[u]);
          if (has_g) {
            load4(g + i, gv[u]);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) gv[u][k] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = i0 + u * STRIDE;
        if (i < vend) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            adam_elem<PB>(h, neg_lr, clip, gn, gv[u][k], pv[u][k], mv[u][k],
                          vv[u][k]);
          store4(p + i, pv[u]);
          store4(m + i, mv[u]);
          store4(v + i, vv[u]);
        }
      }
    }
    head = vend;
  }
  for (int64_t i = head + threadIdx.x; i < end; i += THREADS) {
    float pf = load1(p + i), mf = load1(m + i), vf = v[i];
    const float gf = has_g ? load1(g + i) : 0.f;
    adam_elem<PB>(h, neg_lr, clip, gn, gf, pf, mf, vf);
    store1(p + i, pf);
    store1(m + i, mf);
    v[i] = vf;
  }
}

template <typename P, typename M>
__device__ void adam_span_g(const AdamTable& t, int leaf, int64_t start,
                            int64_t end, const Hyper& h, float neg_lr,
                            bool clip, float gn) {
  P* p = static_cast<P*>(t.p[leaf]);
  M* m = static_cast<M*>(t.m[leaf]);
  if (t.meta[leaf] & G_BF16)
    adam_span(p, m, t.v[leaf], static_cast<const __nv_bfloat16*>(t.g[leaf]),
              start, end, h, neg_lr, clip, gn);
  else
    adam_span(p, m, t.v[leaf], static_cast<const float*>(t.g[leaf]), start,
              end, h, neg_lr, clip, gn);
}

__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const __grid_constant__ AdamTable t, const int n,
                 const __grid_constant__ Hyper h,
                 const float* __restrict__ g_norm) {
  const int b = blockIdx.x;
  const int leaf = find_leaf(t.chunk_end, n, b);
  const int first = leaf ? t.chunk_end[leaf - 1] : 0;
  const int64_t start = (int64_t)(b - first) * CHUNK;
  const int64_t end = chunk_stop(t.numel[leaf], start);
  const float gn = *g_norm;
  const bool clip = !(gn < h.max_norm);
  const int meta = t.meta[leaf];
  const float neg_lr = h.neg_lr[meta & GROUP1];
  switch (meta & (P_BF16 | M_BF16)) {
    case 0:
      adam_span_g<float, float>(t, leaf, start, end, h, neg_lr, clip, gn);
      break;
    case M_BF16:
      adam_span_g<float, __nv_bfloat16>(t, leaf, start, end, h, neg_lr, clip,
                                        gn);
      break;
    case P_BF16:
      adam_span_g<__nv_bfloat16, float>(t, leaf, start, end, h, neg_lr, clip,
                                        gn);
      break;
    default:
      adam_span_g<__nv_bfloat16, __nv_bfloat16>(t, leaf, start, end, h,
                                                neg_lr, clip, gn);
  }
}

// the block's sum of `x` over its threads, in a fixed order; valid in
// thread 0
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename T>
__device__ double sq_span(const T* __restrict__ x, int64_t start,
                          int64_t end) {
  double acc = 0.0;
  int64_t head = start;
  if (vec_aligned(x)) {
    const int64_t vend = start + (end - start) / VEC * VEC;
    for (int64_t i = start + (int64_t)threadIdx.x * VEC; i < vend;
         i += (int64_t)THREADS * VEC) {
      float xv[VEC];
      load4(x + i, xv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc += (double)__fmul_rn(xv[k], xv[k]);
    }
    head = vend;
  }
  for (int64_t i = head + threadIdx.x; i < end; i += THREADS) {
    const float xf = load1(x + i);
    acc += (double)__fmul_rn(xf, xf);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
    sq_norm_partial_kernel(const __grid_constant__ NormTable t, const int n,
                           double* __restrict__ partial) {
  const int b = blockIdx.x;
  const int leaf = find_leaf(t.chunk_end, n, b);
  const int first = leaf ? t.chunk_end[leaf - 1] : 0;
  const int64_t start = (int64_t)(b - first) * CHUNK;
  const int64_t end = chunk_stop(t.numel[leaf], start);
  const double acc =
      t.bf16[leaf]
          ? sq_span(static_cast<const __nv_bfloat16*>(t.t[leaf]), start, end)
          : sq_span(static_cast<const float*>(t.t[leaf]), start, end);
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) partial[b] = sum;
}

__global__ void __launch_bounds__(THREADS)
    sq_norm_finish_kernel(const __grid_constant__ SlotTable s,
                          const double* __restrict__ partial,
                          float* __restrict__ out) {
  const int slot = blockIdx.x;
  const int begin = slot ? s.end[slot - 1] : 0;
  double acc = 0.0;
  for (int i = begin + threadIdx.x; i < s.end[slot]; i += THREADS)
    acc += partial[i];
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) out[slot] = (float)sum;
}

int setup(int device) { return (int)cudaSetDevice(device); }

}  // namespace

// The build's limits: 0 -> CHUNK (elements a block takes), 1 -> MAX_LEAVES
// (leaves a launch takes), 2 -> MAX_SLOTS (slots sq_norm_multi sums).
extern "C" int adamw_multi_limit(int which) {
  switch (which) {
    case 0: return CHUNK;
    case 1: return MAX_LEAVES;
    case 2: return MAX_SLOTS;
    default: return -1;
  }
}

// One launch of the update over `n_leaves` leaves (1..MAX_LEAVES), all on
// `device`. Host arrays: `ptrs` uint64[4 * n] = the gradients' pointers
// (0 reads as a zero gradient), then the parameters', the first moments'
// and the second moments' (fp32); `ints` int32[3 * n] = each leaf's numel,
// the running count of its CHUNK-element blocks, its meta bits (GROUP1,
// P_BF16, M_BF16, G_BF16); `hyper` fp32[11] = Hyper in order. `g_norm`: the
// global norm, one fp32 in device memory. Every leaf contiguous. Launches on
// `stream` and returns the launch's cudaError_t; neither allocates nor
// synchronises.
extern "C" int adamw_multi(const void* ptrs, const void* ints,
                           const void* hyper, const void* g_norm,
                           int n_leaves, int device, void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || g_norm == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint64_t* ptr = static_cast<const uint64_t*>(ptrs);
  const int* in = static_cast<const int*>(ints);
  const float* hp = static_cast<const float*>(hyper);
  AdamTable t;
  for (int i = 0; i < n_leaves; ++i) {
    t.g[i] = reinterpret_cast<const void*>(ptr[i]);
    t.p[i] = reinterpret_cast<void*>(ptr[n_leaves + i]);
    t.m[i] = reinterpret_cast<void*>(ptr[2 * n_leaves + i]);
    t.v[i] = reinterpret_cast<float*>(ptr[3 * n_leaves + i]);
    t.numel[i] = in[i];
    t.chunk_end[i] = in[n_leaves + i];
    t.meta[i] = (unsigned char)in[2 * n_leaves + i];
    if (t.numel[i] < 0 || (t.numel[i] > 0 && (!t.p[i] || !t.m[i] || !t.v[i])))
      return (int)cudaErrorInvalidValue;
  }
  const Hyper h = {hp[0], hp[1], hp[2], hp[3], hp[4], hp[5],
                   hp[6], hp[7], hp[8], {hp[9], hp[10]}};
  const int blocks = t.chunk_end[n_leaves - 1];
  if (blocks <= 0) return 0;
  int err = setup(device);
  if (err) return err;
  adamw_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, n_leaves, h, static_cast<const float*>(g_norm));
  return (int)cudaGetLastError();
}

// The sums of squares of `n_leaves` leaves (0..MAX_LEAVES), all on
// `device`: one partial per CHUNK-element block into `scratch` (double) from
// block `chunk_base` on; with `finish`, then each of the `n_slots` slots'
// sums (slot s adds the partials [slot_ends[s - 1], slot_ends[s])) into
// `out` (fp32[n_slots]). Host arrays: `ptrs` uint64[n] = the leaves'
// pointers; `ints` int32[3 * n] = numel, the running count of blocks within
// this call, 1 for bf16 (else fp32); `slot_ends` int32[n_slots]. A list of
// more than MAX_LEAVES leaves takes several calls over one scratch, the last
// with `finish`. Launches on `stream` and returns the launches'
// cudaError_t; neither allocates nor synchronises.
extern "C" int sq_norm_multi(const void* ptrs, const void* ints,
                             const void* slot_ends, void* scratch, void* out,
                             int n_leaves, int chunk_base, int n_slots,
                             int finish, int device, void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES || chunk_base < 0 ||
      scratch == nullptr || (finish && (n_slots <= 0 || n_slots > MAX_SLOTS ||
                                        out == nullptr)))
    return (int)cudaErrorInvalidValue;
  int err = setup(device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* partial = static_cast<double*>(scratch);
  if (n_leaves > 0) {
    const uint64_t* ptr = static_cast<const uint64_t*>(ptrs);
    const int* in = static_cast<const int*>(ints);
    NormTable t;
    for (int i = 0; i < n_leaves; ++i) {
      t.t[i] = reinterpret_cast<const void*>(ptr[i]);
      t.numel[i] = in[i];
      t.chunk_end[i] = in[n_leaves + i];
      t.bf16[i] = (unsigned char)(in[2 * n_leaves + i] != 0);
      if (t.numel[i] < 0 || (t.numel[i] > 0 && !t.t[i]))
        return (int)cudaErrorInvalidValue;
    }
    const int blocks = t.chunk_end[n_leaves - 1];
    if (blocks > 0) {
      sq_norm_partial_kernel<<<blocks, THREADS, 0, s>>>(t, n_leaves,
                                                        partial + chunk_base);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  if (finish) {
    SlotTable st;
    const int* ends = static_cast<const int*>(slot_ends);
    for (int i = 0; i < n_slots; ++i) st.end[i] = ends[i];
    sq_norm_finish_kernel<<<n_slots, THREADS, 0, s>>>(
        st, partial, static_cast<float*>(out));
    err = (int)cudaGetLastError();
  }
  return err;
}
