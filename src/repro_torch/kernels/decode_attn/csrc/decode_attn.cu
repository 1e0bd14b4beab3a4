// Single-token GQA flash-decode attention over a contiguous KV cache for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attn` in
// src/repro/kernels/decode_attn/decode_attn.py:78 (body `_decode_kernel`,
// :34). Same function, not the same schedule:
//   q (b, kv, g, hd) and k, v (b, S, kv, hd), each in float32 or bfloat16
//   (any pair), one cache_len for the whole batch -> out (b, kv, g, hd) in
//   q's type; 1 <= g <= 8, hd a multiple of 16 up to 256.
//   q is scaled by hd^-0.5 in float32; scores, softmax and the V sum run in
//   float32. Position t is valid iff t < cache_len and, with a window,
//   cache_len - 1 - t < window. Running max starts at -1e30, the exponent
//   is taken against m_safe = max(m, -0.5e30) and the denominator is
//   floored at 1e-30, as in the Pallas kernel.
//
// Bound. A decode step reads q, the K and V rows of the valid positions
// once each and writes the output once. gemma3-1b (kv 1, g 4, hd 256,
// bf16) reads 1 KiB of K+V per valid token for 8 * g * hd = 8 KiFLOP: 8
// FLOP a byte, far below the card's ridge, so the bound is the bytes over
// the memory rate: 1 MiB (0.31 us) per request at a 512-token ring, 2 MiB
// (0.63 us) at a full 1024-token cache.
//
// Design against that bound (the paged kernel's, on a contiguous cache):
//   * The TPU grid axis over cache blocks ran in order and carried the
//     softmax state in scratch. Here the positions are split across CUDA
//     blocks (grid.x = splits, grid.y = b * kv): a grid of (b, kv) alone is
//     4 blocks on 132 SMs at the legacy engine's batch. Each block writes a
//     partial (m, l, acc) to float32 scratch that the wrapper allocates,
//     and a second small kernel merges the splits (one block per query
//     head, one thread per output element).
//   * Dead positions are skipped before any load: a block clips its range
//     to the valid one [cache_len - window, cache_len), so a split wholly
//     past cache_len loads nothing and writes an empty partial state.
//   * cache_len comes as a kernel argument (the legacy engine knows it on
//     the host: no device-to-host read per step), or from device memory
//     when the caller gives a device scalar.
//   * A warp owns one position at a time; lane l holds the elements
//     (j * 32 + l) * CE + [0, CE) for j < J of the g query rows and of the
//     position's K/V row, in registers, so the g rows share each K/V load
//     (16-byte loads for bf16 at hd = 256). Fast paths fix (G, CE, J) to
//     the configs' shapes (gemma3-1b: g 4, hd 256 = 32 x 8; stablelm-1.6b:
//     g 1, hd 64 = 32 x 2); the generic path (G = 8, CE = 2, J = 4) masks
//     lanes past hd and heads past g, for any hd that is a multiple of 16
//     up to 256 (80) and any g up to 8 (7). Warps of a block merge through
//     shared memory.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMSafeFloor = -0.5e30f;
constexpr float kDenFloor = 1e-30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 64;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };

// Loads N contiguous elements (N * sizeof(T) bytes, aligned to that size up
// to 16) and widens them to float.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / (int)sizeof(T);
  using V = typename Vec<kChunk>::type;
  const V* src = reinterpret_cast<const V*>(p);
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c) {
    V raw = src[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32<T>(e[i]);
  }
}

// One block: one (request, kv head) pair and one split of the positions.
// Writes the split's partial softmax state (m, l, acc), with l and acc
// taken against max(m, -0.5e30).
// FIXED: g == G and hd == 32 * CE * J, known at compile time (a fast path).
template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
__global__ void __launch_bounds__(kThreads)
decode_partial(const TQ* __restrict__ q, const TKV* __restrict__ k,
               const TKV* __restrict__ v, const int* __restrict__ len_dev,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int kv, int g_rt, int hd_rt, int S,
               int per_split, int len_host, int window, float scale) {
  constexpr int E = CE * J;                 // elements a lane holds
  constexpr int HDM = E * 32;               // the widest hd of this path
  const int g = FIXED ? G : g_rt;
  const int hd = FIXED ? HDM : hd_rt;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.y;  // request * kv + kv head
  const int bi = bk / kv;
  const int kh = bk - bi * kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int cache_len = len_dev != nullptr ? *len_dev : len_host;
  const int hi = min(min(cache_len, S), (split + 1) * per_split);
  int lo = split * per_split;
  if (window > 0) lo = max(lo, cache_len - window);

  // this lane's elements of the q rows, scaled; lanes past hd and rows
  // past g hold zeros
  float qr[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e0 = (j * 32 + lane) * CE;
      if (gi < g && e0 < hd) {
        load_f32<TQ, CE>(q + ((size_t)bk * g + gi) * hd + e0, &qr[gi][j * CE]);
#pragma unroll
        for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] *= scale;
      } else {
#pragma unroll
        for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] = 0.f;
      }
    }
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  for (int t = lo + warp; t < hi; t += kWarps) {
    const size_t row = ((size_t)bi * S + t) * kv + kh;
    float kr[E], vr[E];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e0 = (j * 32 + lane) * CE;
      if (e0 < hd) {
        load_f32<TKV, CE>(k + row * hd + e0, &kr[j * CE]);
        load_f32<TKV, CE>(v + row * hd + e0, &vr[j * CE]);
      } else {
#pragma unroll
        for (int c = 0; c < CE; ++c) kr[j * CE + c] = vr[j * CE + c] = 0.f;
      }
    }
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) a = fmaf(qr[gi][e], kr[e], a);
      s[gi] = a;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        if (gi < g) s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], off);
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
      const float m_new = fmaxf(m[gi], s[gi]);
      const float m_safe = fmaxf(m_new, kMSafeFloor);
      const float p = expf(s[gi] - m_safe);
      const float corr = expf(m[gi] - m_safe);
      l[gi] = l[gi] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(acc[gi][e], corr, p * vr[e]);
      m[gi] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HDM];
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int c = 0; c < CE; ++c)
        sm_acc[warp][gi][(j * 32 + lane) * CE + c] = acc[gi][j * CE + c];
    }
  }
  __syncthreads();

  const size_t base = ((size_t)bk * n_split + split) * g;
  for (int o = threadIdx.x; o < g * hd; o += kThreads) {
    const int gi = o / hd;
    const int d = o - gi * hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    const float mx_safe = fmaxf(mx, kMSafeFloor);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(fmaxf(sm_m[w][gi], kMSafeFloor) - mx_safe);
      num = fmaf(c, sm_acc[w][gi][d], num);
      den = fmaf(c, sm_l[w][gi], den);
    }
    part_acc[(base + gi) * hd + d] = num;
    if (d == 0) {
      part_m[base + gi] = mx;
      part_l[base + gi] = den;
    }
  }
}

// Merges the splits of one (request, kv head, query head) triple and writes
// its output row. The first warp reduces the splits' (m, l) into per-split
// weights in shared memory; then each thread owns one output element and
// sums the splits' acc rows, which neighbouring threads read contiguously.
template <typename TQ>
__global__ void decode_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     TQ* __restrict__ out, int g_heads, int hd,
                                     int n_split) {
  __shared__ float sm_c[kMaxSplits];
  __shared__ float sm_den;
  const int bk = blockIdx.x;
  const int g = blockIdx.y;
  const size_t base = (size_t)bk * n_split;
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int s = threadIdx.x; s < n_split; s += 32)
      mx = fmaxf(mx, part_m[(base + s) * g_heads + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mx_safe = fmaxf(mx, kMSafeFloor);
    float den = 0.f;
    for (int s = threadIdx.x; s < n_split; s += 32) {
      const size_t r = (base + s) * g_heads + g;
      const float c = expf(fmaxf(part_m[r], kMSafeFloor) - mx_safe);
      sm_c[s] = c;
      den = fmaf(c, part_l[r], den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (threadIdx.x == 0) sm_den = fmaxf(den, kDenFloor);
  }
  __syncthreads();
  const float* acc = part_acc + (base * g_heads + g) * hd;
  const size_t stride = (size_t)g_heads * hd;  // from one split to the next
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) num = fmaf(sm_c[s], acc[s * stride + d], num);
    out[((size_t)bk * g_heads + g) * hd + d] = from_f32<TQ>(num / sm_den);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* len_dev;
  float* part_m;
  float* part_l;
  float* part_acc;
  void* out;
  int b, kv, g, hd, S, per_split, n_split, len_host, window;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
int launch(const Args& a) {
  const dim3 grid(a.n_split, a.b * a.kv);
  decode_partial<TQ, TKV, G, CE, J, FIXED><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.len_dev, a.part_m, a.part_l, a.part_acc,
      a.kv, a.g, a.hd, a.S, a.per_split, a.len_host, a.window, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one thread per output element of the head, as many as hd rounded up
  decode_combine<TQ><<<dim3(a.b * a.kv, a.g), (a.hd + 31) / 32 * 32, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<TQ*>(a.out), a.g, a.hd, a.n_split);
  return (int)cudaGetLastError();
}

// fast paths for the configs' shapes, the generic path for the rest
template <typename TQ, typename TKV>
int dispatch(const Args& a) {
  if (a.g == 4 && a.hd == 256) return launch<TQ, TKV, 4, 8, 1, true>(a);
  if (a.g == 1 && a.hd == 64) return launch<TQ, TKV, 1, 2, 1, true>(a);
  return launch<TQ, TKV, 8, 2, 4, false>(a);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, any (q, cache) pair. 1 <= g <= 8;
// hd a multiple of 16, 16 <= hd <= 256; 1 <= n_split <= 64 and n_split *
// per_split >= S.
// len_dev, when not null, points at an int32 cache_len in device memory
// and len_host is ignored. window <= 0 means no window. Returns 0, a
// cudaError_t from the launches, or -1 for an unsupported configuration.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* len_dev, void* part_m, void* part_l,
                                  void* part_acc, void* out, int q_dtype, int kv_dtype,
                                  int b, int kv, int g, int hd, int S, int per_split,
                                  int n_split, int len_host, int window, float scale,
                                  void* stream) {
  const Args a{q, k, v, static_cast<const int*>(len_dev), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc), out,
               b, kv, g, hd, S, per_split, n_split, len_host, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (n_split < 1 || n_split > kMaxSplits || (long long)n_split * per_split < S) return -1;
  if (g < 1 || g > 8 || hd < 16 || hd > 256 || hd % 16 != 0) return -1;
  if (q_dtype == 1 && kv_dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(a);
  if (q_dtype == 1 && kv_dtype == 0) return dispatch<__nv_bfloat16, float>(a);
  if (q_dtype == 0 && kv_dtype == 1) return dispatch<float, __nv_bfloat16>(a);
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(a);
  return -1;
}
