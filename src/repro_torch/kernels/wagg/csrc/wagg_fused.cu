// Fused WASGD weighted aggregation (the paper's Eq. 10) for Hopper (sm_90a),
// for a whole tree's worker leaves in a few grouped launches.
//
// Replaces the Pallas TPU kernel `wagg_fused` in
// src/repro/kernels/wagg/wagg.py:88 (body `_wagg_kernel`, :67; `wagg` :139
// delegates to it). It computes the same function, not the same schedule.
// For each leaf of a launch:
//   x (p, N) in float32 or bfloat16, payload (p, N) in float32, bfloat16 or
//   int8 (or x itself), s the leaf's codec scale (float32 or bfloat16; 1
//   without one), theta (p,) float32 and active (p,) float32 0/1 or none,
//   both shared by every leaf of the launch ->
//     t[j]      = theta[j] * s                    (rounded once in float32)
//     m[n]      = sum_{j=0..p-1} t[j] * float(payload[j, n])
//     out[i, n] = (1 - beta) * x[i, n] + beta * m[n]        (active row)
//     out[i, n] = m[n]                                      (inactive row)
//   in x's type. The sum is float32 fmaf in the order j = 0, 1, ..., p-1,
//   and the FMA is fmaf(1 - beta, x, beta * m): a leaf's output does not
//   depend on the leaves it is grouped with, and tools/wagg_parent_bitwise.py
//   holds it bitwise to an older checkout's one-leaf kernel.
//
// Bound. Each element of x (and of a separate payload) is read once and
// each output element written once, against 2p + 3 FLOP per column: well
// under one FLOP per byte, so the bound is the bytes over the memory rate,
// p * N * (2 * sizeof(x) + sizeof(payload)) / 3.35 TB/s. For a tree of
// small leaves (CNN6: 6 leaves, 18,378 columns) the bound is a fraction
// of a microsecond and a launch costs more than the bytes.
//
// Design against that bound:
//   * One launch takes a table of up to kMaxLeaves leaves by value (a
//     __grid_constant__ parameter, 3,872 bytes, under the 4 KB limit): each
//     leaf's x, payload, out and scale pointers, its column count, its first
//     chunk and whether its rows are aligned. The wrapper puts every leaf of
//     a tree with the same (x, payload) types into ceil(leaves / 80)
//     launches: on leaves this small a launch costs more than the bytes.
//     The codec's scale is folded into theta here, so it needs no launch
//     of its own.
//   * Mapping: one block per chunk of kThreads * V columns of one leaf, the
//     leaves' chunks numbered one after another (the table's `chunk_begin`
//     is their prefix sum). A block finds its leaf by a binary search over
//     the table (at most 7 steps for 80 leaves, uniform across the block).
//     This is multi_tensor_apply's block-to-tensor map, computed instead of
//     stored, so the table holds 80 leaves and not a block list. A grid of
//     one block per chunk, rather than a persistent grid, lets the hardware
//     hand out the last wave's chunks as blocks finish: a large leaf (7,776
//     chunks for a gemma3-1b MLP matrix) loses no quantisation tail to a
//     fixed block-to-chunk assignment.
//   * Each element of x is read once: for p up to PMAX (4 or 8, a template
//     parameter; every p the repo trains with) a thread loads all p rows of
//     its columns into registers, raw, before the first FMA, so p 16-byte
//     loads are in flight per thread; it forms m and then writes the p
//     outputs from the same registers. A separate payload is read the same
//     way, then x (active rows only). A larger p (PMAX 0) loops over the
//     rows and reloads x in the second pass (from L1/L2 when x is the
//     payload).
//   * V = 16 bytes of x per thread (4 float32 or 8 bfloat16 columns). A leaf
//     whose rows all start on a vector boundary (aligned base pointers, and
//     N a multiple of V when p > 1) takes 16-byte loads and stores, with a
//     scalar tail for the last partial vector (p = 1). Any other leaf takes
//     the strided path: lane l of a warp owns columns l, l + 32, ...,
//     l + 32 (V - 1) of its warp's 32 V columns, so every load is still
//     coalesced across the warp and a thread has V independent loads in
//     flight per row, with no padding copy.
//   * Stores of out are streaming (st.global.cs: evict-first), so a
//     stream larger than L2 does not evict what the rest of the round
//     keeps there. Loads of x and of the payload take the read-only path
//     (ld.global.nc) with no eviction hint: ld.global.cs on them measured
//     1-2% slower at the gemma3-1b MLP leaf (tools/wagg_hints.py, PERF.md).
//   * Inactive rows (the Alg. 4 late-join) write m, and with a separate
//     payload never read x. The mask is a template parameter (MASKED, the
//     last one), so a profile tells the masked launches apart.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 80;
constexpr int kAligned = 1;        // Leaf::flags: rows start on a vector boundary
constexpr int kScaleBf16 = 2;      // Leaf::flags: the scale is bfloat16

// One leaf of a launch (48 bytes; the Python wrapper mirrors it).
struct Leaf {
  const void* x;
  const void* q;        // the payload, or x
  void* out;
  const void* scale;    // the codec's scale (one element) or null
  long long n;          // columns
  int chunk_begin;      // first chunk of this leaf in the launch
  int flags;
};

struct Group {
  Leaf leaf[kMaxLeaves];
  const float* theta;
  const float* active;
  int count;
  int p;
  float keep;           // 1 - beta, rounded once to float32 by the caller
  float beta;
};
static_assert(sizeof(Leaf) == 48, "Leaf layout is mirrored in wagg.py");
static_assert(sizeof(Group) <= 4096, "kernel parameters exceed 4 KB");

// The payload is x itself (the f32 codec, or a bf16 payload of bf16 x).
struct SameAsX {};

template <typename X, typename Q> struct Payload { using T = Q; };
template <typename X> struct Payload<X, SameAsX> { using T = X; };

__device__ __forceinline__ float bf16_bits_to_f32(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned f32_to_bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// The raw bits of one thread's V columns of one row: B bytes, little-endian
// in 32-bit words, as a vector load leaves them.
template <int B> struct Raw { unsigned w[B / 4]; };

// A B-byte load of an address aligned to min(B, 16), by the read-only
// path (ld.global.nc).
template <int B>
__device__ __forceinline__ void load_raw(Raw<B>& r, const void* ptr) {
  if constexpr (B == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(ptr));
  } else if constexpr (B == 8) {
    const uint2 t = __ldg(static_cast<const uint2*>(ptr));
    r.w[0] = t.x; r.w[1] = t.y;
  } else {
    const uint4* p = static_cast<const uint4*>(ptr);
#pragma unroll
    for (int h = 0; h < B / 16; ++h) {
      const uint4 t = __ldg(p + h);
      r.w[4 * h] = t.x; r.w[4 * h + 1] = t.y;
      r.w[4 * h + 2] = t.z; r.w[4 * h + 3] = t.w;
    }
  }
}

// One element's bits, zero-extended.
template <typename T>
__device__ __forceinline__ unsigned load_bits(const T* ptr) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const unsigned*>(ptr));
  } else if constexpr (sizeof(T) == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(ptr));
  } else {
    return __ldg(reinterpret_cast<const unsigned char*>(ptr));
  }
}

// Column k of a row's raw bits, widened to float32.
template <typename T, int B>
__device__ __forceinline__ float widen(const Raw<B>& r, int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[k]);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned w = r.w[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {                                        // int8, sign-extended
    return static_cast<float>(static_cast<int>(r.w[k >> 2] << (24 - 8 * (k & 3))) >> 24);
  }
}

// The V columns c0 + k * step (k < V) of one row. VEC: the columns are
// contiguous, in range and aligned (step 1), one vector load. Otherwise
// element loads, each column checked against n.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_cols(Raw<V * sizeof(T)>& r, const T* row,
                                          long long c0, int step, long long n) {
  if constexpr (VEC) {
    load_raw<V * sizeof(T)>(r, row + c0);
  } else {
#pragma unroll
    for (int w = 0; w < V * static_cast<int>(sizeof(T)) / 4; ++w) r.w[w] = 0u;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long c = c0 + static_cast<long long>(k) * step;
      if (c < n) {
        const int byte = k * static_cast<int>(sizeof(T));
        r.w[byte >> 2] |= load_bits<T>(row + c) << (8 * (byte & 3));
      }
    }
  }
}

// Stores V float32 values to the columns c0 + k * step of a row of out,
// narrowed to X (bfloat16: round to nearest even, as torch's casts do).
template <typename X, int V, bool VEC>
__device__ __forceinline__ void store_cols(X* row, long long c0, int step,
                                           long long n, const float* o) {
  if constexpr (VEC) {
    uint4 t;
    if constexpr (sizeof(X) == 4) {
      t = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                     __float_as_uint(o[2]), __float_as_uint(o[3]));
    } else {
      unsigned w[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        w[h] = f32_to_bf16_bits(o[2 * h]) | (f32_to_bf16_bits(o[2 * h + 1]) << 16);
      t = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __stcs(reinterpret_cast<uint4*>(row + c0), t);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long c = c0 + static_cast<long long>(k) * step;
      if (c < n) {
        if constexpr (sizeof(X) == 4) {
          __stcs(reinterpret_cast<unsigned*>(row + c), __float_as_uint(o[k]));
        } else {
          __stcs(reinterpret_cast<unsigned short*>(row + c),
                 static_cast<unsigned short>(f32_to_bf16_bits(o[k])));
        }
      }
    }
  }
}

__device__ __forceinline__ bool row_active(const Group& g, int i) {
  return g.active == nullptr || __ldg(g.active + i) != 0.f;
}

// m += theta[j] * s * payload row j, column by column.
template <typename T, int V, int B>
__device__ __forceinline__ void accumulate(float* m, const Raw<B>& r, float t) {
#pragma unroll
  for (int k = 0; k < V; ++k) m[k] = __fmaf_rn(t, widen<T>(r, k), m[k]);
}

// Writes one row of out: the FMA against x (xr, read only for an active
// row) or m.
template <typename X, int V, bool VEC>
__device__ __forceinline__ void emit(const Group& g, X* row, long long c0,
                                     int step, long long n, const float* m,
                                     const Raw<16>& xr, bool act) {
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    o[k] = act ? __fmaf_rn(g.keep, widen<X>(xr, k), __fmul_rn(g.beta, m[k])) : m[k];
  store_cols<X, V, VEC>(row, c0, step, n, o);
}

// One thread's V columns of one leaf: all p rows in, m, all p rows out.
template <typename X, typename Q, int PMAX, bool MASKED, bool VEC>
__device__ __forceinline__ void columns(const Group& g, const Leaf& L, float s,
                                        long long c0, int step) {
  using QT = typename Payload<X, Q>::T;
  constexpr bool kSelf = std::is_same<Q, SameAsX>::value;
  constexpr int V = 16 / sizeof(X);
  constexpr int BQ = V * sizeof(QT);
  const int p = g.p;
  const long long n = L.n;
  const X* x = static_cast<const X*>(L.x);
  const QT* q = static_cast<const QT*>(L.q);
  X* out = static_cast<X*>(L.out);
  float m[V];
#pragma unroll
  for (int k = 0; k < V; ++k) m[k] = 0.f;
  if constexpr (PMAX > 0) {
    Raw<BQ> hq[PMAX];
#pragma unroll
    for (int j = 0; j < PMAX; ++j)
      if (j < p) load_cols<QT, V, VEC>(hq[j], q + j * n, c0, step, n);
#pragma unroll
    for (int j = 0; j < PMAX; ++j)
      if (j < p) accumulate<QT, V>(m, hq[j], __fmul_rn(__ldg(g.theta + j), s));
    if constexpr (kSelf) {
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        if (i < p)
          emit<X, V, VEC>(g, out + i * n, c0, step, n, m, hq[i],
                          !MASKED || row_active(g, i));
    } else {
      Raw<16> hx[PMAX];
      bool act[PMAX];
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        act[i] = i < p && (!MASKED || row_active(g, i));
        if (act[i]) load_cols<X, V, VEC>(hx[i], x + i * n, c0, step, n);
      }
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        if (i < p) emit<X, V, VEC>(g, out + i * n, c0, step, n, m, hx[i], act[i]);
    }
  } else {
    // rows past the register budget: the FMA pass reloads x, which the
    // sum pass left in L1/L2 when it is the payload
    for (int j = 0; j < p; ++j) {
      Raw<BQ> v;
      load_cols<QT, V, VEC>(v, q + j * n, c0, step, n);
      accumulate<QT, V>(m, v, __fmul_rn(__ldg(g.theta + j), s));
    }
    for (int i = 0; i < p; ++i) {
      const bool act = !MASKED || row_active(g, i);
      Raw<16> v;
      if (act) load_cols<X, V, VEC>(v, x + i * n, c0, step, n);
      emit<X, V, VEC>(g, out + i * n, c0, step, n, m, v, act);
    }
  }
}

template <typename X, typename Q, int PMAX, bool MASKED>
__global__ void __launch_bounds__(kThreads)
wagg_fused_kernel(const __grid_constant__ Group g) {
  constexpr int V = 16 / sizeof(X);
  const int chunk = static_cast<int>(blockIdx.x);
  int lo = 0, hi = g.count - 1;         // the last leaf starting at or before chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.leaf[mid].chunk_begin <= chunk) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = g.leaf[lo];
  const long long base = static_cast<long long>(chunk - L.chunk_begin) * (kThreads * V);
  float s = 1.f;
  if (L.scale != nullptr)
    s = (L.flags & kScaleBf16)
        ? bf16_bits_to_f32(__ldg(static_cast<const unsigned short*>(L.scale)))
        : __ldg(static_cast<const float*>(L.scale));
  if (L.flags & kAligned) {
    const long long c0 = base + static_cast<long long>(threadIdx.x) * V;
    if (c0 + V <= L.n) {
      columns<X, Q, PMAX, MASKED, true>(g, L, s, c0, 1);
    } else if (c0 < L.n) {                   // the scalar tail
      columns<X, Q, PMAX, MASKED, false>(g, L, s, c0, 1);
    }
  } else {
    const long long c0 = base + (threadIdx.x >> 5) * (32 * V) + (threadIdx.x & 31);
    if (c0 < L.n) columns<X, Q, PMAX, MASKED, false>(g, L, s, c0, 32);
  }
}

template <typename X, typename Q, int PMAX>
int launch(const Group& g, int chunks, cudaStream_t stream) {
  if (g.active != nullptr)
    wagg_fused_kernel<X, Q, PMAX, true><<<chunks, kThreads, 0, stream>>>(g);
  else
    wagg_fused_kernel<X, Q, PMAX, false><<<chunks, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename Q>
int dispatch_p(const Group& g, int chunks, cudaStream_t stream) {
  if (g.p <= 4) return launch<X, Q, 4>(g, chunks, stream);
  if (g.p <= 8) return launch<X, Q, 8>(g, chunks, stream);
  return launch<X, Q, 0>(g, chunks, stream);
}

template <typename X>
int dispatch_q(const Group& g, int q_dtype, int chunks, cudaStream_t stream) {
  switch (q_dtype) {
    case 0: return dispatch_p<X, float>(g, chunks, stream);
    case 1: return dispatch_p<X, __nv_bfloat16>(g, chunks, stream);
    case 2: return dispatch_p<X, int8_t>(g, chunks, stream);
    case 3: return dispatch_p<X, SameAsX>(g, chunks, stream);
    default: return -1;
  }
}

}  // namespace

// One grouped launch over `count` leaves (1 <= count <= 80) that share p,
// theta, the mask, beta and the dtypes. leaves[i].chunk_begin is the prefix
// sum of the leaves' chunk counts, ceil(n / (256 * V)) with V = 4 for
// float32 x and 8 for bfloat16 x, and `chunks` their total. dtype codes:
// 0 = float32, 1 = bfloat16, 2 = int8, 3 = the payload is x. x_dtype in
// {0, 1}, q_dtype in {0, 1, 2, 3}. active may be null (no mask). keep =
// 1 - beta and beta are computed by the caller in double and rounded once
// to float32. Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported configuration.
extern "C" int wagg_fused_launch(const void* leaves, int count, int chunks,
                                 const void* theta, const void* active, int p,
                                 int x_dtype, int q_dtype, float keep,
                                 float beta, void* stream) {
  if (count < 1 || count > kMaxLeaves || chunks < 1 || p < 1) return -1;
  Group g;
  const Leaf* in = static_cast<const Leaf*>(leaves);
  for (int i = 0; i < count; ++i) {
    g.leaf[i] = in[i];
    if (in[i].n < 1) return -1;
    if (in[i].chunk_begin >= chunks || (i > 0 && in[i].chunk_begin <= in[i - 1].chunk_begin))
      return -1;
  }
  if (in[0].chunk_begin != 0) return -1;
  g.theta = static_cast<const float*>(theta);
  g.active = static_cast<const float*>(active);
  g.count = count;
  g.p = p;
  g.keep = keep;
  g.beta = beta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_q<float>(g, q_dtype, chunks, s);
  if (x_dtype == 1) return dispatch_q<__nv_bfloat16>(g, q_dtype, chunks, s);
  return -1;
}
