// Paged single-token GQA flash-decode attention for Hopper (sm_90a), in
// one launch.
//
// Replaces the Pallas TPU kernel `paged_decode_attn` in
// src/repro/kernels/decode_attn/paged.py:92 (body `_paged_decode_kernel`,
// :43). It computes the same function, not the same schedule:
//   q (b, kv, g, hd) and the K/V pools (n_pool, bs, kv, hd), each in
//   float32 or bfloat16 (any pair), block_table (b, n_blk) int32, index
//   (b,) int32 -> out (b, kv, g, hd) in q's type; 1 <= g <= 8, hd a
//   multiple of 16 up to 256.
//   q is scaled by hd^-0.5 in float32; scores, softmax and the V sum run in
//   float32. Linear layers keep slot <= index; ring layers keep
//   ((index - slot) mod R) < min(window, index + 1) with R = n_blk * bs.
//   Running max starts at -1e30, the exponent is taken against
//   m_safe = max(m, -0.5e30) and the denominator is floored at 1e-30, so a
//   row whose slots are all invalid gives finite output (0).
//
// Bound. A decode step reads q, the K and V rows of the valid slots once
// each, the table and the index, and writes the output once. With kv = 1,
// g = 4, hd = 256 that is 1 KiB of K+V (bf16) per valid token against
// 8 * g * hd = 8 KiFLOP, about 8 FLOP per byte: far below the card's
// ridge, so the bound is the bytes over the memory rate (0.0005 ms for
// the serve run's 4 x 512 tokens). Launch latency and the latency of a
// few dependent memory trips are what a call costs at that size.
//
// Design against that:
//   * One launch. The table is split across CUDA blocks (grid.x = splits
//     of kStage-token tiles, grid.y = b * kv): one block per (request, kv
//     head) would fill a handful of the 132 SMs. The splits of a row form
//     one thread block cluster (up to 16 blocks, H100's non-portable
//     limit). Each block merges its warps and keeps its partial (m, l,
//     acc) in its own shared memory; after a cluster barrier every block
//     reads all the row's (m, l) and merges its own slice of the output
//     from every block's acc through distributed shared memory, and a
//     second barrier keeps each block's memory alive until its peers have
//     read it. No scratch in device memory, no counters, no second
//     kernel: the launch is capturable in a CUDA graph and safe on any
//     number of streams.
//   * Memory-level parallelism. A block reads its slice of the block table
//     into shared memory once, then puts every valid token's K and V rows
//     of a 32-token tile in flight at once with 16-byte cp.async copies
//     into a shared-memory stage (two stages: the next tile's copies fly
//     while this one is computed), instead of one dependent global load
//     per token per warp. The dot products then read shared memory.
//   * Work follows validity. A split with no valid slot (past index on a
//     linear layer, outside the window on a ring) loads nothing and is
//     skipped by the merge; within a split, invalid slots are never copied.
//   * Lanes: a warp takes four slots of a stage at once (their dot
//     products and shuffles independent, one online-softmax update for
//     the four; exponents by the fast __expf); lane l holds the elements
//     (j * 32 + l) * CE + [0, CE) for j < J of q (g rows) and of the
//     slots' K/V rows. Fast paths fix (G, CE, J) to the configs' shapes
//     (gemma3-1b: g 4, hd 256 = 32 x 8; stablelm-1.6b: g 1, hd 64 =
//     32 x 2); the generic path (G = 8, CE = 2, J = 4) masks lanes past hd
//     and heads past g, for any hd that is a multiple of 16 up to 256 (80)
//     and any g up to 8 (7).
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMSafeFloor = -0.5e30f;
constexpr float kDenFloor = 1e-30f;
constexpr int kStage = 32;        // tokens per shared-memory stage
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTPW = kStage / kWarps;     // a warp's slots of a stage: 4
constexpr int kMaxSplits = 16;    // a cluster: H100's largest (non-portable)
constexpr int kTableCap = 1024;   // table entries one split may span

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
// to 16) from global or shared memory and widens them to float.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* index;
  void* out;
  int kv, g, hd, bs, n_blk, per_split, ring, window;
  float scale;
};

__device__ __forceinline__ bool slot_valid(int t, int idx, int ring, int lim) {
  if (ring <= 0) return t <= idx;
  // C++ % truncates toward zero: fold the age into [0, ring)
  const int age = ((idx - t) % ring + ring) % ring;
  return age < lim;
}

// Whether any slot of [lo, hi) is valid: linear, lo <= index; ring, the
// smallest age over the range is below the limit.
__device__ __forceinline__ bool split_has_work(int lo, int hi, int idx, int ring,
                                               int lim) {
  if (lo >= hi) return false;
  if (ring <= 0) return lo <= idx;
  const int im = (idx % ring + ring) % ring;
  const int min_age = im >= hi ? im - (hi - 1) : im >= lo ? 0 : im - (hi - 1) + ring;
  return min_age < lim;
}

// One block: one (request, kv head) row and one split of its table. FIXED:
// g == G and hd == 32 * CE * J, known at compile time (a fast path).
template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Params p) {
  constexpr int E = CE * J;                 // elements a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm_tab[kTableCap];
  __shared__ long long sm_row[2][kStage];   // a stage's K/V rows, -1: invalid
  __shared__ float sm_m[kWarps][G];         // the warps' m and l
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_wc[kWarps][G];        // the warps' merge weights
  __shared__ __align__(16) float sm_part[G * 32 * E];  // the block's acc
  __shared__ float sm_pm[G];                // the block's m and l
  __shared__ float sm_pl[G];
  __shared__ float sm_c[kMaxSplits][G];     // the splits' m, then weights
  __shared__ float sm_sl[kMaxSplits][G];    // the splits' l
  __shared__ bool sm_work[kMaxSplits];
  __shared__ float sm_den[G];

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.y;  // request * kv + kv head
  const int bi = bk / p.kv;
  const int kh = bk - bi * p.kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = FIXED ? G : p.g;
  const int hd = FIXED ? 32 * E : p.hd;
  const int bs = p.bs;
  const int S = p.n_blk * bs;
  const int lo = split * p.per_split;
  const int hi = min(lo + p.per_split, S);
  const int row_bytes = hd * (int)sizeof(TKV);
  const int stage_bytes = kStage * 2 * row_bytes;

  // the table slice, the index and q do not depend on each other: their
  // loads go out together
  const int j0 = lo / bs;
  const int n_tab = (hi - 1) / bs - j0 + 1;
  for (int i = threadIdx.x; i < n_tab; i += kThreads)
    sm_tab[i] = p.table[(size_t)bi * p.n_blk + j0 + i];
  const int idx = p.index[bi];
  const int lim = p.ring > 0 ? min(p.window, idx + 1) : 0;

  if (split_has_work(lo, hi, idx, p.ring, lim)) {
    // this lane's elements of the q rows, scaled
    float qr[G][E];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e0 = (j * 32 + lane) * CE;
        if (gi < g && e0 < hd) {
          load_f32<TQ, CE>(static_cast<const TQ*>(p.q) + ((size_t)bk * g + gi) * hd + e0,
                           &qr[gi][j * CE]);
#pragma unroll
          for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] *= p.scale;
        } else {
#pragma unroll
          for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] = 0.f;
        }
      }
    }

    __syncthreads();                        // sm_tab

    const unsigned char* kbase = static_cast<const unsigned char*>(p.k_pool);
    const unsigned char* vbase = static_cast<const unsigned char*>(p.v_pool);
    const int cpr = row_bytes / 16;         // 16-byte chunks per row
    // the pool row of each slot of tile st (-1: invalid), by one warp
    auto rows = [&](int st) {
      if (warp == 0) {
        const int t = lo + st * kStage + lane;
        long long row = -1;
        if (t < hi && slot_valid(t, idx, p.ring, lim))
          row = ((long long)sm_tab[t / bs - j0] * bs + (t % bs)) * p.kv + kh;
        sm_row[st & 1][lane] = row;
      }
    };
    // copies every valid slot's K and V rows of tile st into its stage
    auto issue = [&](int st) {
      unsigned char* dst0 = smem + (st & 1) * stage_bytes;
      for (int c = threadIdx.x; c < kStage * 2 * cpr; c += kThreads) {
        const int tok = c / (2 * cpr);
        const int rem = c - tok * 2 * cpr;
        const int which = rem >= cpr;       // 0: K, 1: V
        const int ch = rem - which * cpr;
        const long long row = sm_row[st & 1][tok];
        if (row >= 0) {
          const unsigned char* src = (which ? vbase : kbase) + row * row_bytes + ch * 16;
          cp_async16(dst0 + (tok * 2 + which) * row_bytes + ch * 16, src);
        }
      }
      cp_async_commit();
    };

    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m[gi] = kNegInf;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
    }

    static_assert(kStage == 32, "one lane of warp 0 per slot of a tile");
    const int nst = (hi - lo + kStage - 1) / kStage;
    rows(0);
    __syncthreads();
    issue(0);
    for (int st = 0; st < nst; ++st) {
      if (st + 1 < nst) {
        rows(st + 1);
        __syncthreads();
        issue(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* buf = smem + (st & 1) * stage_bytes;
      // the warp's kTPW slots of the tile at once: independent dot
      // products and shuffles, then one online-softmax update for all of
      // them (an invalid slot's row was never copied: its score is masked
      // and its V row taken as 0)
      bool ok[kTPW];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kTPW; ++u) {
        ok[u] = sm_row[st & 1][warp * kTPW + u] >= 0;
        any |= ok[u];
      }
      if (any) {                            // warp-uniform
        float s[kTPW][G];
        float vr[kTPW][E];
#pragma unroll
        for (int u = 0; u < kTPW; ++u) {
          const int tok = warp * kTPW + u;
          const TKV* ks = reinterpret_cast<const TKV*>(buf + (tok * 2) * row_bytes);
          const TKV* vs = reinterpret_cast<const TKV*>(buf + (tok * 2 + 1) * row_bytes);
          float kr[E];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int e0 = (j * 32 + lane) * CE;
            if (e0 < hd) {
              load_f32<TKV, CE>(ks + e0, &kr[j * CE]);
              load_f32<TKV, CE>(vs + e0, &vr[u][j * CE]);
            } else {
#pragma unroll
              for (int c = 0; c < CE; ++c) kr[j * CE + c] = vr[u][j * CE + c] = 0.f;
            }
          }
#pragma unroll
          for (int e = 0; e < E; ++e) vr[u][e] = ok[u] ? vr[u][e] : 0.f;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) a = fmaf(qr[gi][e], kr[e], a);
            s[u][gi] = a;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < kTPW; ++u) {
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < g) s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], off);
          }
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi >= g) continue;
          float mx = m[gi];
#pragma unroll
          for (int u = 0; u < kTPW; ++u) {
            s[u][gi] = ok[u] ? s[u][gi] : kNegInf;
            mx = fmaxf(mx, s[u][gi]);
          }
          const float m_safe = fmaxf(mx, kMSafeFloor);
          const float corr = __expf(m[gi] - m_safe);
          float pr[kTPW];
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < kTPW; ++u) {
            pr[u] = __expf(s[u][gi] - m_safe);
            psum += pr[u];
          }
          l[gi] = l[gi] * corr + psum;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = acc[gi][e] * corr;
#pragma unroll
            for (int u = 0; u < kTPW; ++u) a = fmaf(pr[u], vr[u][e], a);
            acc[gi][e] = a;
          }
          m[gi] = mx;
        }
      }
      __syncthreads();  // the stage is free for the next issue
    }

    // merge the warps: the stage area now holds (kWarps, g, hd) floats
    float* sm_acc = reinterpret_cast<float*>(smem);
    if (lane == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e0 = (j * 32 + lane) * CE;
        if (e0 < hd) {
#pragma unroll
          for (int c = 0; c < CE; ++c)
            sm_acc[((size_t)warp * g + gi) * hd + e0 + c] = acc[gi][j * CE + c];
        }
      }
    }
    __syncthreads();
    // one thread per (warp w, head gi), kWarps lanes a head: the warps'
    // weights against the block's max, summed by shuffles within the lanes
    // of a head
    if (threadIdx.x < (kWarps * G + 31) / 32 * 32) {     // whole warps
      const int w = threadIdx.x % kWarps;
      const bool live = threadIdx.x / kWarps < g;
      const int gi = live ? threadIdx.x / kWarps : 0;
      float mx = kNegInf;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, sm_m[v][gi]);
      const float c =
          live ? __expf(fmaxf(sm_m[w][gi], kMSafeFloor) - fmaxf(mx, kMSafeFloor)) : 0.f;
      float den = c * sm_l[w][gi];
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        den += __shfl_xor_sync(0xffffffffu, den, off);
      if (live) {
        sm_wc[w][gi] = c;
        if (w == 0) {
          sm_pm[gi] = mx;
          sm_pl[gi] = den;
        }
      }
    }
    __syncthreads();
    // the block's partial acc, kept in its shared memory for the cluster
    for (int o = threadIdx.x; o < g * hd; o += kThreads) {
      const int gi = o / hd;
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        num = fmaf(sm_wc[w][gi], sm_acc[(size_t)w * g * hd + o], num);
      sm_part[o] = num;
    }
  }
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    sm_work[s] = split_has_work(s * p.per_split, min((s + 1) * p.per_split, S), idx,
                                p.ring, lim);

  // The splits of this row are the blocks of this cluster: after the
  // barrier each block reads every block's (m, l) from distributed shared
  // memory and merges its own slice of the output from every block's acc.
  // A block without work wrote nothing; its rank is selected away.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // also a block barrier: sm_work
  for (int i = threadIdx.x; i < n_split * g; i += kThreads) {
    const int s = i / g;
    const int gi = i - s * g;
    const float pm = *cluster.map_shared_rank(&sm_pm[gi], s);
    const float pl = *cluster.map_shared_rank(&sm_pl[gi], s);
    sm_c[s][gi] = sm_work[s] ? pm : kNegInf;
    sm_sl[s][gi] = sm_work[s] ? pl : 0.f;
  }
  __syncthreads();
  if (warp < g) {
    const int gi = warp;
    float mx = kNegInf;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, sm_c[s][gi]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mx_safe = fmaxf(mx, kMSafeFloor);
    float den = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float c = sm_work[s] ? __expf(fmaxf(sm_c[s][gi], kMSafeFloor) - mx_safe) : 0.f;
      den = fmaf(c, sm_sl[s][gi], den);
      sm_c[s][gi] = c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) sm_den[gi] = fmaxf(den, kDenFloor);
  }
  __syncthreads();
  // this block's slice of the row's g * hd outputs, four a thread (hd is a
  // multiple of 4); every rank's float4 is loaded, in flight together
  const int n_out = g * hd;
  const int slice = (n_out / 4 + n_split - 1) / n_split * 4;
  const int o_end = min(n_out, (split + 1) * slice);
  for (int o = split * slice + threadIdx.x * 4; o < o_end; o += kThreads * 4) {
    const int gi = o / hd;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      // ranks past the cluster read the last rank and count for nothing
      const int s = min(r, n_split - 1);
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(&sm_part[o], s));
      const bool w = r < n_split && sm_work[s];
      const float c = sm_c[s][gi];
      num.x = fmaf(c, w ? v.x : 0.f, num.x);
      num.y = fmaf(c, w ? v.y : 0.f, num.y);
      num.z = fmaf(c, w ? v.z : 0.f, num.z);
      num.w = fmaf(c, w ? v.w : 0.f, num.w);
    }
    TQ* out = static_cast<TQ*>(p.out) + (size_t)bk * n_out + o;
    const float den = sm_den[gi];
    out[0] = from_f32<TQ>(num.x / den);
    out[1] = from_f32<TQ>(num.y / den);
    out[2] = from_f32<TQ>(num.z / den);
    out[3] = from_f32<TQ>(num.w / den);
  }
  cluster.sync();   // no block leaves while another may still read its memory
}

template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
int launch(const Params& p, int b, int n_split, cudaStream_t stream) {
  const int row_bytes = p.hd * (int)sizeof(TKV);
  const int stage = 2 * kStage * 2 * row_bytes;
  const int merge = kWarps * p.g * p.hd * (int)sizeof(float);
  const int smem = stage > merge ? stage : merge;
  auto kernel = paged_decode_kernel<TQ, TKV, G, CE, J, FIXED>;
  // once per device: a cluster of up to 16 blocks, and the dynamic shared
  // memory above 48 KB
  static int raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || raised[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, b * p.kv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;       // one cluster per row
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch(const Params& p, int b, int n_split, cudaStream_t stream) {
  if (p.g == 4 && p.hd == 256) return launch<TQ, TKV, 4, 8, 1, true>(p, b, n_split, stream);
  if (p.g == 1 && p.hd == 64) return launch<TQ, TKV, 1, 2, 1, true>(p, b, n_split, stream);
  return launch<TQ, TKV, 8, 2, 4, false>(p, b, n_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, any (q, pool) pair. 1 <= g <= 8;
// hd a multiple of 16, 16 <= hd <= 256; per_split a multiple of 32 whose
// table span fits 1024 entries; 1 <= n_split <= 16 (the cluster) with
// n_split * per_split >= n_blk * bs. ring <= 0 selects the linear layout.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// configuration.
extern "C" int paged_decode_attn_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* index, void* out, int q_dtype, int kv_dtype, int b, int kv,
    int g, int hd, int bs, int n_blk, int per_split, int n_split, int ring,
    int window, float scale, void* stream) {
  if (g < 1 || g > 8 || hd < 16 || hd > 256 || hd % 16 != 0) return -1;
  if (b < 1 || kv < 1 || bs < 1 || n_blk < 1) return -1;
  if (per_split < 1 || per_split % kStage != 0 || n_split < 1 || n_split > kMaxSplits)
    return -1;
  if ((long long)n_split * per_split < (long long)n_blk * bs) return -1;
  if ((per_split + bs - 1) / bs + 1 > kTableCap) return -1;
  const Params p{q, k_pool, v_pool, static_cast<const int*>(table),
                 static_cast<const int*>(index), out, kv, g, hd, bs, n_blk,
                 per_split, ring, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 1 && kv_dtype == 0) return dispatch<__nv_bfloat16, float>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 1) return dispatch<float, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(p, b, n_split, st);
  return -1;
}
