// Device code shared by the two decode-attention kernels for Hopper
// (decode_attn.cu, contiguous cache; paged_decode_attn.cu, paged pools).
//
// Both run one (request, kv head) row as a thread block cluster of up to
// 16 blocks, each block one split of the row's positions, with kWarps
// warps a block. What they share:
//   * to_f32 / from_f32 and load_f32: 16-, 8- or 4-byte vector loads of
//     float32 or bfloat16 elements, widened to float.
//   * load_q: lane l holds the elements (j * 32 + l) * CE + [0, CE), j < J,
//     of the g query rows, scaled by hd^-0.5; lanes past hd and rows past
//     g hold zeros.
//   * attend4: a warp takes four slots at once: independent dot products
//     and shuffles, then one online-softmax update for the four (running
//     max from -1e30, exponents against m_safe = max(m, -0.5e30) by the
//     fast __expf). An invalid slot's score is masked and its V row taken
//     as 0.
//   * merge_warps: the block's warps merge into the block's partial
//     (m, l, acc), kept in its own shared memory.
//   * merge_cluster: after a cluster barrier every block reads all the
//     row's (m, l) through distributed shared memory and merges its own
//     slice of the output from every block's acc; the denominator is
//     floored at 1e-30, so a row without a valid slot gives 0. A second
//     barrier keeps each block's memory alive until its peers have read
//     it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kMSafeFloor = -0.5e30f;
constexpr float kDenFloor = 1e-30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTPW = 4;           // slots a warp takes at once
constexpr int kMaxSplits = 16;    // a cluster: H100's largest (non-portable)

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

// This lane's elements of the g query rows at q (g rows of hd), scaled.
template <typename TQ, int G, int CE, int J>
__device__ __forceinline__ void load_q(const TQ* __restrict__ q, int g, int hd,
                                       float scale, int lane, float (&qr)[G][CE * J]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e0 = (j * 32 + lane) * CE;
      if (gi < g && e0 < hd) {
        load_f32<TQ, CE>(q + (size_t)gi * hd + e0, &qr[gi][j * CE]);
#pragma unroll
        for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] *= scale;
      } else {
#pragma unroll
        for (int c = 0; c < CE; ++c) qr[gi][j * CE + c] = 0.f;
      }
    }
  }
}

template <int G, int E>
__device__ __forceinline__ void init_state(float (&m)[G], float (&l)[G], float (&acc)[G][E]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }
}

// The warp's four slots tok0 + [0, 4): slot u's K row at kbuf + (tok0 + u)
// * stride bytes, its V row at vbuf + the same, all inside the caller's
// stage. ok[u] false masks slot u: slot tok0's rows are read in its place,
// so the loads of the four slots issue together without a branch.
template <typename TKV, int G, int CE, int J>
__device__ __forceinline__ void attend4(const float (&qr)[G][CE * J],
                                        const unsigned char* kbuf,
                                        const unsigned char* vbuf, int stride,
                                        int tok0, const bool (&ok)[kTPW], int g,
                                        int hd, int lane, float (&m)[G],
                                        float (&l)[G], float (&acc)[G][CE * J]) {
  constexpr int E = CE * J;
  float s[kTPW][G];
  float vr[kTPW][E];
#pragma unroll
  for (int u = 0; u < kTPW; ++u) {
    const size_t off = (size_t)(ok[u] ? tok0 + u : tok0) * stride;
    const TKV* ks = reinterpret_cast<const TKV*>(kbuf + off);
    const TKV* vs = reinterpret_cast<const TKV*>(vbuf + off);
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

// Shared memory of the merges: the warps' (m, l) and weights, the block's
// partial (m, l, acc) that its cluster peers read, and the row's weights.
template <int G, int E>
struct MergeSmem {
  float m[kWarps][G];
  float l[kWarps][G];
  float wc[kWarps][G];
  __align__(16) float part[G * 32 * E];   // the block's acc, (g, hd)
  float pm[G];
  float pl[G];
  float c[kMaxSplits][G];                 // the splits' m, then weights
  float sl[kMaxSplits][G];                // the splits' l
  float den[G];
  bool work[kMaxSplits];                  // which splits had a valid slot
};

// Merges the block's warps into sm.part, sm.pm, sm.pl. sm_acc: kWarps * g
// * hd floats of shared memory that no warp reads any more (the stage).
template <int G, int CE, int J>
__device__ __forceinline__ void merge_warps(MergeSmem<G, CE * J>& sm, float* sm_acc,
                                            const float (&m)[G], const float (&l)[G],
                                            const float (&acc)[G][CE * J], int g,
                                            int hd, int warp, int lane) {
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      sm.m[warp][gi] = m[gi];
      sm.l[warp][gi] = l[gi];
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
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, sm.m[v][gi]);
    const float c =
        live ? __expf(fmaxf(sm.m[w][gi], kMSafeFloor) - fmaxf(mx, kMSafeFloor)) : 0.f;
    float den = c * sm.l[w][gi];
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (live) {
      sm.wc[w][gi] = c;
      if (w == 0) {
        sm.pm[gi] = mx;
        sm.pl[gi] = den;
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < g * hd; o += kThreads) {
    const int gi = o / hd;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num = fmaf(sm.wc[w][gi], sm_acc[(size_t)w * g * hd + o], num);
    sm.part[o] = num;
  }
}

// The splits of this row are the blocks of this cluster (rank = split):
// merges every block's partial into this block's slice of the row's g * hd
// outputs at out. sm.work must hold every split's flag; a block without
// work wrote nothing and its rank is selected away. Every block of the
// cluster calls this.
template <typename TQ, int G, int E>
__device__ __forceinline__ void merge_cluster(MergeSmem<G, E>& sm, TQ* __restrict__ out,
                                              int g, int hd, int split, int n_split,
                                              int warp, int lane) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // also a block barrier: sm.work
  for (int i = threadIdx.x; i < n_split * g; i += kThreads) {
    const int s = i / g;
    const int gi = i - s * g;
    const float pm = *cluster.map_shared_rank(&sm.pm[gi], s);
    const float pl = *cluster.map_shared_rank(&sm.pl[gi], s);
    sm.c[s][gi] = sm.work[s] ? pm : kNegInf;
    sm.sl[s][gi] = sm.work[s] ? pl : 0.f;
  }
  __syncthreads();
  if (warp < g) {
    const int gi = warp;
    float mx = kNegInf;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, sm.c[s][gi]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mx_safe = fmaxf(mx, kMSafeFloor);
    float den = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float c = sm.work[s] ? __expf(fmaxf(sm.c[s][gi], kMSafeFloor) - mx_safe) : 0.f;
      den = fmaf(c, sm.sl[s][gi], den);
      sm.c[s][gi] = c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) sm.den[gi] = fmaxf(den, kDenFloor);
  }
  __syncthreads();
  // this block's slice, four outputs a thread (hd is a multiple of 4);
  // every rank's float4 is loaded, in flight together
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
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(&sm.part[o], s));
      const bool w = r < n_split && sm.work[s];
      const float c = sm.c[s][gi];
      num.x = fmaf(c, w ? v.x : 0.f, num.x);
      num.y = fmaf(c, w ? v.y : 0.f, num.y);
      num.z = fmaf(c, w ? v.z : 0.f, num.z);
      num.w = fmaf(c, w ? v.w : 0.f, num.w);
    }
    const float den = sm.den[gi];
    out[o + 0] = from_f32<TQ>(num.x / den);
    out[o + 1] = from_f32<TQ>(num.y / den);
    out[o + 2] = from_f32<TQ>(num.z / den);
    out[o + 3] = from_f32<TQ>(num.w / den);
  }
  cluster.sync();   // no block leaves while another may still read its memory
}

// Sets the two attributes a launch needs once per device: clusters of up
// to 16 blocks, and `smem` bytes of dynamic shared memory.
template <typename K>
__host__ int raise_limits(K kernel, int smem, int (&raised)[64]) {
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
  return 0;
}

// Launches `kernel(p)` on a grid of (n_split, rows) blocks, one cluster of
// n_split blocks a row, with `smem` bytes of dynamic shared memory.
template <typename K, typename P>
__host__ int launch_clusters(K kernel, const P& p, int n_split, int rows, int smem,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, rows);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace decode
