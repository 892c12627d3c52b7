// GroupNorm + activation (K1) for Hopper, on channels-first (N, C, *spatial)
// or channels-last (N, *spatial, C) storage of an (N, C, *spatial) tensor.
//
// Replaces the TPU kernel
//   diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py::fused_groupnorm_act
// (one program per sample with the whole (spatial, C) slab in VMEM).
//
// Bound on the H100: bytes. The work is a few flops per element, so the
// floor is reading x once and writing y once at 3.35 TB/s: 7.1 ms of a
// published DDIM-50 request at batch 2 (PERF.md). A group is one
// contiguous span of L = (C/G) * prod(spatial) elements. The TPU's slab per
// sample does not carry over: a block may hold 227 KB of shared memory, and
// one UNet sample at level 1 is 512 KB, one VAE group at 11x256^2x128, G=32,
// 5.5 MB. So a group is spread over the blocks of a thread-block cluster,
// whose shared memory together holds up to 16 x 227 KB.
//
// Two paths; ops/cuda/groupnorm_act.py::plan picks the path, the cluster
// size k and the slice each block holds (the reckoning at the 19 published
// pairs is in PERF.md: every UNet pair takes `cluster` with k = 4, or
// 2 at its 8 KB groups, and slices of 4 to 128 KB; the VAE's 0.69-2.75 MB
// groups take k = 8 or 16 and 88 or 176 KB slices; its 5.5 MB groups take
// `split`). At the UNet's shapes a call is mostly latency, so the design
// also keeps the chain from launch to the last store short.
//
//   cluster: one launch, x read once. Grid groups x k, cluster (k, 1, 1).
//     1. Each block brings its contiguous slice of the group into shared
//        memory: 1-D bulk copies (cp.async.bulk) of 8 KB, each completing
//        on its own mbarrier, when the group's rows are 16-byte aligned;
//        else one element a thread. Shared memory, not registers, holds the
//        slice at every size: one path from 4 KB to 227 KB a block, and a
//        bulk copy spends no registers or instructions of the block. The
//        slice's (gamma, beta) are loaded while the copies are in flight.
//     2. Each thread sums x - shift and (x - shift)^2 of its vectors as their
//        piece lands, the shift the slice's first element (close to the
//        data, so a large mean costs no digits); the block adds the sums by
//        xor butterflies and forms its (count, mean, M2) in float32.
//     3. Lane r of warp 0 stores the block's partial into slot `rank` of
//        block r with st.async, which counts it on block r's own mbarrier
//        (after one relaxed cluster barrier: every block has started). Each
//        block merges the k partials with Chan's formula in a fixed
//        butterfly, so every block of a group holds bit-identical
//        statistics. No block leaves before its k partials have landed, so
//        no store reaches a block that has left: no barrier at the end.
//     4. The block normalizes its slice from shared memory: the channel is
//        stepped without a division, gamma * rstd and beta stay in registers
//        while it lasts, y leaves in 16-byte stores. SiLU in bf16 is one
//        tanh.approx, in float32 exp and a division (see activate).
//   split: groups past a cluster's capacity; two launches, x read twice.
//     gn_partial holds 64 KB of a group a block (as in 1-2) and writes its
//     (count, mean, M2); gn_apply brings its chunk in the same way while
//     warp 0 merges the group's partials (a fixed order, the same result in
//     every block), then normalizes it as in 4. The grid is chunks x groups:
//     thousands of blocks at the published shape.
//
// Channels-last (the sampler's activations on the card, so that cuDNN's
// convs around K1 take and give NHWC / NDHWC without transposing): element
// i of a sample lies in channel i % C.
//   cluster, G = 1 (the UNet): a group is still one contiguous sample, so the
//     path above runs as it is, with a (gamma, beta) table of all C channels
//     and the channel stepped one an element (normalize_cl).
//   rows, any G (the VAE's GN(32), whose groups are strided by C): two
//     launches over the same grid (row ranges, samples). gn_partial_cl: each
//     thread keeps one 16-byte vector of channels of the (rows x C) range,
//     sums x - shift and (x - shift)^2 per channel down its rows (the shift
//     a group's first element of the range), the block adds them per
//     channel, then per group in a fixed order, and writes each group's
//     (count, mean, M2). gn_apply_cl: each warp merges its groups' partials
//     over the sample's ranges in a fixed order (the same statistics in every
//     block), then the threads normalize the range, one channel vector each,
//     (gamma * rstd, beta, mean) of its channels in registers. x is read twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mainloop.cuh"

namespace {

using namespace dm_sm90;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;      // ops/cuda/groupnorm_act.py MAX_CLUSTER
constexpr uint32_t kPiece = 8192;    // bytes a bulk copy: one 16-byte vector a thread
constexpr int kMaxPieces = 32;       // pieces of the largest slice, one mbarrier each
static_assert(kPiece / 16 == kThreads, "a thread takes one vector of each piece");
static_assert(kMaxPieces * kPiece >= (uint32_t)SMEM_LIMIT, "a barrier for every piece");
// the header of a block's shared memory, in bytes: [0, 8 kMaxPieces) the
// pieces' mbarriers, [kXbar, +8) the mbarrier of the cluster's partials,
// [kSlots, +16 kMaxCluster) the cluster's (count, mean, M2), one slot a rank,
// [kRed, +8 kWarps) the warps' sums, [kStat, +8) gn_apply's (mean, rstd);
// then the slice, then (gamma, beta) of the slice's channels
constexpr int kXbar = 8 * kMaxPieces, kSlots = kXbar + 16, kRed = kSlots + 16 * kMaxCluster,
              kStat = kRed + 8 * kWarps, kHeader = 768;
static_assert(kStat + 8 <= kHeader, "the header's layout");

__host__ __device__ constexpr long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

// must equal ops/cuda/groupnorm_act.py::gn_smem; `channels` (gamma, beta)
// pairs (slice / S + 2 on the cluster path, which holds them; 0 on split)
constexpr long long gn_smem(long long slice, int elem_bytes, long long channels) {
  return kHeader + round16(slice * elem_bytes) + round16(8 * channels);
}

struct Stats {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2); an empty side returns the other exactly
__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  float n = a.n + b.n;
  if (n == 0.f) return a;
  float d = b.mean - a.mean;
  float fb = __fdividef(b.n, n);  // counts: the approximate quotient is near exact
  Stats r;
  r.n = n;
  r.mean = a.mean + d * fb;
  r.m2 = a.m2 + b.m2 + d * d * a.n * fb;
  return r;
}

// Chan's merge over a warp by xor shuffles; lane 0's result is used
__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.n = __shfl_xor_sync(0xffffffffu, s.n, off);
    o.mean = __shfl_xor_sync(0xffffffffu, s.mean, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, s.m2, off);
    s = merge(s, o);
  }
  return s;
}

// The block's (count, mean, M2) of n elements from each thread's sums of
// (x - shift) and (x - shift)^2 about one shift for the whole block, an
// element of its slice: close to the data, so the sums lose no digits to a
// large mean, and plain adds reduce them (an xor butterfly a warp, then every
// warp over the warps). The same bits in every thread.
__device__ __forceinline__ Stats block_stats(float s1, float s2, float shift, int n, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    red[2 * warp] = s1;
    red[2 * warp + 1] = s2;
  }
  __syncthreads();
  s1 = lane < kWarps ? red[2 * lane] : 0.f;
  s2 = lane < kWarps ? red[2 * lane + 1] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (n == 0) return Stats{0.f, 0.f, 0.f};
  const float m = __fdividef(s1, (float)n);
  return Stats{(float)n, shift + m, fmaxf(s2 - s1 * m, 0.f)};
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// silu, relu or nothing. SiLU is y * sigmoid(y) = h + h tanh(h), h = y / 2:
// one tanh.approx (relative error 2^-11) where the output is bf16, whose
// rounding (2^-9) is larger; exp and a division (two SFU operations, the
// normalize loop's bottleneck at 16 a cycle an SM) in float32.
template <typename T, int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 1) {
    if (sizeof(T) == 2) {
      const float h = 0.5f * y;
      float t;
      asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
      return fmaf(h, t, h);
    }
    return __fdividef(y, 1.f + __expf(-y));
  }
  if (ACT == 2) return fmaxf(y, 0.f);
  return y;
}

__device__ __forceinline__ int pieces_of(int n, int elem_bytes) {
  return (int)(((uint32_t)n * elem_bytes + kPiece - 1) / kPiece);
}

// Thread 0 sets up one mbarrier a piece of n elements (and `xbar`, the
// cluster's, when given), then fences them for the cluster and the copies.
template <typename T, bool kVec>
__device__ __forceinline__ void init_barriers(int n, uint64_t* bars, uint64_t* xbar) {
  if (threadIdx.x == 0) {
    if (xbar) mbar_init(xbar, 1);
    if (kVec)
      for (int p = 0; p < pieces_of(n, sizeof(T)); ++p) mbar_init(bars + p, 1);
    fence_barrier_init();
  }
}

// Thread 0 starts the bulk copies of the n elements at src (device memory)
// into dst (shared memory), one kPiece-byte piece on each mbarrier; the
// block has synchronized since init_barriers.
template <typename T>
__device__ __forceinline__ void start_load(T* dst, const T* src, int n, uint64_t* bars) {
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)n * sizeof(T);
    for (int p = 0; p < pieces_of(n, sizeof(T)); ++p) {
      const uint32_t off = p * kPiece, len = min(kPiece, bytes - off);
      mbar_expect_tx(bars + p, len);
      bulk_load_1d(reinterpret_cast<uint8_t*>(dst) + off,
                   reinterpret_cast<const uint8_t*>(src) + off, len, bars + p);
    }
  }
}

// One thread's sums of (x - shift) and (x - shift)^2 over its elements of
// the n at src, held at dst in shared memory; the shift is the first element.
// kVec: the bulk copies start_load started, summed piece by piece as they
// land (thread t takes vector t of each piece); else each thread copies and
// sums elements t, t + kThreads, ...
struct Sums {
  float s1, s2, shift;
};

template <typename T, bool kVec>
__device__ __forceinline__ Sums hold_and_sum(T* dst, const T* src, int n, uint64_t* bars) {
  constexpr int V = Vec<T>::N;
  float s1 = 0.f, s2 = 0.f, shift = 0.f;
  if (kVec) {
    for (int p = 0; p < pieces_of(n, sizeof(T)); ++p) {
      mbar_wait(bars + p, 0);
      if (p == 0) shift = to_f32(dst[0]);
      const int v = p * kThreads + threadIdx.x;
      if (v < n / V) {
        float e[V];
        load_vec(dst + v * V, e);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = e[j] - shift;
          s1 += t;
          s2 += t * t;
        }
      }
    }
  } else {
    if (n > 0) shift = to_f32(src[0]);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const T v = src[i];
      dst[i] = v;
      const float t = to_f32(v) - shift;
      s1 += t;
      s2 += t * t;
    }
  }
  return Sums{s1, s2, shift};
}

// y = act((x - mean) * rstd * gamma[c] + beta[c]) for the n elements of a
// group from its element lo on, channel c = i / S: src holds x[lo, lo + n)
// in shared or device memory, dst is y + lo; (gamma, beta) of channel c come
// from tab[c - q0] in shared memory (kTable) or from gamma, beta, which
// start at the group's first channel. A thread takes every kThreads-th
// vector (element), the ones it summed, and steps its channel (q, r) by
// adds; gamma * rstd and beta stay in registers while the channel does.
template <typename T, bool kVec, int ACT, bool kTable>
__device__ __forceinline__ void normalize(const T* src, T* __restrict__ dst, int lo, int n, int S,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, const float2* tab,
                                          int q0, float mean, float rstd) {
  constexpr int V = Vec<T>::N;
  auto affine = [&](int q) {
    return kTable ? tab[q - q0] : make_float2(gamma[q], beta[q]);
  };
  if (kVec && S % V == 0) {  // each vector lies in one channel of S / V vectors
    const int sv = S / V, nv = n / V, first = lo / V + threadIdx.x;
    const int dq = kThreads / sv, dr = kThreads - dq * sv;
    int q = first / sv, r = first - q * sv, qc = -1;
    float a = 0.f, b = 0.f;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      if (q != qc) {
        qc = q;
        const float2 gb = affine(q);
        a = gb.x * rstd;
        b = gb.y;
      }
      float e[V];
      load_vec(src + v * V, e);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = activate<T, ACT>((e[j] - mean) * a + b);
      store_vec(dst + v * V, e);
      q += dq;
      r += dr;
      if (r >= sv) {
        r -= sv;
        ++q;
      }
    }
  } else if (kVec) {  // vectors straddle channels: the channel steps per element
    const int nv = n / V, first = lo + threadIdx.x * V;
    const int dq = kThreads * V / S, dr = kThreads * V - dq * S;
    int q = first / S, r = first - q * S;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float e[V];
      load_vec(src + v * V, e);
      int qq = q, rr = r;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float2 gb = affine(qq);
        e[j] = activate<T, ACT>((e[j] - mean) * (gb.x * rstd) + gb.y);
        if (++rr == S) {
          rr = 0;
          ++qq;
        }
      }
      store_vec(dst + v * V, e);
      q += dq;
      r += dr;
      if (r >= S) {
        r -= S;
        ++q;
      }
    }
  } else {  // the scalar variant: one element a step
    const int first = lo + threadIdx.x, dq = kThreads / S, dr = kThreads - dq * S;
    int q = first / S, r = first - q * S;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 gb = affine(q);
      from_f32(activate<T, ACT>((to_f32(src[i]) - mean) * (gb.x * rstd) + gb.y), dst + i);
      q += dq;
      r += dr;
      if (r >= S) {
        r -= S;
        ++q;
      }
    }
  }
}

// normalize for a channels-last sample (G = 1): element i lies in channel
// i % C, (gamma, beta) of every channel in tab. Where C is a whole number of
// vectors, each vector lies in V consecutive channels, kept in registers
// while the thread's channel does not move (at C dividing kThreads * V, the
// UNet's, never); else the channel steps one an element.
template <typename T, bool kVec, int ACT>
__device__ __forceinline__ void normalize_cl(const T* src, T* __restrict__ dst, int lo, int n,
                                             int C, const float2* tab, float mean, float rstd) {
  constexpr int V = Vec<T>::N;
  if (kVec && C % V == 0) {
    const int nv = n / V, dc = kThreads * V % C;
    int c = (lo + threadIdx.x * V) % C, cc = -1;
    float a[V], b[V];
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      if (c != cc) {
        cc = c;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float2 gb = tab[c + j];
          a[j] = gb.x * rstd;
          b[j] = gb.y;
        }
      }
      float e[V];
      load_vec(src + v * V, e);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = activate<T, ACT>((e[j] - mean) * a[j] + b[j]);
      store_vec(dst + v * V, e);
      c += dc;
      if (c >= C) c -= C;
    }
  } else if (kVec) {  // vectors straddle rows of C: the channel steps per element
    const int nv = n / V, dc = kThreads * V % C;
    int c = (lo + threadIdx.x * V) % C;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float e[V];
      load_vec(src + v * V, e);
      int cj = c;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float2 gb = tab[cj];
        e[j] = activate<T, ACT>((e[j] - mean) * (gb.x * rstd) + gb.y);
        if (++cj == C) cj = 0;
      }
      store_vec(dst + v * V, e);
      c += dc;
      if (c >= C) c -= C;
    }
  } else {  // the scalar variant
    const int dc = kThreads % C;
    int c = (lo + threadIdx.x) % C;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 gb = tab[c];
      from_f32(activate<T, ACT>((to_f32(src[i]) - mean) * (gb.x * rstd) + gb.y), dst + i);
      c += dc;
      if (c >= C) c -= C;
    }
  }
}

// Path cluster: grid (groups x k), cluster (k, 1, 1). Block `rank` of
// cluster g holds elements [rank * slice, min(L, (rank + 1) * slice)) of
// group g. kCL: x is channels-last and G = 1, so group g is sample g and
// the table holds all cpg = C channels.
template <typename T, bool kVec, int ACT, bool kCL>
__device__ __forceinline__ void cluster_body(const T* __restrict__ x,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, T* __restrict__ y,
                                             int L, int S, int G, int cpg, int slice, float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + kXbar);
  float* slots = reinterpret_cast<float*>(smem + kSlots);
  float* red = reinterpret_cast<float*>(smem + kRed);
  T* data = reinterpret_cast<T*>(smem + kHeader);
  float2* tab = reinterpret_cast<float2*>(smem + kHeader + round16((long long)slice * sizeof(T)));
  const int k = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
  const int g = (int)blockIdx.x / k;
  const int lo = min(L, rank * slice), n = min(L - lo, slice);
  const T* src = x + (long long)g * L + lo;

  init_barriers<T, kVec>(n, bars, k > 1 ? xbar : nullptr);
  // (gamma, beta) of the slice's channels (kCL: of all C), the first into
  // registers before the copies start, into the table once they have landed
  const int c0 = kCL ? 0 : g % G * cpg, q0 = kCL ? 0 : lo / S;
  const int nch = kCL ? cpg : n > 0 ? (lo + n - 1) / S - q0 + 1 : 0;
  const int ch = c0 + q0 + threadIdx.x;
  const float2 gb = threadIdx.x < nch ? make_float2(gamma[ch], beta[ch]) : make_float2(0.f, 0.f);
  __syncthreads();  // the barriers are set up
  if (kVec) start_load(data, src, n, bars);
  if (k > 1) cluster_arrive_relaxed();  // waited below, before a peer is touched
  const Sums sums = hold_and_sum<T, kVec>(data, src, n, bars);
  if (threadIdx.x < nch) tab[threadIdx.x] = gb;  // made visible by block_stats' barrier
  for (int i = threadIdx.x + kThreads; i < nch; i += kThreads)
    tab[i] = make_float2(gamma[c0 + q0 + i], beta[c0 + q0 + i]);
  Stats t = block_stats(sums.s1, sums.s2, sums.shift, n, red);
  if (k > 1) {
    // every block of the cluster has started and set up its barrier; lane r
    // of warp 0 stores this block's partial into slot `rank` of block r,
    // which counts it on its own barrier. No block leaves before its k
    // partials have landed, so no store reaches a block that has left.
    cluster_wait();
    if (threadIdx.x == 0) mbar_expect_tx(xbar, 16 * k);
    if (threadIdx.x < k)
      st_async_peer(slots + 4 * rank, xbar, threadIdx.x, make_float4(t.n, t.mean, t.m2, 0.f));
    mbar_wait(xbar, 0);
    // in every warp, lane r takes rank r's partial; a butterfly over the k
    // lanes, a fixed tree, leaves the same statistics in lane 0 of every warp
    // of every block of the cluster
    const int lane = threadIdx.x & 31;
    t = Stats{0.f, 0.f, 0.f};
    if (lane < k) {
      const float4 p = reinterpret_cast<const float4*>(slots)[lane];
      t = Stats{p.x, p.y, p.z};
    }
    for (int off = 1; off < k; off <<= 1) {
      Stats o;
      o.n = __shfl_xor_sync(0xffffffffu, t.n, off);
      o.mean = __shfl_xor_sync(0xffffffffu, t.mean, off);
      o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
      t = merge(t, o);
    }
    t = Stats{__shfl_sync(0xffffffffu, t.n, 0), __shfl_sync(0xffffffffu, t.mean, 0),
              __shfl_sync(0xffffffffu, t.m2, 0)};
  }
  const float rstd = rsqrtf(fmaxf(__fdividef(t.m2, t.n), 0.f) + eps);
  if (kCL)
    normalize_cl<T, kVec, ACT>(data, y + (long long)g * L + lo, lo, n, cpg, tab, t.mean, rstd);
  else
    normalize<T, kVec, ACT, true>(data, y + (long long)g * L + lo, lo, n, S, nullptr, nullptr,
                                  tab, q0, t.mean, rstd);
}

template <typename T, bool kVec, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
gn_cluster(const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, T* __restrict__ y, int L, int S, int G, int cpg,
           int slice, float eps) {
  cluster_body<T, kVec, ACT, false>(x, gamma, beta, y, L, S, G, cpg, slice, eps);
}

// the cluster path on channels-last x at G = 1
template <typename T, bool kVec, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
gn_cluster_cl(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int L, int S, int C, int slice,
              float eps) {
  cluster_body<T, kVec, ACT, true>(x, gamma, beta, y, L, S, 1, C, slice, eps);
}

// Path split, launch 1: grid (chunks, groups). Block (c, g) holds elements
// [c * chunk, min(L, (c + 1) * chunk)) of group g and writes their
// (count, mean, M2) to partials[g][c].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gn_partial(const T* __restrict__ x, float* __restrict__ partials, int L, int chunk) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kRed);
  T* data = reinterpret_cast<T*>(smem + kHeader);
  const int g = blockIdx.y, lo = blockIdx.x * chunk, n = min(L - lo, chunk);
  const T* src = x + (long long)g * L + lo;
  init_barriers<T, kVec>(n, bars, nullptr);
  __syncthreads();
  if (kVec) start_load(data, src, n, bars);
  const Sums sums = hold_and_sum<T, kVec>(data, src, n, bars);
  const Stats s = block_stats(sums.s1, sums.s2, sums.shift, n, red);
  if (threadIdx.x == 0) {
    float* p = partials + ((long long)g * gridDim.x + blockIdx.x) * 3;
    p[0] = s.n;
    p[1] = s.mean;
    p[2] = s.m2;
  }
}

// Path split, launch 2: the same grid. The block's chunk comes into shared
// memory (kVec) while warp 0 merges the group's partials (lane l those of
// chunks l, l + 32, ..., then the lanes by xor shuffles; lane 0's result,
// the same in every block of the group); then the block normalizes it.
template <typename T, bool kVec, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
gn_apply(const T* __restrict__ x, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ partials,
         T* __restrict__ y, int L, int S, int G, int cpg, int chunk, float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stat = reinterpret_cast<float*>(smem + kStat);
  T* data = reinterpret_cast<T*>(smem + kHeader);
  const int g = blockIdx.y, nchunks = gridDim.x, lo = blockIdx.x * chunk;
  const int n = min(L - lo, chunk);
  const T* src = x + (long long)g * L + lo;
  init_barriers<T, kVec>(n, bars, nullptr);
  __syncthreads();
  if (kVec) start_load(data, src, n, bars);
  if (threadIdx.x < 32) {
    Stats s = {0.f, 0.f, 0.f};
    for (int j = threadIdx.x; j < nchunks; j += 32) {
      const float* p = partials + ((long long)g * nchunks + j) * 3;
      s = merge(s, Stats{p[0], p[1], p[2]});
    }
    s = warp_merge(s);
    if (threadIdx.x == 0) {
      stat[0] = s.mean;
      stat[1] = rsqrtf(fmaxf(s.m2 / s.n, 0.f) + eps);
    }
  }
  if (kVec)
    for (int p = 0; p < pieces_of(n, sizeof(T)); ++p) mbar_wait(bars + p, 0);
  __syncthreads();
  const int c0 = g % G * cpg;
  normalize<T, kVec, ACT, false>(kVec ? data : src, y + (long long)g * L + lo, lo, n, S,
                                 gamma + c0, beta + c0, nullptr, 0, stat[0], stat[1]);
}

// ------------------------------------------------ channels-last, path rows
// x (N, S, C) with C = G * cpg; grid (ranges, N). Block (p, s) takes rows
// [p * rows, min(S, (p + 1) * rows)) of sample s. Thread t keeps channel
// vector t % (C / V) of rows t / (C / V), + rpi, ... (rpi = kThreads / (C / V);
// threads past rpi * C / V idle). V = 16 bytes of T (kVec) or 1 element.

// must equal ops/cuda/groupnorm_act.py::rows_smem: gn_partial_cl's (s1, s2)
// of each (row lane, channel), then of each channel; gn_apply_cl's G
// (mean, rstd) pairs fit in it
constexpr long long rows_smem(int C, int V) {
  return round16(8LL * (kThreads / (C / V)) * C) + round16(8LL * C);
}

template <typename T, int V> __device__ __forceinline__ void load_n(const T* p, float (&e)[V]) {
  if constexpr (V == 1) e[0] = to_f32(*p);
  else load_vec(p, e);
}
template <typename T, int V> __device__ __forceinline__ void store_n(T* p, const float (&e)[V]) {
  if constexpr (V == 1) from_f32(e[0], p);
  else store_vec(p, e);
}

constexpr int kRowsUnroll = 4;  // loads in flight a thread

// launch 1: each group's (count, mean, M2) over the block's rows, to
// partials[((s * G + g) * ranges + p) * 3]
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
gn_partial_cl(const T* __restrict__ x, float* __restrict__ partials, int S, int G, int cpg,
              int rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int C = G * cpg, cv = C / V, rpi = kThreads / cv;
  float2* lanes = reinterpret_cast<float2*>(smem);                           // [rpi][C]
  float2* chan = reinterpret_cast<float2*>(smem + round16(8LL * rpi * C));   // [C]
  const int s = blockIdx.y, lo = blockIdx.x * rows, hi = min(S, lo + rows);
  const T* xs = x + (long long)s * S * C;
  const int v = threadIdx.x % cv, r0 = threadIdx.x / cv;
  if (r0 < rpi) {
    float sh[V], s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh[j] = to_f32(xs[(long long)lo * C + (v * V + j) / cpg * cpg]);
      s1[j] = s2[j] = 0.f;
    }
    int r = lo + r0;
    for (; r + (kRowsUnroll - 1) * rpi < hi; r += kRowsUnroll * rpi) {
      float e[kRowsUnroll][V];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        load_n<T, V>(xs + (long long)(r + u * rpi) * C + v * V, e[u]);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = e[u][j] - sh[j];
          s1[j] += t;
          s2[j] += t * t;
        }
    }
    for (; r < hi; r += rpi) {
      float e[V];
      load_n<T, V>(xs + (long long)r * C + v * V, e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = e[j] - sh[j];
        s1[j] += t;
        s2[j] += t * t;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) lanes[r0 * C + v * V + j] = make_float2(s1[j], s2[j]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {  // each channel over the row lanes
    float a = 0.f, b = 0.f;
    for (int l = 0; l < rpi; ++l) {
      const float2 p = lanes[l * C + c];
      a += p.x;
      b += p.y;
    }
    chan[c] = make_float2(a, b);
  }
  __syncthreads();
  const float n = (float)(hi - lo) * cpg;
  for (int g = threadIdx.x; g < G; g += kThreads) {  // each group over its channels
    float a = 0.f, b = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += chan[c].x;
      b += chan[c].y;
    }
    const float m = __fdividef(a, n);
    float* out = partials + (((long long)s * G + g) * gridDim.x + blockIdx.x) * 3;
    out[0] = n;
    out[1] = to_f32(xs[(long long)lo * C + g * cpg]) + m;
    out[2] = fmaxf(b - a * m, 0.f);
  }
}

// launch 2: each warp merges the partials of groups warp, warp + kWarps, ...
// (lane l those of ranges l, l + 32, ..., then the lanes by xor shuffles;
// the same statistics in every block of the sample); then the block
// normalizes its rows
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
gn_apply_cl(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, const float* __restrict__ partials,
            T* __restrict__ y, int S, int G, int cpg, int rows, float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  float2* stat = reinterpret_cast<float2*>(smem);  // [G] (mean, rstd)
  const int C = G * cpg, cv = C / V, rpi = kThreads / cv;
  const int s = blockIdx.y, lo = blockIdx.x * rows, hi = min(S, lo + rows);
  const int lane = threadIdx.x & 31, nr = gridDim.x;
  for (int g = threadIdx.x >> 5; g < G; g += kWarps) {
    const float* p = partials + ((long long)s * G + g) * nr * 3;
    Stats t = {0.f, 0.f, 0.f};
    for (int j = lane; j < nr; j += 32) t = merge(t, Stats{p[3 * j], p[3 * j + 1], p[3 * j + 2]});
    t = warp_merge(t);
    if (lane == 0) stat[g] = make_float2(t.mean, rsqrtf(fmaxf(t.m2 / t.n, 0.f) + eps));
  }
  __syncthreads();
  const int v = threadIdx.x % cv, r0 = threadIdx.x / cv;
  if (r0 >= rpi) return;
  float mean[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = v * V + j;
    const float2 st = stat[c / cpg];
    mean[j] = st.x;
    a[j] = gamma[c] * st.y;
    b[j] = beta[c];
  }
  const long long base = (long long)s * S * C + v * V;
  int r = lo + r0;
  for (; r + (kRowsUnroll - 1) * rpi < hi; r += kRowsUnroll * rpi) {
    float e[kRowsUnroll][V];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u)
      load_n<T, V>(x + base + (long long)(r + u * rpi) * C, e[u]);
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) e[u][j] = activate<T, ACT>((e[u][j] - mean[j]) * a[j] + b[j]);
      store_n<T, V>(y + base + (long long)(r + u * rpi) * C, e[u]);
    }
  }
  for (; r < hi; r += rpi) {
    float e[V];
    load_n<T, V>(x + base + (long long)r * C, e);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = activate<T, ACT>((e[j] - mean[j]) * a[j] + b[j]);
    store_n<T, V>(y + base + (long long)r * C, e);
  }
}

// ------------------------------------------------------------------ host

// cfg[] of dm_groupnorm_act (ops/cuda/groupnorm_act.py _CFG, in this order)
enum Cfg { kDtype, kVecCfg, kAct, kSplit, kK, kSlice, kSmem, kGridX, kGridY, kL, kS, kG, kCpg,
           kLayout };

template <typename Kernel>
cudaError_t allow(Kernel kernel, bool cluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T, bool kVec>
cudaError_t allow_variant() {
  constexpr int V = kVec ? Vec<T>::N : 1;
  cudaError_t err = allow(gn_partial<T, kVec>, false);
  if (err == cudaSuccess) err = allow(gn_apply<T, kVec, 0>, false);
  if (err == cudaSuccess) err = allow(gn_apply<T, kVec, 1>, false);
  if (err == cudaSuccess) err = allow(gn_apply<T, kVec, 2>, false);
  if (err == cudaSuccess) err = allow(gn_cluster<T, kVec, 0>, true);
  if (err == cudaSuccess) err = allow(gn_cluster<T, kVec, 1>, true);
  if (err == cudaSuccess) err = allow(gn_cluster<T, kVec, 2>, true);
  if (err == cudaSuccess) err = allow(gn_cluster_cl<T, kVec, 0>, true);
  if (err == cudaSuccess) err = allow(gn_cluster_cl<T, kVec, 1>, true);
  if (err == cudaSuccess) err = allow(gn_cluster_cl<T, kVec, 2>, true);
  if (err == cudaSuccess) err = allow(gn_partial_cl<T, V>, false);
  if (err == cudaSuccess) err = allow(gn_apply_cl<T, V, 0>, false);
  if (err == cudaSuccess) err = allow(gn_apply_cl<T, V, 1>, false);
  if (err == cudaSuccess) err = allow(gn_apply_cl<T, V, 2>, false);
  return err;
}

// The shared-memory cap and non-portable clusters for every kernel, once per
// device: attributes are caps, and setting them on every call costs host time.
cudaError_t setup() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = allow_variant<float, false>();
  if (err == cudaSuccess) err = allow_variant<float, true>();
  if (err == cudaSuccess) err = allow_variant<__nv_bfloat16, false>();
  if (err == cudaSuccess) err = allow_variant<__nv_bfloat16, true>();
  done[dev] = err == cudaSuccess;
  return err;
}

cudaLaunchConfig_t cluster_config(int grid, int k, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// channels-last x (N, S, C): path cluster at G = 1 (split 0), else rows
template <typename T, bool kVec, int ACT>
cudaError_t launch_cl(const int* cfg, const T* x, const float* gamma, const float* beta, T* y,
                      float* partials, float eps, cudaStream_t s) {
  constexpr int V = kVec ? Vec<T>::N : 1;
  const int k = cfg[kK], rows = cfg[kSlice], smem = cfg[kSmem], gx = cfg[kGridX],
            gy = cfg[kGridY], L = cfg[kL], S = cfg[kS], G = cfg[kG], cpg = cfg[kCpg];
  const long long C = (long long)G * cpg;
  if (rows < 1 || S < 1 || G < 1 || cpg < 1 || gx < 1 || gy < 1 || C * S / G != L ||
      smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  if (kVec && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16))
    return cudaErrorInvalidValue;
  if (!cfg[kSplit]) {  // a sample a cluster, as gn_cluster (slice: elements a block)
    if (G != 1 || k < 1 || k > kMaxCluster || (k & (k - 1)) || gx % k || gy != 1 ||
        (long long)k * rows < L || smem != gn_smem(rows, sizeof(T), C) ||
        (kVec && ((long long)rows * sizeof(T) % 16 || (long long)L * sizeof(T) % 16)))
      return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = cluster_config(gx, k, smem, s, &attr);
    return cudaLaunchKernelEx(&lc, gn_cluster_cl<T, kVec, ACT>, x, gamma, beta, y, L, S, (int)C,
                              rows, eps);
  }
  if (partials == nullptr || k != 1 || C / V > kThreads || C % V ||
      smem != rows_smem(C, V) || (long long)gx * rows < S || (long long)(gx - 1) * rows >= S ||
      (kVec && C * sizeof(T) % 16))
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy);
  gn_partial_cl<T, V><<<grid, kThreads, smem, s>>>(x, partials, S, G, cpg, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_cl<T, V, ACT><<<grid, kThreads, smem, s>>>(x, gamma, beta, partials, y, S, G, cpg,
                                                     rows, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec, int ACT>
cudaError_t launch(const int* cfg, const void* xv, const float* gamma, const float* beta,
                   void* yv, float* partials, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int k = cfg[kK], slice = cfg[kSlice], smem = cfg[kSmem], gx = cfg[kGridX],
            gy = cfg[kGridY], L = cfg[kL], S = cfg[kS], G = cfg[kG], cpg = cfg[kCpg];
  if (cfg[kLayout]) return launch_cl<T, kVec, ACT>(cfg, x, gamma, beta, y, partials, eps, s);
  // the wrapper's plan against this file's layout and limits
  if (slice < 1 || L < 1 || S < 1 || G < 1 || cpg < 1 || gx < 1 || gy < 1 ||
      smem != gn_smem(slice, sizeof(T), cfg[kSplit] ? 0 : slice / S + 2) ||
      smem > SMEM_LIMIT || (long long)cpg * S != L)
    return cudaErrorInvalidValue;
  if (kVec && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
               (long long)L * sizeof(T) % 16 || (long long)slice * sizeof(T) % 16))
    return cudaErrorInvalidValue;
  if (!cfg[kSplit]) {
    if (k < 1 || k > kMaxCluster || (k & (k - 1)) || gx % k || gy != 1 ||
        (long long)k * slice < L)
      return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = cluster_config(gx, k, smem, s, &attr);
    return cudaLaunchKernelEx(&lc, gn_cluster<T, kVec, ACT>, x, gamma, beta, y, L, S, G, cpg,
                              slice, eps);
  }
  if (partials == nullptr || k != 1 || (long long)gx * slice < L ||
      (long long)(gx - 1) * slice >= L)
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy);
  gn_partial<T, kVec><<<grid, kThreads, smem, s>>>(x, partials, L, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, kVec, ACT><<<grid, kThreads, smem, s>>>(x, gamma, beta, partials, y, L, S, G,
                                                      cpg, slice, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_act(const int* cfg, const void* x, const float* gamma, const float* beta,
                       void* y, float* partials, float eps, cudaStream_t s) {
  switch (cfg[kAct]) {
    case 0: return launch<T, kVec, 0>(cfg, x, gamma, beta, y, partials, eps, s);
    case 1: return launch<T, kVec, 1>(cfg, x, gamma, beta, y, partials, eps, s);
    case 2: return launch<T, kVec, 2>(cfg, x, gamma, beta, y, partials, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The largest cluster (16, 8, ... 1) this device schedules with a block at
// the full shared-memory cap, into *out (0 if none).
extern "C" int dm_groupnorm_max_cluster(int* out) {
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  *out = 0;
  for (int k = kMaxCluster; k >= 1; k /= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = cluster_config(k, k, dm_sm90::SMEM_LIMIT, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, gn_cluster<__nv_bfloat16, true, 1>, &lc);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused size is an answer, not a fault
      continue;
    }
    if (clusters >= 1) {
      *out = k;
      break;
    }
  }
  return 0;
}

// cfg: the launch's integers (Cfg order): dtype 0 = float32, 1 = bfloat16;
// vec 1 = 16-byte rows (bulk copies, vectors); act 0 = none, 1 = silu,
// 2 = relu; split; k; slice; smem; grid x, y; L; S = prod(spatial); G; C/G;
// layout 0 = channels-first, 1 = channels-last.
// x, y: (N, C, S) contiguous, or (N, S, C) contiguous (channels-last; split 1
// is path rows, slice its rows a block); gamma, beta: float32 (C,); partials:
// float32 scratch of grid x * grid y * 3 on the split path, of grid x * grid y
// * G * 3 on path rows, else unused.
extern "C" int dm_groupnorm_act(const int* cfg, const void* x, const void* gamma,
                                const void* beta, void* y, void* partials, float eps,
                                void* stream) {
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partials);
  const int vec = cfg[kVecCfg];
  if (cfg[kDtype] == 0)
    return (int)(vec ? launch_act<float, true>(cfg, x, g, b, y, p, eps, s)
                     : launch_act<float, false>(cfg, x, g, b, y, p, eps, s));
  if (cfg[kDtype] == 1)
    return (int)(vec ? launch_act<__nv_bfloat16, true>(cfg, x, g, b, y, p, eps, s)
                     : launch_act<__nv_bfloat16, false>(cfg, x, g, b, y, p, eps, s));
  return (int)cudaErrorInvalidValue;
}
