// Multi-head self-attention (K2) for Hopper: QKV projection, attention core,
// output projection, each a hand-written kernel.
//
// Replaces the TPU kernel
//   diffusion_model_project_tpu/ops/pallas/attention.py::fused_attention
// (one program per batch row: x@w_qkv+b, head split, QK^T/sqrt(hd), softmax,
// .V, head merge, @w_out+b, everything resident in VMEM).
//
// Bound on the H100: at the UNet's shapes (N = B*11 slices, 2 heads,
// (T, E, hd) = (256, 256, 128), (64, 512, 256), (16, 1024, 512)) the work is
// light (about 21 GFLOP per UNet forward at B=2, ~21 us at the bf16 tensor
// peak) and the bytes are few (weights plus activations, ~42 MB, ~13 us), so
// launches and the latency of small grids bound it. A block cannot hold the
// E=1024 weights (w_qkv alone is 6 MB), so the TPU kernel's single program
// splits into three launches here. bf16, the working type:
//   1. gemm_bias_sm90: Y = X @ W + b. One producer warp keeps a ring of 4
//      shared-memory stages full with TMA (128-byte swizzled boxes of 64 K
//      columns); one or two consumer warpgroups multiply each stage with
//      wgmma (m64nBNk16, float32 accumulators in registers) and release it
//      through the stage's empty mbarrier. W is read in place in either
//      layout: a transposed view of an (N, K) matrix (what nn.MultiheadAttention
//      keeps, K-major B) or a row-major (K, N) matrix (MN-major B, wgmma's
//      transpose bit). The bias is added to the float32 sum in registers and
//      the result rounds once to bf16, then leaves through shared memory as
//      16-byte stores masked at a ragged M. The tile (128x128, 128x64 or
//      64x64) is the wrapper's choice, so that each GEMM fills the 132 SMs.
//   2. attention_core_sm90: one block per (sample, head, 64 queries), so K
//      and V are read T / 64 times per (sample, head). TMA reads q | k | v in
//      bf16 from the (N, T, 3E) buffer through a 3-D map, so a box zero-fills
//      past T inside one sample; 64-key tiles of K and V stream through a
//      ring that thread 0 refills. S = Q K^T runs on wgmma; the softmax is
//      float32; P rounds to bf16 after it is normalised, as the plain
//      version does, and P.V runs on wgmma with P from registers and V as
//      MN-major B. The whole score row is held exactly: a first pass over
//      the keys takes each row's max and sum, a second recomputes S and
//      multiplies, so no output is rescaled and no buffer grows with T: any
//      T runs. At hd = 256 and 512 two consumer warpgroups split the
//      output's columns (at most 128 float32 accumulators a thread) and
//      each computes S. At T = 16 a 64-row tile is three quarters padding;
//      wgmma still runs it, as the work there is a few MFLOP a block. The
//      core has instances at hd = 32, 64, 128, 256 and 512; the wrapper runs
//      any other hd <= 512 at the next instance through zero-padded copies
//      of the weights (zero columns of Q and K add nothing to QK^T, zero
//      columns of V give outputs that the padded w_out rows drop); the
//      scores are scaled by 1 / sqrt of the true hd, a launch argument, a
//      product where a division costs a dozen instructions.
//   3. gemm_bias_sm90 again for the output projection.
// float32 keeps the SIMT GEMM of the first port (full float32 products, no
// TF32: the card is held to its CPU result at 1e-4), and its core is
// attention_core_simt: one block per (sample, head, 16 queries, 512 output
// columns), 32-key tiles streamed through shared memory with an online
// softmax (running max and sum, the accumulators rescaled a tile), so no
// buffer grows with T; QK^T runs over the head dim in chunks of at most 512
// columns, so any hd runs. bf16 takes the same core past hd = 512, where a
// 64-row Q tile and a K tile no longer fit one block's shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mainloop.cuh"

namespace {

using namespace dm_sm90;
typedef __nv_bfloat16 bf16;

// --------------------------------------------------------- GEMM + bias, bf16

constexpr int GEMM_BK = 64;  // one 128-byte swizzle row of bf16

// must equal ops/cuda/attention.py::gemm_smem
constexpr int gemm_smem(int bm, int bn, int stages) {
  return kAlignSlack + stages * (bm + bn) * GEMM_BK * 2 + bm * (bn + 8) * 2 + 16 * stages;
}

// Y[M, N] = X[M, K] @ W + bias. grid (ceil(M / BM), ceil(N / BN)); threads:
// BM / 64 consumer warpgroups, then one producer warp.
template <int BM, int BN, bool W_MN>
__global__ void __launch_bounds__(BM / 64 * 128 + 32, 1)
gemm_bias_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const bf16* __restrict__ bias, bf16* __restrict__ Y, int M, int N, int K,
               int stages) {
  constexpr int NWG = BM / 64;
  constexpr int A_BYTES = BM * GEMM_BK * 2, STAGE = (BM + BN) * GEMM_BK * 2;
  constexpr int EPI_LD = BN + 8;  // padded rows: the quads of a warp hit distinct banks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  bf16* epi = reinterpret_cast<bf16*>(ring + stages * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + BM * EPI_LD);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + GEMM_BK - 1) / GEMM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer
    if (lane == 0) {
      Ring r(stages);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[r.stage], r.phase ^ 1u);
        uint8_t* st = ring + r.stage * STAGE;
        mbar_expect_tx(&full[r.stage], STAGE);
        tma_load_2d(st, &tm_x, &full[r.stage], kt * GEMM_BK, m0);
        if (W_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + A_BYTES + j * 64 * GEMM_BK * 2, &tm_w, &full[r.stage], n0 + 64 * j,
                        kt * GEMM_BK);
        } else {
          tma_load_2d(st + A_BYTES, &tm_w, &full[r.stage], kt * GEMM_BK, n0);
        }
        r.advance();
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4, t = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  Ring r(stages);
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[r.stage], r.phase);
    const uint32_t a = smem_u32(ring + r.stage * STAGE) + wg * 64 * GEMM_BK * 2;
    mma_k64<W_MN ? 1 : 0>(acc, a, smem_u32(ring + r.stage * STAGE + A_BYTES), kt == 0);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: bias in registers, one rounding to bf16, 16-byte stores
  const int wi = t / 32, g = (t % 32) / 4, q = t % 4;
  bf16* e = epi + wg * 64 * EPI_LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q, gc = n0 + col;
    const float b0 = gc < N ? __bfloat162float(bias[gc]) : 0.f;
    const float b1 = gc + 1 < N ? __bfloat162float(bias[gc + 1]) : 0.f;
    const int r0 = 16 * wi + g;
    *reinterpret_cast<__nv_bfloat162*>(&e[r0 * EPI_LD + col]) =
        __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(&e[(r0 + 8) * EPI_LD + col]) =
        __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  named_barrier_sync(1 + wg, 128);
  for (int idx = t; idx < 64 * BN / 8; idx += 128) {
    const int row = idx / (BN / 8), c8 = idx % (BN / 8);
    const long long gr = m0 + 64 * wg + row;
    const int gc = n0 + 8 * c8;
    if (gr < M && gc < N)
      *reinterpret_cast<uint4*>(&Y[gr * N + gc]) =
          *reinterpret_cast<const uint4*>(&e[row * EPI_LD + 8 * c8]);
  }
}

template <int BM, int BN, bool W_MN>
cudaError_t launch_gemm(const CUtensorMap& tx, const CUtensorMap& tw, const bf16* bias, bf16* Y,
                        long long M, long long N, long long K, int stages, int smem,
                        cudaStream_t s) {
  if (stages < 2 || smem < gemm_smem(BM, BN, stages) || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  auto kernel = gemm_bias_sm90<BM, BN, W_MN>;
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kernel<<<grid, BM / 64 * 128 + 32, smem, s>>>(tx, tw, bias, Y, (int)M, (int)N, (int)K, stages);
  return cudaGetLastError();
}

template <bool W_MN>
cudaError_t dispatch_gemm(int bm, int bn, const CUtensorMap& tx, const CUtensorMap& tw,
                          const bf16* bias, bf16* Y, long long M, long long N, long long K,
                          int stages, int smem, cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch_gemm<128, 128, W_MN>(tx, tw, bias, Y, M, N, K, stages, smem, s);
  if (bm == 128 && bn == 64)
    return launch_gemm<128, 64, W_MN>(tx, tw, bias, Y, M, N, K, stages, smem, s);
  if (bm == 64 && bn == 64)
    return launch_gemm<64, 64, W_MN>(tx, tw, bias, Y, M, N, K, stages, smem, s);
  return cudaErrorInvalidValue;
}

cudaError_t gemm_bias_bf16(const void* X, const void* W, long long sk, long long sn,
                           const void* bias, void* Y, long long M, long long N, long long K,
                           int bm, int bn, int stages, int smem, cudaStream_t s) {
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {GEMM_BK, (cuuint32_t)bm};
  cudaError_t err = make_map_bf16(&tx, X, 2, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return err;
  const bool w_mn = sn == 1 && sk == N;  // row-major (K, N)
  if (!w_mn && !(sk == 1 && sn == K)) return cudaErrorInvalidValue;
  if (w_mn) {  // boxes of 64 N columns by 64 K rows
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
    const cuuint32_t box[2] = {64, GEMM_BK};
    err = make_map_bf16(&tw, W, 2, dims, strides, box);
  } else {  // the (N, K) storage: boxes of 64 K columns by BN rows
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {GEMM_BK, (cuuint32_t)bn};
    err = make_map_bf16(&tw, W, 2, dims, strides, box);
  }
  if (err != cudaSuccess) return err;
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* y = static_cast<bf16*>(Y);
  return w_mn ? dispatch_gemm<true>(bm, bn, tx, tw, b, y, M, N, K, stages, smem, s)
              : dispatch_gemm<false>(bm, bn, tx, tw, b, y, M, N, K, stages, smem, s);
}

// ---------------------------------------------------- attention core, bf16

template <int HD>
struct Core {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // columns a tile loads (64-column boxes)
  static constexpr int BOXES = HDP / 64;
  static constexpr int TILE = 64 * HDP * 2;      // bytes of 64 rows of Q, K or V
  static constexpr int NWG = HD >= 256 ? 2 : 1;  // consumer warpgroups
  static constexpr int NJ = HDP / NWG / 64;      // 64-column output chunks a warpgroup owns
};

// must equal ops/cuda/attention.py::core_smem
constexpr int core_smem(int hd, int stages) {
  return kAlignSlack + 64 * (hd < 64 ? 64 : hd) * 2 * (1 + stages) + 8 * (2 * stages + 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The core's stream of K / V tiles through the ring: tile i is K_i for
// i < nb (pass 1), then K_b, V_b for b = 0 .. nb-1 (pass 2). There is no
// producer warp: a warp beside two consumer warpgroups would cost a third
// warpgroup's registers, and at hd = 512 the two need 128 accumulators a
// thread each. Thread 0 issues the first `stages` tiles, and refills each
// stage as soon as every consumer thread has released it.
struct CoreStream {
  const CUtensorMap* tm;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int tile_bytes, boxes, nb, stages, E, col, n;  // col: this head's first column in q
  Ring r;
  int i = 0;

  __device__ __forceinline__ void issue(int tile, int stage) const {
    int col0 = E + col, row0 = 64 * tile;
    if (tile >= nb) {
      const int j = tile - nb;
      col0 = (j & 1 ? 2 * E : E) + col;
      row0 = 64 * (j >> 1);
    }
    mbar_expect_tx(&full[stage], tile_bytes);
    for (int c = 0; c < boxes; ++c)
      tma_load_3d(ring + stage * tile_bytes + c * 8192, tm, &full[stage], col0 + 64 * c, row0, n);
  }
  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(&full[r.stage], r.phase);
    return smem_u32(ring + r.stage * tile_bytes);
  }
  __device__ __forceinline__ void release() {
    mbar_arrive(&empty[r.stage]);
    if (threadIdx.x == 0 && i + stages < 3 * nb) {
      mbar_wait(&empty[r.stage], r.phase);
      issue(i + stages, r.stage);
    }
    __syncwarp();
    ++i;
    r.advance();
  }
};

// S = Q K_b^T for the next tile of the stream (a K tile, then released),
// times `scale` (1 / sqrt(hd), rounded to float32) and masked past T.
// Element i sits at row g + 8 * ((i >> 1) & 1) of the warp's 16 and key
// 64 b + 8 (i >> 2) + 2 qd + (i & 1).
template <int HD>
__device__ __forceinline__ void core_scores(float (&s)[32], CoreStream& st, uint32_t qa, int b,
                                            int seq, int qd, float scale) {
  const uint32_t kb = st.wait();
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    wgmma_ss<0>(s, desc_kmajor(qa + off), desc_kmajor(kb + off), kk > 0 ? 1 : 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  st.release();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = 64 * b + 8 * (i >> 2) + 2 * qd + (i & 1);
    s[i] = key < seq ? s[i] * scale : -INFINITY;
  }
}

// qkv: (N, T, 3E) through tm (dims {3E, T, N}, boxes {64, 64, 1}), q | k | v
// along the last axis, heads contiguous inside each; out: (N, T, E).
// grid (ceil(T / 64), H, N); threads: Core<HD>::NWG consumer warpgroups.
template <int HD>
__global__ void __launch_bounds__(Core<HD>::NWG * 128, 1)
attention_core_sm90(const __grid_constant__ CUtensorMap tm, bf16* __restrict__ out, int seq,
                    int H, int stages, float scale) {
  using C = Core<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * C::TILE);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;
  const int E = H * HD, h = blockIdx.y, n = blockIdx.z, q0 = blockIdx.x * 64;
  const int nb = (seq + 63) / 64;
  CoreStream st{&tm, ring, full, empty, C::TILE, C::BOXES, nb, stages, E, h * HD, n,
                Ring(stages)};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 128);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, C::TILE);
    for (int c = 0; c < C::BOXES; ++c)
      tma_load_3d(q_s + c * 8192, &tm, q_full, h * HD + 64 * c, q0, n);
    for (int i = 0; i < stages && i < 3 * nb; ++i) st.issue(i, i);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32, wg = warp / 4, t = threadIdx.x % 128;
  const int wi = t / 32, g = (t % 32) / 4, qd = t % 4;
  const uint32_t qa = smem_u32(q_s);
  float s[32];
  mbar_wait(q_full, 0);

  // pass 1: each row's max and sum of exp over all keys, in float32
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int b = 0; b < nb; ++b) {
    core_scores<HD>(s, st, qa, b, seq, qd, scale);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == half) mx = fmaxf(mx, s[i]);
      const float mn = fmaxf(m[half], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == half) sum += expf(s[i] - mn);
      l[half] = l[half] * expf(m[half] - mn) + quad_sum(sum);
      m[half] = mn;
    }
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: P = softmax rounded to bf16, O += P . V on this warpgroup's columns
  float o[C::NJ][32];
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  for (int b = 0; b < nb; ++b) {
    core_scores<HD>(s, st, qa, b, seq, qd, scale);
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 8 * c + 2 * k, half = k & 1;
        pa[c][k] = pack_bf16(expf(s[i] - m[half]) * inv_l[half],
                             expf(s[i + 1] - m[half]) * inv_l[half]);
      }
    const uint32_t vb = st.wait() + wg * C::NJ * 8192;
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) fence_regs(o[j]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        wgmma_rs<1>(o[j], pa[c], desc_mnmajor(vb + j * 8192 + c * 2048, 8192), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) fence_regs(o[j]);
    st.release();
  }

  bf16* ob = out + (long long)n * seq * E + h * HD;
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = wg * C::NJ * 64 + 64 * j + 8 * jj + 2 * qd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + 16 * wi + g + 8 * half;
        if (col < HD && row < seq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * E + col) =
              __floats2bfloat162_rn(o[j][4 * jj + 2 * half], o[j][4 * jj + 2 * half + 1]);
      }
    }
}

template <int HD>
cudaError_t launch_core_sm90(const void* qkv, void* out, long long n, long long seq, int H,
                             float scale, int stages, int smem, cudaStream_t s) {
  if (stages < 2 || smem < core_smem(HD, stages) || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  const long long E = (long long)H * HD;
  CUtensorMap tm;
  const cuuint64_t dims[3] = {(cuuint64_t)(3 * E), (cuuint64_t)seq, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)(3 * E * 2), (cuuint64_t)(seq * 3 * E * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  cudaError_t err = make_map_bf16(&tm, qkv, 3, dims, strides, box);
  if (err != cudaSuccess) return err;
  auto kernel = attention_core_sm90<HD>;
  static bool ready[MAX_DEVICES] = {};
  err = allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((seq + 63) / 64), (unsigned)H, (unsigned)n);
  kernel<<<grid, Core<HD>::NWG * 128, smem, s>>>(tm, static_cast<bf16*>(out), (int)seq, H,
                                                      stages, scale);
  return cudaGetLastError();
}

// --------------------------------- float32 GEMM and the SIMT core (any hd)

constexpr int BM = 64, BN = 64;

// float32 SIMT tile: 256 threads, 4x4 outputs each, K steps of 16.
__global__ void __launch_bounds__(256)
gemm_bias_f32(const float* __restrict__ X, const float* __restrict__ W, long long sk,
              long long sn, const float* __restrict__ bias, float* __restrict__ Y,
              long long M, long long N, long long K) {
  constexpr int TK = 16;
  __shared__ float As[TK][BM + 4];
  __shared__ float Bs[TK][BN + 4];
  const long long row0 = (long long)blockIdx.y * BM, col0 = (long long)blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < K; k0 += TK) {
    for (int idx = threadIdx.x; idx < BM * TK; idx += 256) {
      const int m = idx / TK, k = idx % TK;
      const long long gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? X[gr * K + gk] : 0.f;
    }
    for (int idx = threadIdx.x; idx < TK * BN; idx += 256) {
      int k, n;
      if (sn == 1) { k = idx / BN; n = idx % BN; } else { n = idx / TK; k = idx % TK; }
      const long long gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? W[gk * sk + gn * sn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gc = col0 + tx * 4 + j;
      if (gr < M && gc < N) Y[gr * N + gc] = acc[i][j] + bias[gc];
    }
  }
}

constexpr int BQ = 16, BKV = 32, ATT_THREADS = 256;
constexpr int SLD = BKV + 1;  // score rows, padded

// must equal ops/cuda/attention.py::simt_smem
constexpr int simt_smem(int hdc) { return 4 * ((BQ + BKV) * (hdc + 1) + BQ * SLD + 3 * BQ); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows x HDC floats into dst (row stride HDC + 1): columns d0 .. d0 + HDC - 1
// of one head's q, k or v (its first column `col` of a (T, 3E) row of
// `base`), rows row0 .. row0 + rows - 1; zero past seq and past hd.
template <typename T, int HDC>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ base, long long rs,
                                          int rows, int row0, int col, int d0, int seq, int hd) {
  for (int idx = threadIdx.x; idx < rows * HDC; idx += ATT_THREADS) {
    const int r = idx / HDC, d = idx % HDC;
    dst[r * (HDC + 1) + d] = (row0 + r < seq && d0 + d < hd)
                                 ? to_float(base[(long long)(row0 + r) * rs + col + d0 + d])
                                 : 0.f;
  }
}

// qkv: (N, T, 3E), out: (N, T, E), as above, E = H * hd for any hd >= 1.
// grid (ceil(T / BQ), H * nsplit, N): block y = h * nsplit + c writes the
// output columns c * HDC .. c * HDC + HDC - 1 of head h (nsplit = ceil(hd /
// HDC)), and takes QK^T over ceil(hd / HDC) chunks of HDC columns; with one
// chunk Q stays resident. Products and the softmax run in float32.
template <typename T, int HDC>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_simt(const T* __restrict__ qkv, T* __restrict__ out, int seq, int H, int hd,
                    int nsplit, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HDC + 1;  // padded rows: lanes on different keys hit different banks
  float* Qs = smem;            // BQ x LD
  float* KVs = Qs + BQ * LD;   // BKV x LD
  float* Ss = KVs + BKV * LD;  // BQ x SLD: scores, then P
  float* m_s = Ss + BQ * SLD;  // each row's running max
  float* l_s = m_s + BQ;       // ... and running sum of exp
  float* a_s = l_s + BQ;       // ... and this tile's rescale of the accumulators
  const int E = H * hd;
  const long long rs = 3LL * E;
  const int h = blockIdx.y / nsplit, c0 = (blockIdx.y % nsplit) * HDC;
  const T* base = qkv + (long long)blockIdx.z * seq * rs;
  const int q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int nd = (hd + HDC - 1) / HDC;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (nd == 1) load_rows<T, HDC>(Qs, base, rs, BQ, q0, h * hd, 0, seq, hd);

  // scores: thread (si, sj) computes keys sj and sj + 16 of each key tile
  const int si = tid / 16, sj = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  // P.V: thread (rg, tc) owns CPT columns of RPT rows, in registers
  constexpr int TC = HDC < ATT_THREADS ? HDC : ATT_THREADS;
  constexpr int CPT = HDC / TC;
  constexpr int RG = ATT_THREADS / TC;
  constexpr int RPT = BQ / RG;
  const int tc = tid % TC, rg = tid / TC;
  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < seq; j0 += BKV) {
    float a0 = 0.f, a1 = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      __syncthreads();  // the previous users of Qs, KVs and Ss are done
      if (nd > 1) load_rows<T, HDC>(Qs, base, rs, BQ, q0, h * hd, dc * HDC, seq, hd);
      load_rows<T, HDC>(KVs, base, rs, BKV, j0, E + h * hd, dc * HDC, seq, hd);
      __syncthreads();
      const float* qrow = Qs + si * LD;
      const float* k0 = KVs + sj * LD;
      const float* k1 = KVs + (sj + 16) * LD;
#pragma unroll 8
      for (int d = 0; d < HDC; ++d) {
        const float q = qrow[d];
        a0 += q * k0[d];
        a1 += q * k1[d];
      }
    }
    Ss[si * SLD + sj] = j0 + sj < seq ? a0 * scale : -INFINITY;
    Ss[si * SLD + sj + 16] = j0 + sj + 16 < seq ? a1 * scale : -INFINITY;
    __syncthreads();
    // this block's columns of V, while each warp updates two rows' softmax:
    // lane j holds key j0 + j (BKV is the warp's width)
    load_rows<T, HDC>(KVs, base, rs, BKV, j0, 2 * E + h * hd, c0, seq, hd);
    for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
      const float sv = Ss[r * SLD + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = expf(sv - m_new);
      Ss[r * SLD + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first tile
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    const int jn = min(BKV, seq - j0);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float alpha = a_s[rg * RPT + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < jn; ++j) {
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[c] = KVs[j * LD + tc + c * TC];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = Ss[(rg * RPT + r) * SLD + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] += p * v[c];
      }
    }
  }
  T* ob = out + (long long)blockIdx.z * seq * E + h * hd;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + rg * RPT + r;
    if (row < seq) {
      const float inv_l = 1.f / l_s[rg * RPT + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = c0 + tc + c * TC;
        if (col < hd) ob[(long long)row * E + col] = from_float<T>(acc[r][c] * inv_l);
      }
    }
  }
}

template <typename T, int HDC>
cudaError_t launch_core_simt(const void* qkv, void* out, long long n, long long seq, int H,
                             int hd, float scale, int smem, cudaStream_t stream) {
  if (smem < simt_smem(HDC) || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = attention_core_simt<T, HDC>;
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  const int nsplit = (hd + HDC - 1) / HDC;
  dim3 grid((unsigned)((seq + BQ - 1) / BQ), (unsigned)(H * nsplit), (unsigned)n);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                              (int)seq, H, hd, nsplit, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. X (M, K) and Y (M, N) contiguous, bias
// (N,) in X's dtype, W[k, n] at W[k * sk + n * sn]: row-major (sk = N,
// sn = 1) or a transposed view of an (N, K) matrix (sk = 1, sn = K).
// bf16: tile bm x bn in (128, 128), (128, 64), (64, 64), `stages` ring
// stages and `smem` dynamic shared memory bytes, as the wrapper planned them
// (float32 ignores the three).
extern "C" int dm_gemm_bias(int dtype, const void* X, const void* W, long long sk,
                            long long sn, const void* bias, void* Y, long long M,
                            long long N, long long K, int bm, int bn, int stages, int smem,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)gemm_bias_bf16(X, W, sk, sn, bias, Y, M, N, K, bm, bn, stages, smem, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  gemm_bias_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(X), static_cast<const float*>(W),
                                     sk, sn, static_cast<const float*>(bias),
                                     static_cast<float*>(Y), M, N, K);
  return (int)cudaGetLastError();
}

// qkv (n, seq, 3 * H * hd) -> out (n, seq, H * hd), both contiguous; the
// scores are multiplied by scale (1 / sqrt of the head dim before padding).
// simt = 0: the bf16 wgmma core (hd 32, 64, 128, 256 or 512, with `stages`
// ring stages); simt = 32 .. 512: the SIMT core in chunks of that many
// columns (any hd). `smem` bytes as planned.
extern "C" int dm_attention_core(int dtype, const void* qkv, void* out, long long n,
                                 long long seq, int H, int hd, float scale, int simt,
                                 int stages, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && simt == 0) {
    switch (hd) {
      case 32: return (int)launch_core_sm90<32>(qkv, out, n, seq, H, scale, stages, smem, s);
      case 64: return (int)launch_core_sm90<64>(qkv, out, n, seq, H, scale, stages, smem, s);
      case 128: return (int)launch_core_sm90<128>(qkv, out, n, seq, H, scale, stages, smem, s);
      case 256: return (int)launch_core_sm90<256>(qkv, out, n, seq, H, scale, stages, smem, s);
      case 512: return (int)launch_core_sm90<512>(qkv, out, n, seq, H, scale, stages, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    if (simt != 512) return (int)cudaErrorInvalidValue;
    return (int)launch_core_simt<bf16, 512>(qkv, out, n, seq, H, hd, scale, smem, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (simt) {
    case 32: return (int)launch_core_simt<float, 32>(qkv, out, n, seq, H, hd, scale, smem, s);
    case 64: return (int)launch_core_simt<float, 64>(qkv, out, n, seq, H, hd, scale, smem, s);
    case 128: return (int)launch_core_simt<float, 128>(qkv, out, n, seq, H, hd, scale, smem, s);
    case 256: return (int)launch_core_simt<float, 256>(qkv, out, n, seq, H, hd, scale, smem, s);
    case 512: return (int)launch_core_simt<float, 512>(qkv, out, n, seq, H, hd, scale, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
