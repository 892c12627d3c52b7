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
// in practice launches and the latency of small grids bound it. A block
// cannot hold the E=1024 weights (w_qkv alone is 6 MB), so the TPU kernel's
// single program splits into three launches here:
//   1. gemm_bias: Y = X @ W + b, tiles of 64x64 with K steps of 32. bf16 runs
//      on the tensor cores through nvcuda::wmma 16x16x16 fragments with
//      float32 accumulation; float32 runs a SIMT tile (no TF32, so a float32
//      check stays float32). W may be row-major (K, N) or a transposed view
//      of an (N, K) matrix: the tile load follows its strides, so the
//      nn.MultiheadAttention parameters are read in place.
//   2. attention_core: one block per (sample, head, 16-query tile). The
//      16 x T score rows (T <= 1024) stay in shared memory in float32, the
//      softmax is float32, P is rounded to the compute dtype as the XLA
//      path does, and P.V accumulates in float32 registers: 16 x hd floats
//      over 256 threads, 32 a thread at hd=512.
//   3. gemm_bias again for the output projection.
// The head dims 128/256/512 are past what stock flash-attention layouts
// assume; this design holds a whole score row instead of streaming it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, bf16* p) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------- GEMM + bias

constexpr int BM = 64, BN = 64, BK = 32;

// Y[M, N] = X[M, K] @ W + bias, W[k, n] at W[k * sk + n * sn]; 4 warps, each
// owns a 32x32 quarter of the 64x64 tile as 2x2 wmma fragments.
__global__ void __launch_bounds__(128)
gemm_bias_bf16(const bf16* __restrict__ X, const bf16* __restrict__ W, long long sk,
               long long sn, const float* __restrict__ bias, bf16* __restrict__ Y,
               long long M, long long N, long long K) {
  __shared__ __align__(32) bf16 As[BM][BK + 8];
  __shared__ __align__(32) bf16 Bs[BK][BN + 8];
  __shared__ __align__(32) float Cs[BM][BN + 4];
  const long long row0 = (long long)blockIdx.y * BM, col0 = (long long)blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += 128) {
      const int m = idx / BK, k = idx % BK;
      const long long gr = row0 + m, gk = k0 + k;
      As[m][k] = (gr < M && gk < K) ? X[gr * K + gk] : zero;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += 128) {
      int k, n;  // walk W along its contiguous axis
      if (sn == 1) { k = idx / BN; n = idx % BN; } else { n = idx / BK; k = idx % BK; }
      const long long gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? W[gk * sk + gn * sn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], BK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], BN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], BN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += 128) {
    const int m = idx / BN, n = idx % BN;
    const long long gr = row0 + m, gc = col0 + n;
    if (gr < M && gc < N) Y[gr * N + gc] = __float2bfloat16(Cs[m][n] + bias[gc]);
  }
}

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

// ------------------------------------------------------------ attention core

constexpr int BQ = 16, BKV = 32, ATT_THREADS = 256;

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

// qkv: (N, T, 3E) with E = H * HD, q | k | v along the last axis, heads
// contiguous inside each; out: (N, T, E). grid (ceil(T / BQ), H, N).
template <typename T, int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core(const T* __restrict__ qkv, T* __restrict__ out, int seq, int H) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;  // padded rows: lanes on different keys hit different banks
  float* Qs = smem;            // BQ x LD
  float* KVs = Qs + BQ * LD;   // BKV x LD
  float* Ss = KVs + BKV * LD;  // BQ x (seq + 1)
  const int SLD = seq + 1;
  const int E = H * HD;
  const long long rs = 3LL * E;
  const int h = blockIdx.y;
  const T* base = qkv + (long long)blockIdx.z * seq * rs;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const float sqrt_hd = sqrtf((float)HD);

  for (int idx = tid; idx < BQ * HD; idx += ATT_THREADS) {
    const int r = idx / HD, d = idx % HD;
    Qs[r * LD + d] = (q0 + r < seq) ? to_f32(base[(long long)(q0 + r) * rs + h * HD + d]) : 0.f;
  }

  // scores: thread (si, sj) computes keys sj and sj + 16 of each key tile
  const int si = tid / 16, sj = tid % 16;
  for (int j0 = 0; j0 < seq; j0 += BKV) {
    __syncthreads();
    for (int idx = tid; idx < BKV * HD; idx += ATT_THREADS) {
      const int r = idx / HD, d = idx % HD;
      KVs[r * LD + d] =
          (j0 + r < seq) ? to_f32(base[(long long)(j0 + r) * rs + E + h * HD + d]) : 0.f;
    }
    __syncthreads();
    const float* qrow = Qs + si * LD;
    const float* k0 = KVs + sj * LD;
    const float* k1 = KVs + (sj + 16) * LD;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float q = qrow[d];
      a0 += q * k0[d];
      a1 += q * k1[d];
    }
    if (j0 + sj < seq) Ss[si * SLD + j0 + sj] = a0 / sqrt_hd;
    if (j0 + sj + 16 < seq) Ss[si * SLD + j0 + sj + 16] = a1 / sqrt_hd;
  }
  __syncthreads();

  // softmax in float32, one warp per two rows; P rounded to the compute dtype
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp * 2; r < warp * 2 + 2; ++r) {
    float* srow = Ss + r * SLD;
    float m = -INFINITY;
    for (int j = lane; j < seq; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < seq; j += 32) srow[j] = round_as(srow[j] / sum, qkv);
  }

  // P.V: thread owns CPT columns of RPT rows, accumulated in registers
  constexpr int TC = HD < ATT_THREADS ? HD : ATT_THREADS;
  constexpr int CPT = HD / TC;
  constexpr int RG = ATT_THREADS / TC;
  constexpr int RPT = BQ / RG;
  const int tc = tid % TC, rg = tid / TC;
  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < seq; j0 += BKV) {
    __syncthreads();
    for (int idx = tid; idx < BKV * HD; idx += ATT_THREADS) {
      const int r = idx / HD, d = idx % HD;
      KVs[r * LD + d] =
          (j0 + r < seq) ? to_f32(base[(long long)(j0 + r) * rs + 2 * E + h * HD + d]) : 0.f;
    }
    __syncthreads();
    const int jn = min(BKV, seq - j0);
    for (int j = 0; j < jn; ++j) {
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[c] = KVs[j * LD + tc + c * TC];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = Ss[(rg * RPT + r) * SLD + j0 + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] += p * v[c];
      }
    }
  }
  T* ob = out + (long long)blockIdx.z * seq * E;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + rg * RPT + r;
    if (row < seq) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) from_f32(acc[r][c], ob + (long long)row * E + h * HD + tc + c * TC);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_core(const void* qkv, void* out, long long n, long long seq, int H,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BKV) * (HD + 1) + (size_t)BQ * (seq + 1));
  auto kernel = attention_core<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((seq + BQ - 1) / BQ), (unsigned)H, (unsigned)n);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                              (int)seq, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_core(const void* qkv, void* out, long long n, long long seq, int H,
                          int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_core<T, 32>(qkv, out, n, seq, H, s);
    case 128: return launch_core<T, 128>(qkv, out, n, seq, H, s);
    case 256: return launch_core<T, 256>(qkv, out, n, seq, H, s);
    case 512: return launch_core<T, 512>(qkv, out, n, seq, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. X (M, K) and Y (M, N) contiguous, bias
// float32 (N,), W[k, n] at W[k * sk + n * sn].
extern "C" int dm_gemm_bias(int dtype, const void* X, const void* W, long long sk,
                            long long sn, const void* bias, void* Y, long long M,
                            long long N, long long K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  if (dtype == 0) {
    gemm_bias_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(X),
                                       static_cast<const float*>(W), sk, sn,
                                       static_cast<const float*>(bias),
                                       static_cast<float*>(Y), M, N, K);
  } else if (dtype == 1) {
    gemm_bias_bf16<<<grid, 128, 0, s>>>(static_cast<const bf16*>(X),
                                        static_cast<const bf16*>(W), sk, sn,
                                        static_cast<const float*>(bias),
                                        static_cast<bf16*>(Y), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// qkv (n, seq, 3 * H * hd) -> out (n, seq, H * hd), both contiguous.
extern "C" int dm_attention_core(int dtype, const void* qkv, void* out, long long n,
                                 long long seq, int H, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_core<float>(qkv, out, n, seq, H, hd, s);
  if (dtype == 1) return (int)dispatch_core<bf16>(qkv, out, n, seq, H, hd, s);
  return (int)cudaErrorInvalidValue;
}
