// 3x3 stride-1 "same" convolution (K3) for Hopper, as an implicit GEMM.
//
// Replaces the TPU kernel
//   scripts/perf_probe_conv.py::make_pallas_conv
// (one program per (image, th x tw output tile): a (th+2) x (tw+2) x Cin
// halo tile of a zero-padded copy of x and all of W in VMEM, nine shifted
// [pix, Cin] @ [Cin, Cout] MXU products accumulated in float32).
//
//   y[n,h,w,o] = sum_{di,dj,c} x[n, h+di-1, w+dj-1, c] * W[di, dj, c, o]
//
// x (N, H, W, Cin), W (3, 3, Cin, Cout) HWIO and y (N, H, W, Cout), all
// contiguous. Taps outside the image read zero: the kernel masks them, so
// no padded copy of x is made. bf16 in, float32 accumulation, one rounding
// to bf16 at the end; float32 runs SIMT float32 products (no TF32).
//
// Bound on the H100: the VAE's stages (44 images at 256^2 x 128, 128^2 x 256,
// 64^2 x 512 channels) each do 0.85 TFLOP against 0.37-1.48 GB of x + y + W,
// 575-2,300 operations a byte, far above the card's ~295: the bf16 tensor
// cores bound them (0.86 ms a stage at 989 TFLOP/s).
//
// Design, simple and right first. The GEMM is M = output pixels, N = Cout,
// K = 9 * Cin. A block owns TH x TW output pixels x BN = 128 channels and
// walks Cin in chunks of BK = 32. Per chunk it stages the (TH+2) x (TW+2) x
// BK halo tile of x and the nine BK x BN weight slices in shared memory,
// then runs nine shifted products on wmma bf16 16x16x16 fragments with
// float32 accumulators. TW is a multiple of 16, so the 16 pixels of an A
// fragment lie in one halo row at a stride of one pixel: load_matrix_sync
// reads them in place, with ldm = BK + 16 (a row of 96 bytes keeps every
// pixel 32-byte aligned, as wmma requires). The TPU's VMEM-sized tiles (up
// to 32 x 256 pixels x all of Cin) do not fit a block and are not copied.
// Loads are synchronous and wmma is mma.sync, well short of the peak:
// wgmma, TMA and a pipeline of stages belong to a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
// bf16: BN output channels a block, BK input channels a chunk
constexpr int BN = 128, BK = 32, LDA = BK + 16, LDB = BN + 8, LDC = 20;
// float32: BNF output channels a block, BKF input channels a chunk
constexpr int BNF = 64, BKF = 16;

struct Tile {
  long long n, h0, w0;
};

template <int TH, int TW>
__device__ __forceinline__ Tile tile_of(long long id, int H, int W) {
  const long long tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  Tile t;
  t.n = id / (tiles_w * tiles_h);
  t.h0 = (id / tiles_w % tiles_h) * TH;
  t.w0 = (id % tiles_w) * TW;
  return t;
}

// Stage the (TH+2) x (TW+2) x KC halo tile of x at channels k0.., zero
// outside the image and past Cin; pixel p's channels at halo[p * ld].
template <int TH, int TW, int KC, typename T>
__device__ __forceinline__ void load_halo(const T* __restrict__ x, T* halo, int ld, Tile t,
                                          int H, int W, int Cin, int k0, bool vec) {
  constexpr int HP = (TH + 2) * (TW + 2);
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  for (int idx = threadIdx.x; idx < HP * (KC / V); idx += THREADS) {
    const int p = idx / (KC / V), v = idx % (KC / V);
    const long long gh = t.h0 - 1 + p / (TW + 2), gw = t.w0 - 1 + p % (TW + 2);
    const int c = k0 + v * V;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const T* src = x + ((t.n * H + gh) * W + gw) * Cin + c;
    T* dst = halo + p * ld + v * V;
    if (vec) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (inside && c < Cin) val = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = (inside && c + e < Cin) ? src[e] : T(0.f);
    }
  }
}

// Stage W[tap, k0 + k, n0 + j] for the nine taps at ws[(tap * KC + k) * ld + j].
template <int KC, int NC, typename T>
__device__ __forceinline__ void load_weights(const T* __restrict__ w, T* ws, int ld, int Cin,
                                             int Cout, int k0, int n0, bool vec) {
  constexpr int V = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < 9 * KC * (NC / V); idx += THREADS) {
    const int row = idx / (NC / V), v = idx % (NC / V);  // row = tap * KC + k
    const int tap = row / KC, k = row % KC;
    const int gk = k0 + k, gn = n0 + v * V;
    const T* src = w + ((long long)tap * Cin + gk) * Cout + gn;
    T* dst = ws + row * ld + v * V;
    if (vec) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gk < Cin && gn < Cout) val = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = (gk < Cin && gn + e < Cout) ? src[e] : T(0.f);
    }
  }
}

// bf16 on the tensor cores. 8 warps as 4 (pixels) x 2 (channels); a warp
// owns MFW 16-pixel fragments x 4 16-channel fragments of the tile.
template <int TH, int TW>
__global__ void __launch_bounds__(THREADS)
conv3x3_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
             int H, int W, int Cin, int Cout, bool vec) {
  static_assert(TW % 16 == 0 && (TH * TW / 16) % 4 == 0, "tile must split into 4 x 16-pixel rows");
  constexpr int HP = (TH + 2) * (TW + 2);
  constexpr int SEGS = TW / 16;       // 16-pixel fragments in a tile row
  constexpr int MFW = TH * SEGS / 4;  // pixel fragments a warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);           // HP x LDA
  bf16* ws = halo + HP * LDA;                            // 9 * BK x LDB
  float* scratch = reinterpret_cast<float*>(ws + 9 * BK * LDB);  // 8 warps x 16 x LDC

  const Tile t = tile_of<TH, TW>(blockIdx.x, H, W);
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MFW][4];
#pragma unroll
  for (int i = 0; i < MFW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    load_halo<TH, TW, BK>(x, halo, LDA, t, H, W, Cin, k0, vec);
    load_weights<BK, BN>(w, ws, LDB, Cin, Cout, k0, n0, vec);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], ws + (tap * BK + kk) * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < MFW; ++i) {
          const int f = wm * MFW + i, r = f / SEGS, s = f % SEGS;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, halo + ((r + di) * (TW + 2) + s * 16 + dj) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's scratch, 8 channels a lane
  float* sc = scratch + warp * 16 * LDC;
  const int px = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < MFW; ++i) {
    const int f = wm * MFW + i, r = f / SEGS, s = f % SEGS;
    const long long gh = t.h0 + r, gw = t.w0 + s * 16 + px;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], LDC, wmma::mem_row_major);
      __syncwarp();
      const int gn = n0 + wn * 64 + j * 16 + c8;
      if (gh < H && gw < W && gn < Cout) {
        bf16* dst = y + ((t.n * H + gh) * W + gw) * Cout + gn;
        const float* v = sc + px * LDC + c8;
        if (vec) {
          __align__(16) bf16 out[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(v[e]);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
        } else {
          for (int e = 0; e < 8 && gn + e < Cout; ++e) dst[e] = __float2bfloat16(v[e]);
        }
      }
      __syncwarp();
    }
  }
}

// float32, SIMT. 16 channel groups of 4 x 16 pixel groups of PPT pixels.
template <int TH, int TW>
__global__ void __launch_bounds__(THREADS)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
            int H, int W, int Cin, int Cout, bool vec) {
  constexpr int HP = (TH + 2) * (TW + 2);
  constexpr int PPT = TH * TW / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);  // HP x BKF
  float* ws = halo + HP * BKF;                    // 9 * BKF x BNF

  const Tile t = tile_of<TH, TW>(blockIdx.x, H, W);
  const int n0 = blockIdx.y * BNF;
  const int tn = threadIdx.x % 16, tp = threadIdx.x / 16;
  float acc[PPT][4];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BKF) {
    load_halo<TH, TW, BKF>(x, halo, BKF, t, H, W, Cin, k0, vec);
    load_weights<BKF, BNF>(w, ws, BNF, Cin, Cout, k0, n0, vec);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
      for (int k = 0; k < BKF; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(ws + (tap * BKF + k) * BNF + tn * 4);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = tp * PPT + i, r = p / TW, c = p % TW;
          const float a = halo[((r + di) * (TW + 2) + c + dj) * BKF + k];
          acc[i][0] += a * b.x;
          acc[i][1] += a * b.y;
          acc[i][2] += a * b.z;
          acc[i][3] += a * b.w;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = tp * PPT + i;
    const long long gh = t.h0 + p / TW, gw = t.w0 + p % TW;
    if (gh >= H || gw >= W) continue;
    float* dst = y + ((t.n * H + gh) * W + gw) * Cout + n0 + tn * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tn * 4 + j < Cout) dst[j] = acc[i][j];
  }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, long long tiles, int bn, size_t smem, const void* x,
                   const void* w, void* y, long long N, long long H, long long W,
                   long long Cin, long long Cout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0 && (uintptr_t)y % 16 == 0;
  dim3 grid((unsigned)(N * tiles), (unsigned)((Cout + bn - 1) / bn));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          static_cast<T*>(y), (int)H, (int)W, (int)Cin,
                                          (int)Cout, vec);
  return cudaGetLastError();
}

template <int TH, int TW>
cudaError_t launch_tile(int dtype, const void* x, const void* w, void* y, long long N,
                        long long H, long long W, long long Cin, long long Cout,
                        cudaStream_t s) {
  constexpr size_t HP = (TH + 2) * (TW + 2);
  const long long tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (HP * BKF + 9 * BKF * BNF);
    return launch<float>(conv3x3_f32<TH, TW>, tiles, BNF, smem, x, w, y, N, H, W, Cin, Cout, s);
  }
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * (HP * LDA + 9 * BK * LDB) + sizeof(float) * 8 * 16 * LDC;
    return launch<bf16>(conv3x3_bf16<TH, TW>, tiles, BN, smem, x, w, y, N, H, W, Cin, Cout, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tile: 0 = 8 x 16, 1 = 16 x 16, 2 = 4 x 32
// output pixels a block. x (N, H, W, Cin), w (3, 3, Cin, Cout) and
// y (N, H, W, Cout), all contiguous.
extern "C" int dm_conv3x3(int dtype, int tile, const void* x, const void* w, void* y,
                          long long N, long long H, long long W, long long Cin, long long Cout,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return (int)launch_tile<8, 16>(dtype, x, w, y, N, H, W, Cin, Cout, s);
    case 1: return (int)launch_tile<16, 16>(dtype, x, w, y, N, H, W, Cin, Cout, s);
    case 2: return (int)launch_tile<4, 32>(dtype, x, w, y, N, H, W, Cin, Cout, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
