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
// contiguous. Taps outside the image read zero. bf16 in, float32 sums, one
// rounding to bf16 at the end; float32 runs SIMT float32 products (no TF32).
//
// Bound on the H100: the VAE's stages (44 images at 256^2 x 128, 128^2 x 256,
// 64^2 x 512 channels) each do 0.85 TFLOP against 0.37-1.48 GB of x + y + W,
// 575-2,300 operations a byte, far above the card's ~295: the bf16 tensor
// cores bound them (0.86 ms a stage at 989 TFLOP/s).
//
// What limits a tile is the traffic from L2 into shared memory. The GEMM is
// M = output pixels, N = Cout, K = 9 * Cin; a block's tile is BM = TH x TW
// pixels by BN = 128 channels. A plain implicit GEMM loads a BM x 64 A tile
// for each of the nine taps: BM BN / (BM + BN) operations a byte, 64 at
// 128 x 128, so 13.3 GB a stage from L2 (15 TB/s at the bound). Here the A
// operand is the halo itself: per 64-channel chunk and column shift dj, one
// TMA box of (TH+2) x TW pixels x 64 channels serves the three row shifts
// di, as tap (di, dj) is the same box read from row di * TW on (a multiple
// of 8 rows, 1024 bytes, when TW is a multiple of 8, so the B128 K-major
// descriptor reads it in place). Per chunk a tile then moves 3 halo boxes
// and 9 weight slices, 9 / (9 / BM + 3 (TH+2) / (TH BN)) operations a byte:
// 146 at 16 x 16 (5.8 GB a stage), 150 at 32 x 8, 90 at 8 x 16, where BN =
// 128 columns of float32 sums take 64 registers a thread for each 64 rows.
//
// conv3x3_sm90, bf16:
//   - a persistent grid of one block per SM walks the tiles (pixel tile,
//     then its Cout blocks, so blocks that share a halo run together);
//   - one producer thread keeps two rings full with TMA (STAGES_A = 3 and
//     STAGES_B = 5 deep, compiled in): halo boxes (4-D map over x, 128-byte
//     swizzle; coordinates at -1 or past the edge read zeros, so there is no
//     padded copy of x and no mask) and 64 Cin x 128 Cout weight slices (3-D
//     map over W as (Cout, Cin, tap), so a Cin tail past the last chunk reads
//     zeros and never the next tap);
//   - two consumer warpgroups each own BM / 2 pixels (128 float32
//     accumulators a thread at 16 x 16) and run wgmma m64n128k16 with A
//     K-major from the halo box and B MN-major (the transpose bit) from the
//     weight slice; each releases a slice when its products are done, a
//     halo box after its third row shift;
//   - the epilogue rounds the sums once to bf16 into a 128-byte swizzled
//     buffer and leaves by TMA store (4-D map over y, which writes nothing
//     past H, W or Cout); the store runs while the next tile's products do.
// The weights are not kept in shared memory across tiles: W is 295 KB at
// 128 channels and 4.7 MB at 512, past the 227 KB a block may use.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mainloop.cuh"

namespace {

using namespace dm_sm90;

constexpr int THREADS = 256;
// float32: BNF output channels a block, BKF input channels a chunk
constexpr int BNF = 64, BKF = 16;

// ------------------------------------------------------------ bf16, sm_90

constexpr int BN = 128;                   // output channels a tile
constexpr int B_BYTES = 2 * 64 * 64 * 2;  // a 64 Cin x 128 Cout weight slice: two boxes
constexpr int NWG = 2;                    // consumer warpgroups
constexpr int STAGES_A = 3;               // halo boxes in flight
constexpr int STAGES_B = 5;               // weight slices in flight (the most that fit beside
                                          // a 256-pixel tile's halo ring and epilogue)

template <int TH, int TW>
struct ConvTile {
  static_assert(TW % 8 == 0, "row shifts must move whole 1024-byte swizzle atoms");
  static_assert((TH * TW) % 128 == 0 && TH % 2 == 0, "each warpgroup owns whole rows of m64");
  static_assert(TW <= 256 && TH + 2 <= 256, "TMA boxes are at most 256 a side");
  static constexpr int BM = TH * TW;
  static constexpr int MB = BM / 64 / NWG;              // m64 blocks a warpgroup
  static constexpr int A_BYTES = (TH + 2) * TW * 128;   // halo box of 64 channels
  static constexpr int EPI_BYTES = BM / NWG * 128;      // a warpgroup's pixels x 64 channels
};

// must equal ops/cuda/conv3x3.py::conv_smem
constexpr int conv_smem(int th, int tw) {
  return kAlignSlack + STAGES_A * (th + 2) * tw * 128 + STAGES_B * B_BYTES + th * tw * 128 +
         16 * (STAGES_A + STAGES_B);
}

// Static tile order: pixel tiles raster by (n, row, column), Cout blocks fastest.
struct TileIndex {
  int n, h0, w0, n0;
};

__device__ __forceinline__ TileIndex tile_at(int t, int tiles_w, int tiles_h, int ncb, int TH,
                                             int TW) {
  TileIndex r;
  r.n0 = (t % ncb) * BN;
  const int p = t / ncb;
  r.w0 = (p % tiles_w) * TW;
  r.h0 = (p / tiles_w % tiles_h) * TH;
  r.n = p / (tiles_w * tiles_h);
  return r;
}

// grid: persistent blocks; threads: NWG consumer warpgroups, then one producer warp.
template <int TH, int TW>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
conv3x3_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             const __grid_constant__ CUtensorMap tm_y, int H, int W, int Cin, int Cout,
             int tiles) {
  using C = ConvTile<TH, TW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_ring = align_1024(smem_raw);
  uint8_t* b_ring = a_ring + STAGES_A * C::A_BYTES;
  uint8_t* epi = b_ring + STAGES_B * B_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(epi + NWG * C::EPI_BYTES);
  uint64_t* a_empty = a_full + STAGES_A;
  uint64_t* b_full = a_empty + STAGES_A;
  uint64_t* b_empty = b_full + STAGES_B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ncb = (Cout + BN - 1) / BN, nk = (Cin + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_A; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], NWG * 128);
    }
    for (int s = 0; s < STAGES_B; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer
    if (lane == 0) {
      Ring ra(STAGES_A), rb(STAGES_B);
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileIndex ti = tile_at(t, tiles_w, tiles_h, ncb, TH, TW);
        for (int kc = 0; kc < nk; ++kc)
          for (int dj = 0; dj < 3; ++dj) {
            mbar_wait(&a_empty[ra.stage], ra.phase ^ 1u);
            mbar_expect_tx(&a_full[ra.stage], C::A_BYTES);
            tma_load_4d(a_ring + ra.stage * C::A_BYTES, &tm_x, &a_full[ra.stage], 64 * kc,
                        ti.w0 + dj - 1, ti.h0 - 1, ti.n);
            ra.advance();
            for (int di = 0; di < 3; ++di) {
              mbar_wait(&b_empty[rb.stage], rb.phase ^ 1u);
              uint8_t* st = b_ring + rb.stage * B_BYTES;
              mbar_expect_tx(&b_full[rb.stage], B_BYTES);
              tma_load_3d(st, &tm_w, &b_full[rb.stage], ti.n0, 64 * kc, 3 * di + dj);
              tma_load_3d(st + B_BYTES / 2, &tm_w, &b_full[rb.stage], ti.n0 + 64, 64 * kc,
                          3 * di + dj);
              rb.advance();
            }
          }
      }
    }
    return;
  }

  // consumer warpgroup wg: pixels BM / 2 * wg .. of the tile, all BN channels
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int wi = t / 32, g = (t % 32) / 4, q = t % 4;
  uint8_t* buf = epi + wg * C::EPI_BYTES;
  float acc[C::MB][64];
#pragma unroll
  for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mb][i] = 0.f;
  Ring ra(STAGES_A), rb(STAGES_B);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileIndex ti = tile_at(tile, tiles_w, tiles_h, ncb, TH, TW);
    int a_rel = -1, b_rel = -1;  // stages to release once the products in flight are done
    for (int kc = 0; kc < nk; ++kc)
      for (int dj = 0; dj < 3; ++dj) {
        mbar_wait(&a_full[ra.stage], ra.phase);
        const uint32_t a0 = smem_u32(a_ring + ra.stage * C::A_BYTES) + wg * C::MB * 64 * 128;
        for (int di = 0; di < 3; ++di) {
          mbar_wait(&b_full[rb.stage], rb.phase);
          const uint32_t b = smem_u32(b_ring + rb.stage * B_BYTES);
          const bool first = kc == 0 && dj == 0 && di == 0;
#pragma unroll
          for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = desc_mnmajor(b + 2048 * kk, B_BYTES / 2);
#pragma unroll
            for (int mb = 0; mb < C::MB; ++mb)
              wgmma_ss<1>(acc[mb], desc_kmajor(a0 + (mb * 64 + di * TW) * 128 + 32 * kk), db,
                          (first && kk == 0) ? 0 : 1);
          }
          wgmma_commit();
#pragma unroll
          for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);
          wgmma_wait<1>();  // the previous step's products are done: release its stages
          if (b_rel >= 0) mbar_arrive(&b_empty[b_rel]);
          if (a_rel >= 0) mbar_arrive(&a_empty[a_rel]);
          a_rel = di == 2 ? ra.stage : -1;
          b_rel = rb.stage;
          rb.advance();
        }
        ra.advance();
      }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb) fence_regs(acc[mb]);
    mbar_arrive(&b_empty[b_rel]);
    mbar_arrive(&a_empty[a_rel]);

    // epilogue: 64 channels at a time, one rounding to bf16 into a 128-byte
    // swizzled box (chunk k of pixel row p at chunk k ^ (p % 8)), then TMA store
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (ti.n0 + 64 * half >= Cout) break;
      if (t == 0) bulk_wait_read<0>();  // the last store from the box is done reading it
      named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * half + jj;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = mb * 64 + 16 * wi + g + 8 * e;
            *reinterpret_cast<__nv_bfloat162*>(buf + p * 128 + ((jj ^ (p & 7)) << 4) + 4 * q) =
                __floats2bfloat162_rn(acc[mb][4 * j + 2 * e], acc[mb][4 * j + 2 * e + 1]);
          }
        }
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      if (t == 0) {
        tma_store_4d(&tm_y, buf, ti.n0 + 64 * half, ti.w0, ti.h0 + wg * (TH / 2), ti.n);
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait<0>();
}

template <int TH, int TW>
cudaError_t launch_sm90(const void* x, const void* w, void* y, long long N, long long H,
                        long long W, long long Cin, long long Cout, int smem, int grid,
                        cudaStream_t s) {
  static_assert(conv_smem(TH, TW) <= SMEM_LIMIT, "the rings and the epilogue must fit");
  if (grid < 1 || smem < conv_smem(TH, TW) || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const long long tiles = N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap tx, tw, ty;
  const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t x_strides[3] = {(cuuint64_t)(Cin * 2), (cuuint64_t)(W * Cin * 2),
                                   (cuuint64_t)(H * W * Cin * 2)};
  const cuuint32_t x_box[4] = {64, TW, TH + 2, 1};
  cudaError_t err = make_map_bf16(&tx, x, 4, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return err;
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t w_strides[2] = {(cuuint64_t)(Cout * 2), (cuuint64_t)(Cin * Cout * 2)};
  const cuuint32_t w_box[3] = {64, 64, 1};
  err = make_map_bf16(&tw, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return err;
  const cuuint64_t y_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t y_strides[3] = {(cuuint64_t)(Cout * 2), (cuuint64_t)(W * Cout * 2),
                                   (cuuint64_t)(H * W * Cout * 2)};
  const cuuint32_t y_box[4] = {64, TW, TH / 2, 1};
  err = make_map_bf16(&ty, y, 4, y_dims, y_strides, y_box);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_sm90<TH, TW>;
  static bool ready[MAX_DEVICES] = {};
  err = allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NWG * 128 + 32, smem, s>>>(tx, tw, ty, (int)H, (int)W, (int)Cin, (int)Cout,
                                            (int)tiles);
  return cudaGetLastError();
}

// --------------------------------------------------- float32 (SIMT, kept as is)

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

template <int TH, int TW>
cudaError_t launch_f32(const void* x, const void* w, void* y, long long N, long long H,
                       long long W, long long Cin, long long Cout, cudaStream_t s) {
  constexpr size_t HP = (TH + 2) * (TW + 2);
  constexpr size_t smem = sizeof(float) * (HP * BKF + 9 * BKF * BNF);
  auto kernel = conv3x3_f32<TH, TW>;
  static bool ready[MAX_DEVICES] = {};
  cudaError_t err = allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0 && (uintptr_t)y % 16 == 0;
  const long long tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid((unsigned)(N * tiles), (unsigned)((Cout + BNF - 1) / BNF));
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                     static_cast<float*>(y), (int)H, (int)W, (int)Cin, (int)Cout,
                                     vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tile: the wrapper's index into its
// TILES (bf16: 8 x 16, 16 x 16, 32 x 8 output pixels a block) or F32_TILES
// (float32: 8 x 16, 16 x 16, 4 x 32). x (N, H, W, Cin), w (3, 3, Cin, Cout)
// and y (N, H, W, Cout), all contiguous. bf16: `smem` dynamic shared memory
// bytes (checked against the kernel's layout) and `grid` persistent blocks,
// as the wrapper planned them; float32 ignores both.
extern "C" int dm_conv3x3(int dtype, int tile, const void* x, const void* w, void* y,
                          long long N, long long H, long long W, long long Cin, long long Cout,
                          int smem, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) switch (tile) {
      case 0: return (int)launch_f32<8, 16>(x, w, y, N, H, W, Cin, Cout, s);
      case 1: return (int)launch_f32<16, 16>(x, w, y, N, H, W, Cin, Cout, s);
      case 2: return (int)launch_f32<4, 32>(x, w, y, N, H, W, Cin, Cout, s);
    }
  if (dtype == 1) switch (tile) {
      case 0: return (int)launch_sm90<8, 16>(x, w, y, N, H, W, Cin, Cout, smem, grid, s);
      case 1: return (int)launch_sm90<16, 16>(x, w, y, N, H, W, Cin, Cout, smem, grid, s);
      case 2: return (int)launch_sm90<32, 8>(x, w, y, N, H, W, Cin, Cout, smem, grid, s);
    }
  return (int)cudaErrorInvalidValue;
}
