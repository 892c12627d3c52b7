// int8 x int8 -> int32 convolution with a per-output-channel rescale (K4)
// for Hopper, as an implicit GEMM.
//
// It replaces no Pallas kernel. The JAX package's int8 path (the frozen VAE
// and UNet under `int8_convs()`) runs its convs through XLA:
//   diffusion_model_project_tpu/ops/quant.py::int8_conv
//   (lax.conv_general_dilated(int8, int8, preferred_element_type=int32),
//    then (y * sw).astype(out_dtype))
// and PyTorch computes no int8 conv on the card (cuDNN's is not exposed;
// F.conv* on int8 tensors returns wrapped int8 sums). So the port computes
// it here:
//
//   y[n,o,z,p,q] = cast(float(sum_{kz,ky,kx,c} x[n, z*sd+kz-pd, p*sh+ky-ph,
//                                                 q*sw+kx-pw, c] * w[o,kz,ky,kx,c])
//                       * sw[o])
//
// x (N, D, H, W, Cp) int8 channels-last (2D is D = 1; Cp a multiple of 16,
// channels past Cin zero), w (Cout, kd, kh, kw, Cp) int8 with K contiguous,
// sw (Cout,) float32, y (N, Cout, Do, Ho, Wo) bf16 or float32 (the port's
// layout). A tap outside the input reads 0. The int32 sum is exact; then
// __int2float_rn(acc) * sw[o] in float32 and one rounding to the output
// type, so the kernel equals the wrapper's plain version bit for bit.
//
// Bound on the H100: operations / 1,979 TOPS (dense int8) or the bytes of
// x, w, sw and y / 3.35 TB/s, whichever is larger. The VAE's 3x3x3 convs
// at 128-512 channels do 2 x 27 x Cin operations per output element against
// Cin + 2 or 4 x Cout bytes: 1,700-3,500 operations a byte, so the tensor
// cores bound them (E2D and D3D 1.76e13 operations a 256^2 x 11 volume,
// 8.9 ms); the UNet's 3x3 convs at 64 channels and the 1x1x1 residual convs
// sit nearer the bytes.
//
// The design is the simple one, right first: one block of 8 warps computes a
// 128 x 128 tile of the GEMM M = N Do Ho Wo output voxels by N = Cout, over
// K = taps x Cp in 64-byte steps.
//   - Each thread brings two 16-byte rows of A and two of B into a 4-stage
//     ring in shared memory with cp.async; an A row is gathered at its own
//     tap (a 16-byte row never straddles two taps, as Cp is a multiple of 16)
//     and a tap outside the input is zero-filled with src-size 0, so x needs
//     no padded copy. The ring's rows are 80 bytes apart, so the fragment
//     reads below hit 32 distinct banks.
//   - Each warp owns a 64 x 32 sub-tile: 4 x 4 mma.sync m16n8k32 s8.s8.s32
//     a 32-byte k-step, its 64 int32 sums in registers.
//   - The epilogue rescales and writes each sum straight from registers
//     (8 consecutive voxels of one channel a store).
// This kernel reaches a fraction of the int8 peak: mma.sync is not the
// Hopper tensor cores' full rate (wgmma is), the fragments are 32-bit shared
// loads, and a Cout of 64 fills half a tile. wgmma with TMA is later work;
// for 8-bit operands wgmma has no transpose bit, so both operands must be
// K-major, which is why w is (Cout, taps, Cp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mainloop.cuh"

namespace {

constexpr int BM = 128;          // output voxels a tile
constexpr int BN = 128;          // output channels a tile
constexpr int BK = 64;           // bytes of K a stage
constexpr int ROW = BK + 16;     // bytes between rows in shared memory
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * ROW;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 81,920
static_assert(BM * BK / 16 == 2 * THREADS && BN * BK / 16 == 2 * THREADS,
              "each thread loads two 16-byte rows of A and two of B a stage");

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* sw;
  void* y;
  int D, H, W, Cp;
  int Cout;
  int kd, kh, kw;
  int sd, sh, sww;
  int pd, ph, pw;
  int Do, Ho, Wo;
  int M;  // N Do Ho Wo
  int K;  // kd kh kw Cp
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  const int bytes = full ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_out(float* y, long long i, float v) { y[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, long long i, float v) {
  y[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS) int8_conv_mma(const ConvArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // ---- this thread's two A rows (output voxels) and two B rows (channels)
  const int gran = tid & 3;  // which 16-byte column of the 64-byte stage
  long long xbase[2];
  int iz0[2], iy0[2], ix0[2];
  bool mvalid[2];
  const int8_t* wrow[2];
  bool nvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 2) + 64 * i;
    const int m = m0 + r;
    mvalid[i] = m < a.M;
    const int mm = mvalid[i] ? m : 0;
    const int q = mm % a.Wo;
    int t = mm / a.Wo;
    const int p = t % a.Ho;
    t /= a.Ho;
    const int z = t % a.Do;
    const int n = t / a.Do;
    xbase[i] = (long long)n * a.D * a.H * a.W * a.Cp;
    iz0[i] = z * a.sd - a.pd;
    iy0[i] = p * a.sh - a.ph;
    ix0[i] = q * a.sww - a.pw;
    const int o = n0 + r;
    nvalid[i] = o < a.Cout;
    wrow[i] = a.w + (long long)(nvalid[i] ? o : 0) * a.K;
  }
  const uint32_t smem_base = dm_sm90::smem_u32(smem);

  auto load_stage = [&](int stage, int kc) {
    const int k = kc * BK + gran * 16;
    const bool kvalid = k < a.K;
    const int kk = kvalid ? k : 0;
    const int tap = kk / a.Cp;
    const int c = kk - tap * a.Cp;
    const int kz = tap / (a.kh * a.kw);
    const int rem = tap - kz * a.kh * a.kw;
    const int ky = rem / a.kw;
    const int kx = rem - ky * a.kw;
    const uint32_t sa = smem_base + stage * STAGE_BYTES;
    const uint32_t sb = sa + BM * ROW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int iz = iz0[i] + kz, iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool in = kvalid && mvalid[i] && iz >= 0 && iz < a.D && iy >= 0 && iy < a.H &&
                      ix >= 0 && ix < a.W;
      const int8_t* src =
          in ? a.x + xbase[i] + (((long long)iz * a.H + iy) * a.W + ix) * a.Cp + c : a.x;
      cp_async16(sa + r * ROW + gran * 16, src, in);
      const bool win = kvalid && nvalid[i];
      cp_async16(sb + r * ROW + gran * 16, win ? wrow[i] + k : a.w, win);
    }
  };

  // ---- the warp's 64 x 32 sub-tile
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, tq = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int KT = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < KT; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kc landed for every thread; stage kc-1 is free
    const int next = kc + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_async_commit();

    const uint8_t* As = smem + (kc % STAGES) * STAGE_BYTES;
    const uint8_t* Bs = As + BM * ROW;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = As + (wm + i * 16 + g) * ROW + ks + 4 * tq;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * ROW);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * ROW + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = Bs + (wn + j * 8 + g) * ROW + ks + 4 * tq;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: rescale, one rounding, (N, Cout, Do, Ho, Wo)
  OutT* y = static_cast<OutT*>(a.y);
  const long long S = (long long)a.Do * a.Ho * a.Wo;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= a.M) continue;
      const long long n = m / S;
      const long long base = n * a.Cout * S + (m - n * S);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + wn + j * 8 + 2 * tq + e;
          if (o < a.Cout)
            store_out(y, base + (long long)o * S, __int2float_rn(acc[i][j][2 * h + e]) * a.sw[o]);
        }
    }
}

template <typename OutT>
cudaError_t launch(const ConvArgs& a, cudaStream_t s) {
  auto kernel = int8_conv_mma<OutT>;
  static bool ready[dm_sm90::MAX_DEVICES] = {};
  cudaError_t err = dm_sm90::allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN));
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out: 0 = float32, 1 = bfloat16. x (N, D, H, W, Cp) and w (Cout, kd, kh, kw,
// Cp) int8, contiguous and 16-byte aligned, Cp a multiple of 16; sw (Cout,)
// float32; y (N, Cout, Do, Ho, Wo). pd, ph, pw: the low padding of each
// dimension; the high padding is implied by Do, Ho, Wo.
extern "C" int dm_int8_conv(int out, const void* x, const void* w, const void* sw, void* y,
                            int N, int D, int H, int W, int Cp, int Cout, int kd, int kh, int kw,
                            int sd, int sh, int sww, int pd, int ph, int pw, int Do, int Ho,
                            int Wo, void* stream) {
  ConvArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(sw), y, D, H, W, Cp, Cout, kd, kh, kw, sd, sh, sww,
             pd, ph, pw, Do, Ho, Wo, N * Do * Ho * Wo, kd * kh * kw * Cp};
  if (Cp % 16 || a.M <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out == 0) return (int)launch<float>(a, s);
  if (out == 1) return (int)launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
