// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tile loads (2-D to 4-D) and stores, 1-D bulk loads, a ring of shared-memory
// stages, wgmma shared-memory descriptors for 128-byte swizzled tiles and
// the wgmma instructions themselves, cluster barriers and asynchronous
// stores into a peer block's shared memory, all as inline PTX (no CuTe, so a source builds
// in seconds), and the host's tensor-map encoding and shared-memory cap.
//
// Layout contract. Every operand tile in shared memory is made of TMA boxes
// of 64 bf16 columns (128 bytes) by R rows, loaded with 128-byte swizzle, one
// box every R * 128 bytes, each box 1024-byte aligned. Such a box is what
// wgmma reads through a descriptor with layout type B128:
//   - K-major (K contiguous, the wgmma default for A and B): rows are M or N,
//     the 64 columns one K tile; the k16 step kk starts 32 * kk bytes in, and
//     8-row groups lie 1024 bytes apart (SBO).
//   - MN-major (N contiguous; B only, "transpose" bit set): rows are K, the
//     64 columns are N; the k16 step kk starts 2048 * kk bytes in (16 rows),
//     8-row groups of K lie 1024 bytes apart (SBO) and 64-column atoms of N
//     lie one box apart (LBO = R * 128).
//
// Pipeline contract. One producer thread fills the stages of a Ring with TMA
// and signals `full[s]` with the bytes it expects; consumer warpgroups wait
// on `full[s]`, multiply, and every consumer thread arrives on `empty[s]`
// when its wgmma no longer reads the stage. Both sides walk the stages in
// the same order and flip their phase bit when the ring wraps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dm_sm90 {

// ------------------------------------------------------------------ smem

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// the dynamic shared memory a launch asks for on top of its tiles, for align_1024
constexpr int kAlignSlack = 1024;

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will deliver
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's current phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// stage index and phase bit of one side of a ring of `stages` buffers
struct Ring {
  int stages, stage = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// x, y, z, w: innermost dimension first; coordinates may be negative or run
// past the tensor, and those elements arrive as zeros (the bytes still count
// toward the barrier's expected transaction)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// one contiguous global -> shared copy of `bytes` (a multiple of 16, at most
// 2^20 - 1 a barrier phase), `src` and `dst` 16-byte aligned; the bytes count
// toward `bar`'s expected transaction
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global; elements past the tensor's edge are not written. The
// store joins the thread's open bulk group: bulk_commit() closes it.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// returns once at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's plain shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------- descriptors

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);  // layout type B128
}

// K-major box, k16 step kk: desc_kmajor(box + 32 * kk)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return make_desc(addr, 16, 1024); }

// MN-major boxes of `box_bytes` each, k16 step kk: desc_mnmajor(box + 2048 * kk, box_bytes)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t box_bytes) {
  return make_desc(addr, box_bytes, 1024);
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma that owns the registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DM_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory; TB = 1
// when B is MN-major. Accumulator of thread (warp w, lane): rows
// 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1): d[4 j .. 4 j + 3].
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : DM_F8(d, 0), DM_F8(d, 8), DM_F8(d, 16), DM_F8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], as above with j up to 15
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : DM_F8(d, 0), DM_F8(d, 8), DM_F8(d, 16), DM_F8(d, 24), DM_F8(d, 32), DM_F8(d, 40),
        DM_F8(d, 48), DM_F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64] with A from registers: thread
// (warp w, lane) holds bf16 pairs of rows 16 w + g, 16 w + g + 8 (g = lane / 4)
// at columns 2 (lane % 4) and 8 + 2 (lane % 4): a[0] = (g, c), a[1] = (g + 8, c),
// a[2] = (g, c + 8), a[3] = (g + 8, c + 8), the lower column in the low half.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : DM_F8(d, 0), DM_F8(d, 8), DM_F8(d, 16), DM_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

#undef DM_F8

// One 64-wide K tile of a GEMM: `acc` (+)= A[64 x 64] . B[64 x N], A a
// K-major box at `a`, B at `b` K-major (TB = 0, one box of N rows) or
// MN-major (TB = 1, N / 64 boxes of 64 K rows). Issues 4 wgmmas, commits
// them as one group and returns without waiting.
template <int TB, int NACC>
__device__ __forceinline__ void mma_k64(float (&acc)[NACC], uint32_t a, uint32_t b, bool first) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = TB ? desc_mnmajor(b + 2048 * kk, 64 * 128) : desc_kmajor(b + 32 * kk);
    wgmma_ss<TB>(acc, desc_kmajor(a + 32 * kk), db, (first && kk == 0) ? 0 : 1);
  }
  wgmma_commit();
  fence_regs(acc);
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -------------------------------------------------------------- clusters

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split: every thread of every block of the cluster
// arrives, and later waits for all the others' arrivals. This arrival orders
// nothing: it says "this block has started (and fenced its mbarriers' init)",
// which a block must know of its peers before it touches their shared
// memory. Both are .aligned: every thread of a warp executes them together.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores v at `local` in the shared memory of the cluster's block `rank`
// (16-byte aligned); the 16 bytes count toward the transaction of that
// block's mbarrier at `bar` (the same offset as this block's).
__device__ __forceinline__ void st_async_peer(void* local, uint64_t* bar, uint32_t rank,
                                              float4 v) {
  uint32_t remote, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

// ------------------------------------------------------------------ host

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int MAX_DEVICES = 64;

// Lets `kernel` use all of SMEM_LIMIT, once per device: the attribute is a
// cap, and setting it on every launch costs host time on a host-bound path.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  done[dev] = err == cudaSuccess;
  return err;
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, `strides` in bytes for
// dims 1..rank-1), boxes of `box` elements, 128-byte swizzle; reads past the
// tensor's edge fill the box with zeros.
inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int rank,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dm_sm90
