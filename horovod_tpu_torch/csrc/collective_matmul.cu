// Collective matmul for Hopper (sm_90a): the chunk products of the
// all-gather-matmul ring (B3) and of the matmul-reduce-scatter ring (B4).
//
// Replaces the TPU kernels horovod_tpu/ops/collective_matmul.py:_ag_matmul_tpu
// (B3) and :_mrs_tpu (B4). Those kernels move the chunks between chips with
// remote copies from inside the kernel; on Hopper the transfers are NCCL calls
// outside the kernel (horovod_tpu_torch/ops/collective_matmul.py posts both
// ring directions of a hop in one batch_isend_irecv, on the process group's
// stream), and the kernels here do the work of each hop on the compute
// stream, ordered after the transfers by CUDA events:
//
//   B3, chunk product:   out[b, row0 + i, :] = a[b, i, :] @ w, for the chunk
//                        that arrived from source rank j (row0 = j * Tc plus
//                        the sub-chunk offset), written in place into the
//                        gathered output of every batch row b, in a's dtype,
//                        summed in f32. The output's batch stride is an
//                        argument: token chunks sit at rows j * Tc of EVERY
//                        batch element, which a flattened [B * Tc, D] view
//                        would place wrongly.
//   B4, partial product: acc_out = acc_in + y[b, row0 + i, :] @ w with acc in
//                        f32 (the TPU kernel's f32 VMEM accumulator): the
//                        partial for one destination chunk added to the
//                        accumulator that arrived on the ring (acc_in may be
//                        null: the partial alone).
//   B4, epilogue:        out = (own + forward arrival) + backward arrival,
//                        cast to y's dtype.
//
// What bounds it on an H100. At GPT-2-small width on 4 cards (8192 tokens per
// replica, 2048 per rank) one call of B3 for q/k/v multiplies [8192, 768] by
// [768, 576]: 7.2 GFLOP, 7.3 us at the 989 TFLOP/s bf16 peak against 4.8 us
// of HBM traffic, so the products are bound by operations
// (tools/kernel_bounds.py gives each call's bound). B4 also writes an f32
// accumulator per launch and reads the arriving one, and its epilogue reads
// three: at MLP down ~71 MB a call, 21 us at 3.35 TB/s, above its 9.8 us
// operations bound. The link bounds the ring itself: the other ranks' chunks
// need 21 us (B3, bf16) and 42 us (B4, f32 partials) at NVLink's 450 GB/s.
//
// The design for bf16, the main path: gemm_tma_wgmma_kernel. A block computes
// a BM x BN output tile of one batch element (grid z is the batch).
// - One producer thread issues TMA loads (cp.async.bulk.tensor) into a ring
//   of STAGES shared-memory stages with the 128-byte swizzle, completion on an
//   mbarrier per stage: A's tile through a 3-D tensor map (k, row, batch) that
//   carries the chunk's batch stride (B3's own chunk is a strided view, B4
//   reads y[:, row:row + sc] at batch stride T * Fl), W's through a 2-D map
//   over [K, N] in boxes of 64 columns. TMA zero-fills rows past the chunk's
//   end and k past K, so ragged edges need no masks on the loads.
// - One consumer warpgroup per 64 rows runs wgmma.mma_async m64nBNk16 on the
//   stages, bf16 operands from shared memory, f32 accumulators in registers.
//   W is N-contiguous, MN-major for wgmma's B operand: it is read as it lies,
//   through the instruction's transpose bit for B (allowed for 16-bit types),
//   so no transposed copy of w is made. One k-tile of products stays in flight
//   (wgmma.wait_group 1); each consumer warp then releases the stage the
//   retired products read (an mbarrier arrive), which the producer refills.
// - The epilogue writes the accumulator fragments into an output tile in
//   shared memory (the same swizzle, conflict-free), and one thread stores it
//   with TMA through a 3-D map of the output that carries its batch stride
//   (B3: bf16 into the gathered output in place; B4: f32). TMA clips rows
//   past the chunk and columns past N. B4's arriving accumulator is loaded
//   into that tile by TMA at the start, overlapped with the products, and
//   each fragment is added to it: acc_in + partial, as the plain version.
//   (Stores straight from the fragments, 4 or 8 bytes a thread, made a 64 x
//   192 tile's launch at 2048 x 768 x 768 take 8.30 us on an H100 against
//   5.67 us staged and stored by TMA; tools/cm_tile_sweep.py.)
// - The tile (BM, BN, STAGES) is chosen by the caller from (K, N) alone
//   (ops/collective_matmul.py:tile_for, swept by tools/cm_tile_sweep.py);
//   HVT_CM_CONFIGS lists the tiles built. A k-tile is 64 bf16 values, one
//   128-byte swizzle row; k-tiles run in order, four k16 products each, and
//   there is no split-K. So every output element is computed the same way
//   whatever the chunk's row count or batch, and a chunk's rows are bitwise
//   the rows of the same product over the gathered input.
// - Tensor maps are encoded on the host per launch with
//   cuTensorMapEncodeTiled, fetched once through cudaGetDriverEntryPoint (no
//   -lcuda at link time), and passed as __grid_constant__ parameters.
//
// TMA needs 16-byte aligned base addresses and strides. Operands that are not
// (K or N not a multiple of 8, a view at an unaligned row offset) take the
// earlier kernels, chosen by the caller by shape before the launch
// (ops/collective_matmul.py:_tma_ok): gemm_wmma_kernel for bf16 (WMMA 16 x 16 x
// 16 fragments, 64 x 64 tiles, one k-tile of 32 in flight, masked edges), and
// gemm_fma_kernel for f32 (the parity runs, FMAs on the CUDA cores with a
// 4 x 4 register tile per thread). The WMMA kernel also lets chip_smoke.py
// time the earlier design beside this one, in turns, in one run. Both keep the
// k order fixed by K, so the bitwise property above holds for them too.
//
// C interface (bound with ctypes): pointers and the stream are void*, strides
// are in elements, every entry returns cudaGetLastError() after its launch.
// dtype: 0 = f32, 1 = bf16. A tile (bm, bn, stages) of (0, 0, 0) takes the
// earlier kernels.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

// The TMA/wgmma tiles built, X(BM, BN, STAGES); tools/cm_tile_sweep.py builds
// others by defining this in a header passed with -include.
#ifndef HVT_CM_CONFIGS
#define HVT_CM_CONFIGS X(64, 128, 4) X(64, 192, 4)
#endif

namespace {

// --- the earlier kernels: FMA (f32) and WMMA (bf16 operands TMA cannot take) ---

constexpr int kTile = 64;         // output tile: 64 rows x 64 columns
constexpr int kFmaBK = 16;        // k-tile of the FMA kernel
constexpr int kFmaThreads = 256;  // a 16 x 16 grid, each thread 4 x 4 outputs
constexpr int kWmmaBK = 32;       // k-tile of the WMMA kernel
constexpr int kWmmaThreads = 128; // four warps, each 32 x 32 of the tile
constexpr int kALd = kWmmaBK + 8; // padded leading dims (multiples of 8 halves)
constexpr int kBLd = kTile + 8;
constexpr int kCLd = kTile + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Write one output element: the chunk product (cast to T) or the partial
// product added to the arriving f32 accumulator.
template <typename T, bool kPartial>
__device__ __forceinline__ void store_out(void* c, const float* acc_in, long long bz,
                                          long long c_bstride, long long off, float v) {
  if (kPartial) {
    const long long at = bz * c_bstride + off;
    static_cast<float*>(c)[at] = (acc_in != nullptr ? acc_in[at] : 0.f) + v;
  } else {
    static_cast<T*>(c)[bz * c_bstride + off] = from_f32<T>(v);
  }
}

// C[b] = A[b] @ W on the CUDA cores. A: rows x K with row stride K and batch
// stride a_bstride; W: K x N contiguous; C: rows x N with batch stride
// c_bstride. Grid (N tiles, row tiles, batch).
template <typename T, bool kPartial>
__global__ void __launch_bounds__(kFmaThreads)
gemm_fma_kernel(const T* __restrict__ a, const T* __restrict__ w,
                const float* __restrict__ acc_in, void* __restrict__ c, int rows, int K, int N,
                long long a_bstride, long long c_bstride) {
  __shared__ __align__(16) float As[kFmaBK][kTile + 4];  // transposed: As[k][row]
  __shared__ __align__(16) float Ws[kFmaBK][kTile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const long long bz = blockIdx.z;
  const T* ab = a + bz * a_bstride;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int e = tid; e < kTile * kFmaBK; e += kFmaThreads) {
      const int r = e / kFmaBK, kk = e % kFmaBK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < rows && gk < K) ? to_f32(ab[(long long)gr * K + gk]) : 0.f;
    }
    for (int e = tid; e < kFmaBK * kTile; e += kFmaThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int gk = k0 + kk, gc = col0 + cc;
      Ws[kk][cc] = (gk < K && gc < N) ? to_f32(w[(long long)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gr < rows && gc < N)
        store_out<T, kPartial>(c, acc_in, bz, c_bstride, (long long)gr * N + gc, acc[i][j]);
    }
  }
}

// The same product in bf16 on the tensor cores (WMMA, f32 sums), for the
// operands TMA cannot take. ``vec``: the shapes and pointers allow 16-byte
// loads of 8 bf16 values.
template <bool kPartial>
__global__ void __launch_bounds__(kWmmaThreads)
gemm_wmma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ acc_in, void* __restrict__ c, int rows, int K, int N,
                 long long a_bstride, long long c_bstride, int vec) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[kTile * kALd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kWmmaBK * kBLd];
  __shared__ __align__(128) float Cs[kTile * kCLd];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const long long bz = blockIdx.z;
  const __nv_bfloat16* ab = a + bz * a_bstride;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kWmmaBK) {
    // A tile, 64 rows x 32 k, in groups of 8 along k.
    for (int g = tid; g < kTile * kWmmaBK / 8; g += kWmmaThreads) {
      const int r = g / (kWmmaBK / 8), kk = (g % (kWmmaBK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kk;
      __nv_bfloat16* dst = &As[r * kALd + kk];
      if (vec && gr < rows && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(ab + (long long)gr * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < rows && gk + e < K) ? ab[(long long)gr * K + gk + e] : zero;
      }
    }
    // W tile, 32 k x 64 columns, in groups of 8 along the columns.
    for (int g = tid; g < kWmmaBK * kTile / 8; g += kWmmaThreads) {
      const int kk = g / (kTile / 8), cc = (g % (kTile / 8)) * 8;
      const int gk = k0 + kk, gc = col0 + cc;
      __nv_bfloat16* dst = &Bs[kk * kBLd + cc];
      if (vec && gk < K && gc + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(w + (long long)gk * N + gc);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gc + e < N) ? w[(long long)gk * N + gc + e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWmmaBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 32 + i * 16) * kALd + kk], kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * kBLd + wn * 32 + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * kCLd + wn * 32 + j * 16], acc[i][j], kCLd,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTile * kTile; e += kWmmaThreads) {
    const int r = e / kTile, cc = e % kTile;
    const int gr = row0 + r, gc = col0 + cc;
    if (gr < rows && gc < N)
      store_out<__nv_bfloat16, kPartial>(c, acc_in, bz, c_bstride, (long long)gr * N + gc,
                                         Cs[r * kCLd + cc]);
  }
}

// --- the TMA + wgmma kernel ------------------------------------------------

constexpr int kBK = 64;             // k-tile: 64 bf16 values, one 128-byte swizzle row
constexpr int kWgThreads = 128;     // a warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma matrix descriptor of a tile in shared memory laid out by TMA's
// 128-byte swizzle: start address, leading and stride byte offsets (16-byte
// units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

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

// Keep the compiler from moving accumulator accesses across the asynchronous
// products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B from shared memory;
// kTransB = 1 reads B MN-major. One overload per N (the size of d, N / 2).
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int BM, int BN, int STAGES, bool kPartial>
struct TmaTile {
  static constexpr int kConsumers = BM / 64;                  // warpgroups, 64 rows each
  static constexpr int kThreads = (kConsumers + 1) * kWgThreads;  // + the producer's
  static constexpr int kABytes = BM * kBK * 2;                // BM rows of 128 bytes
  static constexpr int kWBytes = kBK * BN * 2;                // BN / 64 boxes of kBK rows
  static constexpr int kStageBytes = kABytes + kWBytes;
  // The output tile staged for its TMA store, per consumer warpgroup: 64 rows
  // in boxes of 128-byte rows (64 bf16 or 32 f32 columns), 8 KB a box.
  static constexpr int kOutElem = kPartial ? 4 : 2;
  static constexpr int kBoxCols = 128 / kOutElem;
  static constexpr int kOutBoxes = BN / kBoxCols;
  static constexpr int kOutBytes = 64 * BN * kOutElem;
  static constexpr int kOutOffset = STAGES * kStageBytes;
  static constexpr int kBarOffset = kOutOffset + kConsumers * kOutBytes;
  // The stages, the output tiles, the full and empty barriers and the
  // accumulator's, and slack to align the stages to 1024 bytes (the swizzle
  // pattern repeats every 8 rows of 128 bytes).
  static constexpr int kSmemBytes = kBarOffset + (2 * STAGES + 1) * 8 + 1024;
  static_assert(BM == 64 || BM == 128, "BM is one or two warpgroups of 64 rows");
  static_assert(BN % 64 == 0 && BN <= 256, "BN is whole 64-column boxes, at most 256");
  static_assert(kSmemBytes <= 232448, "the tile's stages and output exceed shared memory");
};

// The byte offset of element (row, col) of a 64-row tile staged in boxes of
// 128-byte rows under TMA's 128-byte swizzle: the 16-byte chunk index is
// XORed with the row's index within its 8-row group.
template <int kElem>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  constexpr int kCols = 128 / kElem;
  const int box = col / kCols, byte = (col % kCols) * kElem;
  return box * 8192 + row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// C[b] = A[b] @ W in bf16 with f32 sums (see the note at the top). Grid (N
// tiles, row tiles, batch). c_map: the output [batch, rows, N] (bf16 for B3,
// f32 for B4); acc_map: B4's arriving accumulator, read when has_acc.
template <int BM, int BN, int STAGES, bool kPartial>
__global__ void __launch_bounds__(TmaTile<BM, BN, STAGES, kPartial>::kThreads, 1)
gemm_tma_wgmma_kernel(__grid_constant__ const CUtensorMap a_map,
                      __grid_constant__ const CUtensorMap w_map,
                      __grid_constant__ const CUtensorMap c_map,
                      __grid_constant__ const CUtensorMap acc_map, int has_acc, int K) {
  using Tile = TmaTile<BM, BN, STAGES, kPartial>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::kBarOffset);
  uint64_t* empty = full + STAGES;
  uint64_t* acc_ready = empty + STAGES;
  const int wg = threadIdx.x / kWgThreads;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM, bz = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Tile::kConsumers * 4);  // one arrive per consumer warp
    }
    mbar_init(acc_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == Tile::kConsumers) {
    // The producer: one thread keeps the ring of stages filled and, once
    // the first stages are on their way (the products start on them), loads
    // B4's arriving accumulator into the output tiles.
    if (threadIdx.x == Tile::kConsumers * kWgThreads) {
      const int acc_after = (k_tiles < STAGES ? k_tiles : STAGES) - 1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* a_s = smem + s * Tile::kStageBytes;
        uint8_t* w_s = a_s + Tile::kABytes;
        mbar_expect_tx(&full[s], Tile::kStageBytes);
        tma_load_3d(a_s, &a_map, &full[s], kt * kBK, row0, bz);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(w_s + j * kBK * 128, &w_map, &full[s], col0 + 64 * j, kt * kBK);
        if (kPartial && has_acc && kt == acc_after) {
          mbar_expect_tx(acc_ready, Tile::kConsumers * Tile::kOutBytes);
          for (int c = 0; c < Tile::kConsumers; ++c)
            for (int b = 0; b < Tile::kOutBoxes; ++b)
              tma_load_3d(smem + Tile::kOutOffset + c * Tile::kOutBytes + b * 8192, &acc_map,
                          acc_ready, col0 + b * Tile::kBoxCols, row0 + c * 64, bz);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows [wg * 64, wg * 64 + 64) of the tile.
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a_s = smem + s * Tile::kStageBytes + wg * 64 * 128;
    const uint8_t* w_s = smem + s * Tile::kStageBytes + Tile::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A is K-major: the next 16 k are 32 bytes along each swizzled row;
      // 8-row groups are 1024 bytes apart. W is MN-major: 16 k-rows are two
      // 8-row swizzle atoms (2048 bytes); its 64-column boxes lie kBK x 128
      // bytes apart (the leading offset), its 8-row k groups 1024 (the
      // stride offset).
      wgmma_bf16<1>(d, smem_desc(a_s + kk * 32, 16, 1024),
                    smem_desc(w_s + kk * 2048, kBK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-tile's products have retired
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // The epilogue: the fragments into this warpgroup's output tile in shared
  // memory (B4 adds the arriving accumulator the producer loaded there), then
  // one thread stores the tile with TMA, which clips rows past the chunk and
  // columns past N. d[4j + 2h + e] is row warp * 16 + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + e.
  uint8_t* out = smem + Tile::kOutOffset + wg * Tile::kOutBytes;
  if (kPartial && has_acc) mbar_wait(acc_ready, 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + lane / 4 + 8 * h;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      uint8_t* at = out + swizzled<Tile::kOutElem>(row, col);
      if constexpr (kPartial) {
        float2 o = make_float2(v0, v1);
        if (has_acc) {
          const float2 p = *reinterpret_cast<const float2*>(at);
          o = make_float2(p.x + v0, p.y + v1);
        }
        *reinterpret_cast<float2*>(at) = o;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  // The generic-proxy writes above, made visible to the TMA unit.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWgThreads) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < Tile::kOutBoxes; ++b)
      tma_store_3d(&c_map, out + b * 8192, col0 + b * Tile::kBoxCols, row0 + wg * 64, bz);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // The tile must stay in shared memory until the stores have read it.
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = u;
}

// B4's output, (own + fwd) + bwd in that order, cast to T. ``vec``: every
// pointer is 16-byte aligned, so groups of 4 go through 16-byte loads; the
// tail (and everything when not vec) one element a thread.
template <typename T>
__global__ void mrs_epilogue_kernel(const float* __restrict__ own, const float* __restrict__ fwd,
                                    const float* __restrict__ bwd, T* __restrict__ out,
                                    long long count, int vec) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long groups = count / 4;
    for (long long g = tid; g < groups; g += step) {
      float4 v = reinterpret_cast<const float4*>(own)[g];
      if (fwd != nullptr) {
        const float4 f = reinterpret_cast<const float4*>(fwd)[g];
        v = make_float4(v.x + f.x, v.y + f.y, v.z + f.z, v.w + f.w);
      }
      if (bwd != nullptr) {
        const float4 b = reinterpret_cast<const float4*>(bwd)[g];
        v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
      }
      store4(out, 4 * g, v);
    }
    done = groups * 4;
  }
  for (long long i = done + tid; i < count; i += step) {
    float v = own[i];
    if (fwd != nullptr) v += fwd[i];
    if (bwd != nullptr) v += bwd[i];
    out[i] = from_f32<T>(v);
  }
}

// --- launches ----------------------------------------------------------------

template <bool kPartial>
int launch_simt(const void* a, const void* w, const float* acc_in, void* c, int batch, int rows,
                int K, int N, long long a_bstride, long long c_bstride, int dtype,
                cudaStream_t stream) {
  if (rows > 65535 * kTile) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, (rows + kTile - 1) / kTile, batch);
  if (dtype == 0) {
    gemm_fma_kernel<float, kPartial><<<grid, kFmaThreads, 0, stream>>>(
        (const float*)a, (const float*)w, acc_in, c, rows, K, N, a_bstride, c_bstride);
  } else if (dtype == 1) {
    const int vec = ((uintptr_t)a % 16 == 0) && ((uintptr_t)w % 16 == 0) && K % 8 == 0 &&
                    N % 8 == 0 && a_bstride % 8 == 0;
    gemm_wmma_kernel<kPartial><<<grid, kWmmaThreads, 0, stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, acc_in, c, rows, K, N, a_bstride,
        c_bstride, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, fetched once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of bf16 (elem 2) or f32 (elem 4) values with the 128-byte
// swizzle: dims and box innermost first, strides in bytes for dims 1 and up;
// zero fill out of bounds. Returns 0, or kMapRefused plus the CUDA driver's
// CUresult.
constexpr int kMapRefused = 10000;
int encode_map(CUtensorMap* map, int elem, cuuint32_t rank, const void* base,
               const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapRefused + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res =
      fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
         const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapRefused + (int)res;
}

template <int BM, int BN, int STAGES, bool kPartial>
int launch_tma(const void* a, const void* w, const float* acc_in, void* c, int batch, int rows,
               int K, int N, long long a_bstride, long long c_bstride, cudaStream_t stream) {
  using Tile = TmaTile<BM, BN, STAGES, kPartial>;
  auto kernel = gemm_tma_wgmma_kernel<BM, BN, STAGES, kPartial>;
  if ((rows + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  // cuTensorMapEncodeTiled, a CUDA driver call, needs a current context, which a
  // host thread that has launched nothing yet lacks: cudaSetDevice makes the
  // current device's primary context current (CUDA 12 and later).
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int e = Tile::kOutElem;
  CUtensorMap a_map, w_map, c_map, acc_map;
  const cuuint64_t a_dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t a_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)a_bstride * 2};
  const cuuint32_t a_box[3] = {kBK, BM, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {64, kBK};
  const cuuint64_t c_dims[3] = {(cuuint64_t)N, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t c_strides[2] = {(cuuint64_t)N * e, (cuuint64_t)c_bstride * e};
  const cuuint32_t c_box[3] = {(cuuint32_t)Tile::kBoxCols, 64, 1};
  int rc = encode_map(&a_map, 2, 3, a, a_dims, a_strides, a_box);
  if (rc == 0) rc = encode_map(&w_map, 2, 2, w, w_dims, w_strides, w_box);
  if (rc == 0) rc = encode_map(&c_map, e, 3, c, c_dims, c_strides, c_box);
  // Without an arriving accumulator its map is never read; it repeats c's.
  if (rc == 0) rc = encode_map(&acc_map, e, 3, acc_in ? acc_in : c, c_dims, c_strides, c_box);
  if (rc != 0) return rc;
  const dim3 grid((N + BN - 1) / BN, (rows + BM - 1) / BM, batch);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(a_map, w_map, c_map, acc_map,
                                                              acc_in != nullptr, K);
  return (int)cudaGetLastError();
}

// The product on the tile (bm, bn, stages), or on the earlier kernels for
// (0, 0, 0); a tile that was not built is refused.
template <bool kPartial>
int launch_gemm(const void* a, const void* w, const float* acc_in, void* c, int batch, int rows,
                int K, int N, long long a_bstride, long long c_bstride, int dtype, int bm,
                int bn, int stages, cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || N <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  if (bm == 0)
    return launch_simt<kPartial>(a, w, acc_in, c, batch, rows, K, N, a_bstride, c_bstride, dtype,
                                 stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define X(BM, BN, ST)                                                                        \
  if (bm == BM && bn == BN && stages == ST)                                                  \
    return launch_tma<BM, BN, ST, kPartial>(a, w, acc_in, c, batch, rows, K, N, a_bstride,   \
                                            c_bstride, stream);
  HVT_CM_CONFIGS
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B3: out[b, i, :] = a[b, i, :] @ w for b < batch, i < rows. ``a`` and ``out``
// point at the chunk's first row (the caller offsets them); their rows are
// contiguous (strides k and n) and their batch strides are given.
int hvt_chunk_product(const void* a, const void* w, void* out, int batch, int rows, int k, int n,
                      long long a_bstride, long long out_bstride, int dtype, int bm, int bn,
                      int stages, void* stream) {
  return launch_gemm<false>(a, w, nullptr, out, batch, rows, k, n, a_bstride, out_bstride, dtype,
                            bm, bn, stages, (cudaStream_t)stream);
}

// B4: acc_out = acc_in + a @ w, acc f32 contiguous [batch, rows, n]; acc_in
// may be null.
int hvt_partial_product(const void* a, const void* w, const void* acc_in, void* acc_out,
                        int batch, int rows, int k, int n, long long a_bstride, int dtype, int bm,
                        int bn, int stages, void* stream) {
  return launch_gemm<true>(a, w, (const float*)acc_in, acc_out, batch, rows, k, n, a_bstride,
                           (long long)rows * n, dtype, bm, bn, stages, (cudaStream_t)stream);
}

// B4's epilogue: out = (own + fwd) + bwd over ``count`` contiguous elements;
// fwd and bwd may be null.
int hvt_mrs_epilogue(const void* own, const void* fwd, const void* bwd, void* out,
                     long long count, int dtype, void* stream) {
  if (count <= 0) return 0;
  const int vec = (uintptr_t)own % 16 == 0 && (uintptr_t)fwd % 16 == 0 &&
                  (uintptr_t)bwd % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int threads = 256;
  const long long want = ((vec ? count / 4 : count) + threads - 1) / threads;
  const int blocks = (int)(want < 1 ? 1 : want < 4096 ? want : 4096);
  if (dtype == 0) {
    mrs_epilogue_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)own, (const float*)fwd, (const float*)bwd, (float*)out, count, vec);
  } else if (dtype == 1) {
    mrs_epilogue_kernel<__nv_bfloat16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)own, (const float*)fwd, (const float*)bwd, (__nv_bfloat16*)out, count, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
