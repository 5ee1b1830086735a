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
// of HBM traffic, so the products are bound by operations; B4 is the same
// (tools/kernel_bounds.py gives each call's bound). The link bounds the ring
// itself: the other ranks' chunks need 21 us (B3, bf16) and 42 us (B4, f32
// partials) at NVLink's 450 GB/s, more than the products at peak.
//
// What this simple design does about it. bf16 chunk products run on the
// tensor cores through WMMA (16 x 16 x 16 bf16 fragments, f32 sums): a block
// computes a 64 x 64 output tile with four warps of 2 x 2 fragments, over
// k-tiles of 32 staged in shared memory with 16-byte loads where the shapes
// allow, and writes the tile through shared memory so the ragged edges and the
// epilogue (cast, or the f32 add) are masked per element. f32 products (the
// parity runs) use FMAs on the CUDA cores with a 4 x 4 register tile per
// thread. One k-tile in flight and no TMA or wgmma: pipelined tiles, and peer
// copies over NVLink from inside a persistent ring kernel, are later work.
// Every output element is computed the same way whatever the chunk's row count,
// so a chunk's rows are bitwise the rows of the same product over the
// gathered input.
//
// C interface (bound with ctypes): pointers and the stream are void*, strides
// are in elements, every entry returns cudaGetLastError() after its launch.
// dtype: 0 = f32, 1 = bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

// The same product in bf16 on the tensor cores (WMMA, f32 sums). ``vec``: the
// shapes and pointers allow 16-byte loads of 8 bf16 values.
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

template <typename T>
__global__ void mrs_epilogue_kernel(const float* __restrict__ own, const float* __restrict__ fwd,
                                    const float* __restrict__ bwd, T* __restrict__ out,
                                    long long count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float v = own[i];
    if (fwd != nullptr) v += fwd[i];
    if (bwd != nullptr) v += bwd[i];
    out[i] = from_f32<T>(v);
  }
}

template <bool kPartial>
int launch_gemm(const void* a, const void* w, const float* acc_in, void* c, int batch, int rows,
                int K, int N, long long a_bstride, long long c_bstride, int dtype,
                cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || N <= 0) return 0;
  if (batch > 65535 || (rows + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// B3: out[b, i, :] = a[b, i, :] @ w for b < batch, i < rows. ``a`` and ``out``
// point at the chunk's first row (the caller offsets them); their rows are
// contiguous (strides k and n) and their batch strides are given.
int hvt_chunk_product(const void* a, const void* w, void* out, int batch, int rows, int k, int n,
                      long long a_bstride, long long out_bstride, int dtype, void* stream) {
  return launch_gemm<false>(a, w, nullptr, out, batch, rows, k, n, a_bstride, out_bstride, dtype,
                            (cudaStream_t)stream);
}

// B4: acc_out = acc_in + a @ w, acc f32 contiguous [batch, rows, n]; acc_in
// may be null.
int hvt_partial_product(const void* a, const void* w, const void* acc_in, void* acc_out,
                        int batch, int rows, int k, int n, long long a_bstride, int dtype,
                        void* stream) {
  return launch_gemm<true>(a, w, (const float*)acc_in, acc_out, batch, rows, k, n, a_bstride,
                           (long long)rows * n, dtype, (cudaStream_t)stream);
}

// B4's epilogue: out = (own + fwd) + bwd over ``count`` contiguous elements;
// fwd and bwd may be null.
int hvt_mrs_epilogue(const void* own, const void* fwd, const void* bwd, void* out,
                     long long count, int dtype, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (dtype == 0) {
    mrs_epilogue_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)own, (const float*)fwd, (const float*)bwd, (float*)out, count);
  } else if (dtype == 1) {
    mrs_epilogue_kernel<__nv_bfloat16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)own, (const float*)fwd, (const float*)bwd, (__nv_bfloat16*)out, count);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
