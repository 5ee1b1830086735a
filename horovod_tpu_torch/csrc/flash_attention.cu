// Flash attention for Hopper (sm_90a): forward, ring block forward, backward
// dQ, backward dK/dV.
//
// Replaces the TPU kernel horovod_tpu/ops/pallas_attention.py:_fwd_kernel in
// both its modes (launched by _flash_call: normalize=True with delta=0, and
// normalize=False with a delta for the ring-attention block) and the XLA
// lax.scan backward horovod_tpu/ops/pallas_attention.py:_flash_vjp_bwd.
//
// What it computes, over q [BH, Tq, D] and k, v [BH, Tk, D] (row-major,
// contiguous):
//   forward:  O = softmax(Q K^T * scale [causal mask]) V, in the input dtype,
//             and lse = m + log(l == 0 ? 1 : l) in f32 [BH, T], with the online
//             softmax in f32. Masked scores are -1e30 and p is masked again, so
//             a fully masked row gives 0, as _fwd_kernel does.
//   block:    the same loop with the causal mask qi >= kj + delta, written
//             without normalising: O = sum P V in f32, the row max m and the
//             row sum l = sum exp(s - m), f32 [BH, Tq] each, for the ring's
//             online-softmax merge. A row that sees no key gives m = -1e30,
//             l = 0, O = 0. The block's backward is a dense recompute in
//             PyTorch, as the reference's (_flash_block_vjp_bwd) is in XLA.
//   backward: P is recomputed from the saved lse; Dsum = rowsum(dO * O);
//             dS = P * (dP - Dsum) * scale; dQ = dS K, dK = dS^T Q, dV = P^T dO.
//
// What bounds it on an H100. q, k, v and O are 2 B * BH * T * D bytes each in
// bf16; the causal forward does 2 * BH * T^2 * D FLOPs (half of 4 * BH * T^2 * D,
// the two products, because the tiles above the diagonal are skipped). At the
// GPT-2-small shape (BH = 96, T = 1024, D = 64) that is 50 MB against 12.9 GFLOP:
// 15 us of HBM traffic against 13 us at the 989 TFLOP/s tensor-core peak, so
// the work sits near the ridge, and a kernel that runs its products on the CUDA
// cores (67 TFLOP/s f32) is bound by operations. The block forward at the
// long-context shape (BH = 24, T = 4096, D = 64, delta = 0) reads 38 MB of bf16
// q, k, v and writes 26 MB of f32 O, m, l (19 us) against 51.5 GFLOP (52 us at
// the tensor-core peak): bound by operations too. At delta = -T it sees every
// key, twice the work; at delta >= T it sees none and only writes.
//
// What this simple design does about it. Each block keeps its 64-row tiles in
// shared memory as f32 and never writes the T x T score matrix to device
// memory, so device traffic stays near the one-read-one-write minimum; the
// causal loops skip the tiles above the diagonal, halving the work. The
// products are f32 FMAs on the CUDA cores, a 4 x 4 register tile per thread:
// right first, and the same code serves the f32 parity check. Both forwards
// share one Q-tile loop (fwd_q_tile), whose causal bound moves with delta, so
// the ring block skips the tiles its shifted mask hides. Tensor cores
// (mma/wgmma), TMA and warp specialisation are later work. The two backward
// kernels use no atomics, so gradients are deterministic: dQ loops over K tiles
// for one Q tile and also writes Dsum; dK/dV then loops over Q tiles for one K
// tile and reads Dsum.
//
// C interface (bound with ctypes): pointers and the stream are void*, every
// entry returns cudaGetLastError() after its launch. dtype: 0 = f32, 1 = bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid; each thread owns 4 x 4 of a 64 x 64 tile
constexpr float kNegInf = -1e30f;

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

// Sum or max over the 16 threads that share a row: lanes that differ only in
// their low four bits (threadIdx.x = 16 * ty + tx, tx in [0, 16)).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + ROWS) of a [t, D] matrix into shared memory as f32 with a
// row stride of D + 1 (no bank conflicts on column walks); rows past t are 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int t) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, g = row0 + r;
    dst[r * (D + 1) + c] = g < t ? to_f32(src[(int64_t)g * D + c]) : 0.f;
  }
}

// ---------------------------------------------------------------- forward --
// The online softmax of one 64-row Q tile over the K tiles it can see: on
// return acc holds the unnormalised sum P V, m the row max of the scaled
// scores and l the sum of exp(s - m), per row of the thread's 4 x 4 tile.
// Under the causal mask key kj is visible to query qi when qi >= kj + delta
// (delta = the K block's sequence origin minus Q's; 0 for self-attention).
// Without causal, delta is ignored.
template <typename T, int D>
__device__ __forceinline__ void fwd_q_tile(const T* __restrict__ qb, const T* __restrict__ kb,
                                           const T* __restrict__ vb, float* smem, int q0, int tq,
                                           int tk, float scale, int causal, int delta,
                                           float (&acc)[4][D / 16], float (&m)[4], float (&l)[4]) {
  constexpr int LD = D + 1, LP = kBlockK + 1, DJ = D / 16;
  float* sq = smem;                 // [kBlockQ][LD]
  float* sk = sq + kBlockQ * LD;    // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;    // [kBlockK][LD]
  float* sp = sv + kBlockK * LD;    // [kBlockQ][LP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, kBlockQ>(sq, qb, q0, tq);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // Under the causal mask no key at or past q0 + kBlockQ - delta is seen by
  // this tile; a delta of a whole tile or more leaves it no key at all.
  const int k_end = causal ? max(0, min(tk, q0 + kBlockQ - delta)) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's sk/sv/sp are no longer read
    load_tile<T, D, kBlockK>(sk, kb, k0, tk);
    load_tile<T, D, kBlockK>(sv, vb, k0, tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < tk && (!causal || qi >= kj + delta);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(row_max));
      const float alpha = __expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Masked entries are re-masked: a fully masked row has m_new == -1e30
        // and exp(s - m_new) would be 1 there.
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        sp[(ty + 16 * i) * LP + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = alpha * l[i] + row_sum16(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sv[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
}

// B1: one block per (Q tile, bh); heavier causal tiles (late Q rows) launch
// first. Writes O = acc / l in the input dtype and lse = m + log l.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int tq, int tk, float scale,
                 int causal) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][DJ], m[4], l[4];
  fwd_q_tile<T, D>(q + (int64_t)bh * tq * D, k + (int64_t)bh * tk * D, v + (int64_t)bh * tk * D,
                   smem, q0, tq, tk, scale, causal, 0, acc, m, l);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully masked rows give 0
    T* orow = o + ((int64_t)bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / li);
    if (tx == 0) lse[(int64_t)bh * tq + qi] = m[i] + logf(li);
  }
}

// B2, the ring-attention block: the same tile loop with the causal mask
// shifted by delta, and no normalisation. Writes the f32 triple the ring
// merges across ranks: O = sum P V unnormalised, m and l exactly as the loop
// keeps them. A row that sees no key keeps m = -1e30, l = 0 and O = 0.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       float* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, int tq, int tk, float scale, int causal,
                       int delta) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][DJ], m[4], l[4];
  fwd_q_tile<T, D>(q + (int64_t)bh * tq * D, k + (int64_t)bh * tk * D, v + (int64_t)bh * tk * D,
                   smem, q0, tq, tk, scale, causal, delta, acc, m, l);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    float* orow = o + ((int64_t)bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j];
    if (tx == 0) {
      m_out[(int64_t)bh * tq + qi] = m[i];
      l_out[(int64_t)bh * tq + qi] = l[i];
    }
  }
}

// ------------------------------------------------------------ backward dQ --
// One block per (Q tile, bh): loops over the K tiles up to the diagonal,
// accumulating dQ in registers. It also writes Dsum = rowsum(dO * O) for the
// dK/dV kernel, which runs after it on the same stream.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ dsum,
                    int tq, int tk, float scale, int causal) {
  constexpr int LD = D + 1, LP = kBlockK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;                  // [kBlockQ][LD]
  float* sdo = sq + kBlockQ * LD;    // [kBlockQ][LD]
  float* sk = sdo + kBlockQ * LD;    // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;     // [kBlockK][LD]
  float* sds = sv + kBlockK * LD;    // [kBlockQ][LP]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t qoff = (int64_t)bh * tq * D, koff = (int64_t)bh * tk * D;

  load_tile<T, D, kBlockQ>(sq, q + qoff, q0, tq);
  load_tile<T, D, kBlockQ>(sdo, dout + qoff, q0, tq);
  __syncthreads();

  float row_d[4], row_lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    float part = 0.f;
    if (qi < tq) {
      const T* orow = o + qoff + (int64_t)qi * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) part += sdo[r * LD + tx + 16 * j] * to_f32(orow[tx + 16 * j]);
    }
    row_d[i] = row_sum16(part);
    row_lse[i] = qi < tq ? lse[(int64_t)bh * tq + qi] : 0.f;
    if (tx == 0 && qi < tq) dsum[(int64_t)bh * tq + qi] = row_d[i];
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    load_tile<T, D, kBlockK>(sk, k + koff, k0, tk);
    load_tile<T, D, kBlockK>(sv, v + koff, k0, tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sq[(ty + 16 * i) * LD + d];
        g[i] = sdo[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sk[(tx + 16 * j) * LD + d];
        w[j] = sv[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < tq && kj < tk && (!causal || qi >= kj);
        const float p = ok ? __expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sds[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - row_d[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sds[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sk[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    T* row = dq + qoff + (int64_t)qi * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------- backward dK/dV --
// One block per (K tile, bh): loops over the Q tiles from the diagonal down,
// accumulating dK and dV in registers. Early K tiles see the most Q tiles
// under the causal mask and launch first. Here a thread's 4 x 4 tile has
// keys on its rows and queries on its columns.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      int tq, int tk, float scale, int causal) {
  constexpr int LD = D + 1, LP = kBlockQ + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;                   // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;      // [kBlockK][LD]
  float* sq = sv + kBlockK * LD;      // [kBlockQ][LD]
  float* sdo = sq + kBlockQ * LD;     // [kBlockQ][LD]
  float* spt = sdo + kBlockQ * LD;    // [kBlockK][LP]  P^T
  float* sdst = spt + kBlockK * LP;   // [kBlockK][LP]  dS^T
  float* slse = sdst + kBlockK * LP;  // [kBlockQ]
  float* sdsum = slse + kBlockQ;      // [kBlockQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t qoff = (int64_t)bh * tq * D, koff = (int64_t)bh * tk * D;

  load_tile<T, D, kBlockK>(sk, k + koff, k0, tk);
  load_tile<T, D, kBlockK>(sv, v + koff, k0, tk);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // Under the causal mask no query row before this tile's first key sees it.
  const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kBlockQ) {
    __syncthreads();
    load_tile<T, D, kBlockQ>(sq, q + qoff, q0, tq);
    load_tile<T, D, kBlockQ>(sdo, dout + qoff, q0, tq);
    for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
      const int qi = q0 + r;
      slse[r] = qi < tq ? lse[(int64_t)bh * tq + qi] : 0.f;
      sdsum[r] = qi < tq ? dsum[(int64_t)bh * tq + qi] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[4], vv[4], qq[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = sk[(ty + 16 * i) * LD + d];
        vv[i] = sv[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = sq[(tx + 16 * j) * LD + d];
        gg[j] = sdo[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qi = q0 + r;
        const bool ok = qi < tq && kj < tk && (!causal || qi >= kj);
        const float p = ok ? __expf(s[i][j] * scale - slse[r]) : 0.f;
        spt[(ty + 16 * i) * LP + r] = p;
        sdst[(ty + 16 * i) * LP + r] = p * (dp[i][j] - sdsum[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = spt[(ty + 16 * i) * LP + r];
        ds[i] = sdst[(ty + 16 * i) * LP + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float g = sdo[r * LD + tx + 16 * j];
        const float x = sq[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(p[i], g, acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], x, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= tk) continue;
    T* krow = dk + koff + (int64_t)kj * D;
    T* vrow = dv + koff + (int64_t)kj * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = from_f32<T>(acc_k[i][j]);
      vrow[tx + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

constexpr size_t fwd_smem(int d) {
  return sizeof(float) * ((kBlockQ + 2 * kBlockK) * (d + 1) + kBlockQ * (kBlockK + 1));
}
constexpr size_t dq_smem(int d) {
  return sizeof(float) * ((2 * kBlockQ + 2 * kBlockK) * (d + 1) + kBlockQ * (kBlockK + 1));
}
constexpr size_t dkdv_smem(int d) {
  return sizeof(float) *
         ((2 * kBlockQ + 2 * kBlockK) * (d + 1) + 2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
}

inline int tiles(int t, int b) { return (t + b - 1) / b; }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int tq, int tk, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = fwd_smem(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tq, kBlockQ), bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_block_fwd(const void* q, const void* k, const void* v, void* o, void* m,
                             void* l, int bh, int tq, int tk, float scale, int causal, int delta,
                             cudaStream_t stream) {
  auto kernel = flash_block_fwd_kernel<T, D>;
  const size_t smem = fwd_smem(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tq, kBlockQ), bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)o, (float*)m, (float*)l, tq, tk, scale,
      causal, delta);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* dq, void* dsum, int bh, int tq,
                          int tk, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = dq_smem(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tq, kBlockQ), bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (const float*)lse,
      (T*)dq, (float*)dsum, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dsum, void* dk, void* dv, int bh, int tq,
                            int tk, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, D>;
  const size_t smem = dkdv_smem(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tk, kBlockK), bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)dsum, (T*)dk, (T*)dv, tq, tk, scale, causal);
  return cudaGetLastError();
}

// Instantiate F<T, D> for the supported (dtype, head dim) pairs.
#define HVT_DISPATCH(dtype, d, F, ...)                         \
  do {                                                         \
    if ((dtype) == 0) {                                        \
      if ((d) == 32) return (int)F<float, 32>(__VA_ARGS__);    \
      if ((d) == 64) return (int)F<float, 64>(__VA_ARGS__);    \
      if ((d) == 128) return (int)F<float, 128>(__VA_ARGS__);  \
    } else if ((dtype) == 1) {                                 \
      if ((d) == 32) return (int)F<__nv_bfloat16, 32>(__VA_ARGS__);   \
      if ((d) == 64) return (int)F<__nv_bfloat16, 64>(__VA_ARGS__);   \
      if ((d) == 128) return (int)F<__nv_bfloat16, 128>(__VA_ARGS__); \
    }                                                          \
    return (int)cudaErrorInvalidValue;                         \
  } while (0)

}  // namespace

extern "C" {

int hvt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                  int tk, int d, int dtype, float scale, int causal, void* stream) {
  HVT_DISPATCH(dtype, d, launch_fwd, q, k, v, o, lse, bh, tq, tk, scale, causal,
               (cudaStream_t)stream);
}

int hvt_flash_block_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                        int bh, int tq, int tk, int d, int dtype, float scale, int causal,
                        int delta, void* stream) {
  HVT_DISPATCH(dtype, d, launch_block_fwd, q, k, v, o, m, l, bh, tq, tk, scale, causal, delta,
               (cudaStream_t)stream);
}

int hvt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dsum, int bh, int tq,
                     int tk, int d, int dtype, float scale, int causal, void* stream) {
  HVT_DISPATCH(dtype, d, launch_bwd_dq, q, k, v, o, dout, lse, dq, dsum, bh, tq, tk, scale,
               causal, (cudaStream_t)stream);
}

int hvt_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dsum, void* dk, void* dv, int bh, int tq,
                       int tk, int d, int dtype, float scale, int causal, void* stream) {
  HVT_DISPATCH(dtype, d, launch_bwd_dkdv, q, k, v, dout, lse, dsum, dk, dv, bh, tq, tk, scale,
               causal, (cudaStream_t)stream);
}

}  // extern "C"
