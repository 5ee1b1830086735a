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
// Which kernels run where. B1 in bf16 -- the main path's forward, dQ and
// dK/dV -- runs on the tensor cores (flash_*_mma_kernel, below the
// "bf16 tensor cores" line); B1 in f32 and B2 in both dtypes stay on the
// CUDA cores (fwd_q_tile and the f32 backward kernels). No bf16 call takes
// the CUDA-core B1 kernels, and a shape or dtype no kernel takes is refused.
//
// The CUDA-core kernels (f32 B1, B2). Each block keeps its 64-row tiles in
// shared memory as f32 and never writes the T x T score matrix to device
// memory, so device traffic stays near the one-read-one-write minimum; the
// causal loops skip the tiles above the diagonal, halving the work. The
// products are f32 FMAs, a 4 x 4 register tile per thread, which bounds them
// by operations at 67 TFLOP/s, a fifteenth of the tensor cores' rate; one
// scalar load a thread and a barrier with nothing in flight per tile add
// latency. They stay for f32 (on tensor cores f32 would mean TF32, and the
// f32 parity checks need full f32) and for B2 until it is redesigned. Both
// forwards share one Q-tile loop (fwd_q_tile), whose causal bound moves with
// delta, so the ring block skips the tiles its shifted mask hides.
//
// The tensor-core kernels (bf16 B1) take the work to the tensor cores' side
// of the ridge: every product is mma.sync m16n8k16 (bf16 operands, f32
// accumulators) on operands loaded by ldmatrix, four warps a block, 16 rows
// per warp and m16 step. Tiles stay bf16 in shared memory (half the bytes of
// the f32 tiles: 46 KB a forward block at D 64 with K and V double-buffered,
// against 83 KB), padded 8 elements a row so ldmatrix hits no bank conflict,
// and arrive by cp.async, 16 bytes a thread, zero-filled past T, the next
// tile's copy in flight while this tile's products run. S and the online
// softmax stay in the accumulators; P (and dS in the backward) is rounded to
// bf16 and repacked in registers as the next product's A operand, never
// going through shared memory. Row max and sum reduce over the 4 lanes of a
// quad. The forward keeps Q's fragments in registers. The dQ kernel
// recomputes S and dP per K tile and forms dS = P (dP - Dsum) scale; the
// dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
// out as the A operands of dV += P^T dO and dK += dS^T Q. The price of
// rounding P and dS is the arithmetic's, not a fault: the plain versions
// repeat it with p_dtype=torch.bfloat16. What still bounds them: mma.sync
// issues from each warp in turn where wgmma would run a warpgroup's product
// asynchronously, every thread spends instructions on its copies where TMA
// would not, and the two backward kernels recompute S and dP (7 products to
// FlashAttention-2's 5) to stay deterministic without atomics; wgmma, TMA and
// warp specialisation are the next step. Masks are applied per element in
// C-fragment coordinates only on tiles that cross the diagonal or the ragged
// end (a zero-filled key scores 0, not -inf).
//
// The two backward kernels use no atomics, so gradients are deterministic:
// dQ loops over K tiles for one Q tile and also writes Dsum; dK/dV then loops
// over Q tiles for one K tile and reads Dsum.
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

inline int tiles(int t, int b) { return (t + b - 1) / b; }

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

// ======================================================= bf16 tensor cores --
// B1 in bf16: the same three functions on mma.sync m16n8k16 (bf16 in, f32
// accumulators), 4 warps a block. Tiles stay bf16 in shared memory, rows
// padded by 8 elements (16 bytes) so that the 8 row addresses of an ldmatrix
// fall in 8 different bank groups; they arrive by cp.async (16 bytes a thread,
// zero-filled past T), the next K/V (or Q/dO) tile in flight while this one's
// products run. Fragment layouts of m16n8k16, with g = lane / 4, c = lane % 4:
// A (16 x 16) rows g and g + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9; B
// (16 x 8) rows 2c, 2c + 1 and 2c + 8, 2c + 9 of column g; C (16 x 8) rows g
// and g + 8, columns 2c, 2c + 1. Two C fragments side by side (16 x 16) hold
// exactly the elements of one A fragment, so P and dS go from the first
// product's accumulators to the second product's operand in registers.

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes by head dim: the forward's m16 row groups a warp (Q tile = 64 x
// that) and K-tile rows, the dQ kernel's K-tile rows, the dK/dV kernel's
// Q-tile rows. Chosen from ptxas's register report and a timed sweep on an
// H100 (PERF.md): a 128-row Q tile at D 64 needs 254 registers and spills, a
// 64-row one needs 124 and is faster; tools/flash_tile_sweep.py builds other
// tile sets by defining these first.
#ifndef HVT_TILES_32
#define HVT_TILES_32 1, 64, 32, 32
#endif
#ifndef HVT_TILES_64
#define HVT_TILES_64 1, 64, 64, 32
#endif
#ifndef HVT_TILES_128
#define HVT_TILES_128 1, 32, 32, 64
#endif
template <int FWD_MW, int FWD_BK, int DQ_BK, int DKDV_BQ>
struct TileSet {
  static constexpr int fwd_mw = FWD_MW, fwd_bk = FWD_BK, dq_bk = DQ_BK, dkdv_bq = DKDV_BQ;
};
template <int D> struct Tiles;
template <> struct Tiles<32> : TileSet<HVT_TILES_32> {};
template <> struct Tiles<64> : TileSet<HVT_TILES_64> {};
template <> struct Tiles<128> : TileSet<HVT_TILES_128> {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The A fragment of the 16 x 16 block made of C fragments c0 (columns 0-7)
// and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + ROWS) of a [t, D] bf16 matrix into shared memory at a
// row stride of D + 8, asynchronously; rows past t are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int t) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CH; i += kMmaThreads) {
    const int r = i / CH, c = i % CH, g = row0 + r;
    const bool ok = g < t;
    cp_async16(dst + r * (D + 8) + c * 8, src + (ok ? (int64_t)g * D + c * 8 : 0), ok);
  }
}

// ldmatrix addresses, for the lane, into a tile of row stride D + 8:
// the A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16);
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int ld, int r0, int c0, int lane) {
  return s + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8;
}
// the B fragments of two n-blocks read from rows n (B = rows^T): rows
// [n0, n0 + 16) x columns [k0, k0 + 16) give r[0..1] for n0 and r[2..3] for
// n0 + 8;
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int ld, int n0, int k0, int lane) {
  return s + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8;
}
// the B fragments (with .trans) of two n-blocks read as they are stored:
// rows [k0, k0 + 16) (the reduction) x columns [n0, n0 + 16).
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int ld, int k0, int n0, int lane) {
  return s + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8;
}

// ------------------------------------------------------- forward, bf16 mma --
// One block per (Q tile of 64 * MW rows, bh), late rows first; warp w owns
// rows [16 (w MW + i), +16) for i < MW. Q's fragments are loaded once and
// stay in registers; S = Q K^T and the online softmax stay in the C
// fragments; P goes to bf16 A fragments for O += P V.
template <int D, int MW, int BK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, float scale, int causal) {
  constexpr int BQ = 16 * kWarps * MW, LD = D + 8, KD = D / 16, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* skv = sq + BQ * LD;                      // 2 stages of K [BK][LD], V [BK][LD]
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const bf16* qb = q + (int64_t)bh * tq * D;
  const bf16* kb = k + (int64_t)bh * tk * D;
  const bf16* vb = v + (int64_t)bh * tk * D;
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile_async<D, BQ>(sq, qb, q0, tq);
  if (n_tiles > 0) {
    load_tile_async<D, BK>(skv, kb, 0, tk);
    load_tile_async<D, BK>(skv + BK * LD, vb, 0, tk);
  }
  cp_async_commit();

  uint32_t qf[MW][KD][4];
  float acc[MW][ND][4], m[MW][2], l[MW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[i][h] = kNegInf, l[i][h] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  const int warp_row0 = q0 + warp * MW * 16;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {
      bf16* nxt = skv + ((it + 1) & 1) * 2 * BK * LD;
      load_tile_async<D, BK>(nxt, kb, k0 + BK, tk);
      load_tile_async<D, BK>(nxt + BK * LD, vb, k0 + BK, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[i][kk], a_addr(sq, LD, (warp * MW + i) * 16, kk * 16, lane));
    }
    const bf16* sk = skv + (it & 1) * 2 * BK * LD;
    const bf16* sv = sk + BK * LD;

    float s[MW][NK][4];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bt_addr(sk, LD, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          mma16816(s[i][2 * np], qf[i][kk], b[0], b[1]);
          mma16816(s[i][2 * np + 1], qf[i][kk], b[2], b[3]);
        }
      }

    // Masks only where the tile crosses the ragged end or this warp's part
    // of the diagonal; a zero-filled key scores 0, so it must be masked.
    const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > warp_row0);
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = warp_row0 + i * 16 + g + 8 * h;
        float row_max = kNegInf;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[i][j][2 * h + e] * scale;
            if (edge) {
              const int kj = k0 + j * 8 + 2 * c + e;
              x = (kj < tk && (!causal || qi >= kj)) ? x : kNegInf;
            }
            s[i][j][2 * h + e] = x;
            row_max = fmaxf(row_max, x);
          }
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
        const float m_new = fmaxf(m[i][h], row_max);
        const float alpha = exp2f((m[i][h] - m_new) * kLog2e);
        const float ml = m_new * kLog2e;
        float row_sum = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // Masked entries are re-masked: a fully masked row has m_new ==
            // -1e30 and exp(s - m_new) would be 1 there.
            const float x = s[i][j][2 * h + e];
            const float p = x == kNegInf ? 0.f : exp2f(fmaf(x, kLog2e, -ml));
            s[i][j][2 * h + e] = p;
            row_sum += p;
          }
        l[i][h] = alpha * l[i][h] + row_sum;  // this lane's columns; summed at the end
        m[i][h] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j][2 * h] *= alpha, acc[i][j][2 * h + 1] *= alpha;
      }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i) c_to_a(pa[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, b_addr(sv, LD, kk * 16, dp * 16, lane));
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          mma16816(acc[i][2 * dp], pa[i], b[0], b[1]);
          mma16816(acc[i][2 * dp + 1], pa[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float li = l[i][h];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qi = warp_row0 + i * 16 + g + 8 * h;
      if (qi >= tq) continue;
      li = li == 0.f ? 1.f : li;  // fully masked rows give 0
      const float inv = 1.f / li;
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + ((int64_t)bh * tq + qi) * D);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        orow[j * 4 + c] = pack_bf16(acc[i][j][2 * h] * inv, acc[i][j][2 * h + 1] * inv);
      if (c == 0) lse[(int64_t)bh * tq + qi] = m[i][h] + logf(li);
    }
}

// ---------------------------------------------------- backward dQ, bf16 mma --
// One block per (Q tile of 64 rows, bh), late rows first; warp w owns rows
// [16 w, +16). Dsum = rowsum(dO * O) first (each lane of a quad a quarter of
// D), written for the dK/dV kernel. Then per visible K tile: S = Q K^T and
// dP = dO V^T in C fragments, P = exp(S - lse), dS = P (dP - Dsum) scale,
// dS to bf16 A fragments, dQ += dS K (K read transposed by ldmatrix.trans).
template <int D, int BK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        bf16* __restrict__ dq, float* __restrict__ dsum, int tq, int tk,
                        float scale, int causal) {
  constexpr int BQ = 16 * kWarps, LD = D + 8, KD = D / 16, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sdo = sq + BQ * LD;                      // [BQ][LD]
  bf16* skv = sdo + BQ * LD;                     // 2 stages of K [BK][LD], V [BK][LD]
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int64_t qoff = (int64_t)bh * tq * D, koff = (int64_t)bh * tk * D;
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile_async<D, BQ>(sq, q + qoff, q0, tq);
  load_tile_async<D, BQ>(sdo, dout + qoff, q0, tq);
  if (n_tiles > 0) {
    load_tile_async<D, BK>(skv, k + koff, 0, tk);
    load_tile_async<D, BK>(skv + BK * LD, v + koff, 0, tk);
  }
  cp_async_commit();

  const int warp_row0 = q0 + warp * 16;
  float row_d[2], row_lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = warp_row0 + g + 8 * h;
    float part = 0.f;
    if (qi < tq) {
      const uint4* orow = reinterpret_cast<const uint4*>(o + qoff + (int64_t)qi * D + c * (D / 4));
      const uint4* drow =
          reinterpret_cast<const uint4*>(dout + qoff + (int64_t)qi * D + c * (D / 4));
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
        const uint4 ov = orow[u], dv4 = drow[u];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]), b = __bfloat1622float2(d2[e]);
          part = fmaf(a.x, b.x, part);
          part = fmaf(a.y, b.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    row_d[h] = part;
    row_lse[h] = qi < tq ? lse[(int64_t)bh * tq + qi] * kLog2e : 0.f;
    if (c == 0 && qi < tq) dsum[(int64_t)bh * tq + qi] = part;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {
      bf16* nxt = skv + ((it + 1) & 1) * 2 * BK * LD;
      load_tile_async<D, BK>(nxt, k + koff, k0 + BK, tk);
      load_tile_async<D, BK>(nxt + BK * LD, v + koff, k0 + BK, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = skv + (it & 1) * 2 * BK * LD;
    const bf16* sv = sk + BK * LD;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_addr(sq, LD, warp * 16, kk * 16, lane));
      ldsm_x4(da, a_addr(sdo, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bt_addr(sk, LD, np * 16, kk * 16, lane));
        mma16816(s[2 * np], qa, b[0], b[1]);
        mma16816(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4(b, bt_addr(sv, LD, np * 16, kk * 16, lane));
        mma16816(dp[2 * np], da, b[0], b[1]);
        mma16816(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > warp_row0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = warp_row0 + g + 8 * h, kj = k0 + j * 8 + 2 * c + e;
          const bool ok = !edge || (kj < tk && (!causal || qi >= kj));
          const float p = ok ? exp2f(fmaf(s[j][2 * h + e], sl2, -row_lse[h])) : 0.f;
          s[j][2 * h + e] = p * (dp[j][2 * h + e] - row_d[h]) * scale;  // dS
        }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, b_addr(sk, LD, kk * 16, dn * 16, lane));
        mma16816(acc[2 * dn], a, b[0], b[1]);
        mma16816(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = warp_row0 + g + 8 * h;
    if (qi >= tq) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(dq + qoff + (int64_t)qi * D);
#pragma unroll
    for (int j = 0; j < ND; ++j) row[j * 4 + c] = pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// -------------------------------------------------- backward dK/dV, bf16 mma --
// One block per (K tile of 64 rows, bh), early keys first; warp w owns keys
// [16 w, +16). Per Q tile that sees them, the transposed products S^T = K Q^T
// and dP^T = V dO^T (Q and dO read as B operands), P^T = exp(S^T - lse) and
// dS^T = P^T (dP^T - Dsum) scale, then from the same registers dV += P^T dO
// and dK += dS^T Q. lse and Dsum ride along with each Q tile's copy.
template <int D, int BQ>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk,
                          float scale, int causal) {
  constexpr int BKV = 16 * kWarps, LD = D + 8, KD = D / 16, NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD]
  bf16* sv = sk + BKV * LD;                      // [BKV][LD]
  bf16* sqd = sv + BKV * LD;                     // 2 stages of Q [BQ][LD], dO [BQ][LD]
  float* sst = reinterpret_cast<float*>(sqd + 4 * BQ * LD);  // 2 stages of lse [BQ], Dsum [BQ]
  const int bh = blockIdx.y, k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int64_t qoff = (int64_t)bh * tq * D, koff = (int64_t)bh * tk * D;
  // Under the causal mask no query row before this tile's first key sees it.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + BQ - 1) / BQ : 0;

  auto load_q_tile = [&](int stage, int q0) {
    bf16* dst = sqd + stage * 2 * BQ * LD;
    load_tile_async<D, BQ>(dst, q + qoff, q0, tq);
    load_tile_async<D, BQ>(dst + BQ * LD, dout + qoff, q0, tq);
    float* st = sst + stage * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += kMmaThreads) {
      const int r = i % BQ, qi = q0 + r;
      const bool ok = qi < tq;
      const float* src = i < BQ ? lse : dsum;
      cp_async4(st + i, src + (ok ? (int64_t)bh * tq + qi : 0), ok);
    }
  };

  load_tile_async<D, BKV>(sk, k + koff, k0, tk);
  load_tile_async<D, BKV>(sv, v + koff, k0, tk);
  if (n_tiles > 0) load_q_tile(0, q_begin);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const int warp_key0 = k0 + warp * 16;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    if (it + 1 < n_tiles) {
      load_q_tile((it + 1) & 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = sqd + (it & 1) * 2 * BQ * LD;
    const bf16* sdo = sq + BQ * LD;
    const float* slse = sst + (it & 1) * 2 * BQ;
    const float* sds = slse + BQ;

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr(sk, LD, warp * 16, kk * 16, lane));
      ldsm_x4(va, a_addr(sv, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bt_addr(sq, LD, np * 16, kk * 16, lane));
        mma16816(s[2 * np], ka, b[0], b[1]);
        mma16816(s[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, bt_addr(sdo, LD, np * 16, kk * 16, lane));
        mma16816(dp[2 * np], va, b[0], b[1]);
        mma16816(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // Rows are keys, columns queries; rows past tk and columns past tq are
    // zero-filled and masked where the tile crosses them.
    const bool edge = q0 + BQ > tq || warp_key0 + 16 > tk || (causal && q0 < warp_key0 + 15);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = warp_key0 + g + 8 * h, r = j * 8 + 2 * c + e, qi = q0 + r;
          const bool ok = !edge || (qi < tq && kj < tk && (!causal || qi >= kj));
          const float p =
              ok ? exp2f(fmaf(s[j][2 * h + e], sl2, -slse[r] * kLog2e)) : 0.f;
          s[j][2 * h + e] = p;                                         // P^T
          dp[j][2 * h + e] = p * (dp[j][2 * h + e] - sds[r]) * scale;  // dS^T
        }

#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, b_addr(sdo, LD, kk * 16, dn * 16, lane));
        mma16816(acc_v[2 * dn], pa, b[0], b[1]);
        mma16816(acc_v[2 * dn + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, b_addr(sq, LD, kk * 16, dn * 16, lane));
        mma16816(acc_k[2 * dn], da, b[0], b[1]);
        mma16816(acc_k[2 * dn + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = warp_key0 + g + 8 * h;
    if (kj >= tk) continue;
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk + koff + (int64_t)kj * D);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + koff + (int64_t)kj * D);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      krow[j * 4 + c] = pack_bf16(acc_k[j][2 * h], acc_k[j][2 * h + 1]);
      vrow[j * 4 + c] = pack_bf16(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                           int bh, int tq, int tk, float scale, int causal, cudaStream_t stream) {
  constexpr int MW = Tiles<D>::fwd_mw, BK = Tiles<D>::fwd_bk, BQ = 16 * kWarps * MW;
  auto kernel = flash_fwd_mma_kernel<D, MW, BK>;
  const size_t smem = sizeof(bf16) * (BQ + 4 * BK) * (D + 8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tq, BQ), bh), kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, tq, tk, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq_mma(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dq, void* dsum, int bh,
                              int tq, int tk, float scale, int causal, cudaStream_t stream) {
  constexpr int BK = Tiles<D>::dq_bk, BQ = 16 * kWarps;
  auto kernel = flash_bwd_dq_mma_kernel<D, BK>;
  const size_t smem = sizeof(bf16) * (2 * BQ + 4 * BK) * (D + 8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tq, BQ), bh), kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (bf16*)dq, (float*)dsum, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkdv_mma(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* dsum, void* dk, void* dv, int bh,
                                int tq, int tk, float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::dkdv_bq, BKV = 16 * kWarps;
  auto kernel = flash_bwd_dkdv_mma_kernel<D, BQ>;
  const size_t smem = sizeof(bf16) * (2 * BKV + 4 * BQ) * (D + 8) + sizeof(float) * 4 * BQ;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(tk, BKV), bh), kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dk, (bf16*)dv, tq, tk, scale, causal);
  return cudaGetLastError();
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

// B1's entries: f32 to the CUDA-core kernel F32<float, D>, bf16 to the
// tensor-core kernel BF16<D>; nothing else is taken.
#define HVT_B1_DISPATCH(dtype, d, F32, BF16, ...)                 \
  do {                                                            \
    if ((dtype) == 0) {                                           \
      if ((d) == 32) return (int)F32<float, 32>(__VA_ARGS__);     \
      if ((d) == 64) return (int)F32<float, 64>(__VA_ARGS__);     \
      if ((d) == 128) return (int)F32<float, 128>(__VA_ARGS__);   \
    } else if ((dtype) == 1) {                                    \
      if ((d) == 32) return (int)BF16<32>(__VA_ARGS__);           \
      if ((d) == 64) return (int)BF16<64>(__VA_ARGS__);           \
      if ((d) == 128) return (int)BF16<128>(__VA_ARGS__);         \
    }                                                             \
    return (int)cudaErrorInvalidValue;                            \
  } while (0)

template <int D>
void tile_sizes(int* out) {
  out[0] = 16 * kWarps * Tiles<D>::fwd_mw;
  out[1] = Tiles<D>::fwd_bk;
  out[2] = 16 * kWarps;
  out[3] = Tiles<D>::dq_bk;
  out[4] = 16 * kWarps;
  out[5] = Tiles<D>::dkdv_bq;
}

}  // namespace

extern "C" {

int hvt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                  int tk, int d, int dtype, float scale, int causal, void* stream) {
  HVT_B1_DISPATCH(dtype, d, launch_fwd, launch_fwd_mma, q, k, v, o, lse, bh, tq, tk, scale,
                  causal, (cudaStream_t)stream);
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
  HVT_B1_DISPATCH(dtype, d, launch_bwd_dq, launch_bwd_dq_mma, q, k, v, o, dout, lse, dq, dsum,
                  bh, tq, tk, scale, causal, (cudaStream_t)stream);
}

int hvt_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dsum, void* dk, void* dv, int bh, int tq,
                       int tk, int d, int dtype, float scale, int causal, void* stream) {
  HVT_B1_DISPATCH(dtype, d, launch_bwd_dkdv, launch_bwd_dkdv_mma, q, k, v, dout, lse, dsum, dk,
                  dv, bh, tq, tk, scale, causal, (cudaStream_t)stream);
}

// The bf16 kernels' tiles at head dim d, as (rows, rows) pairs: the
// forward's Q and K tiles, the dQ kernel's Q and K tiles, the dK/dV kernel's
// K and Q tiles. Returns cudaErrorInvalidValue for another d.
int hvt_flash_tiles(int d, int* out) {
  if (d == 32) return tile_sizes<32>(out), 0;
  if (d == 64) return tile_sizes<64>(out), 0;
  if (d == 128) return tile_sizes<128>(out), 0;
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
