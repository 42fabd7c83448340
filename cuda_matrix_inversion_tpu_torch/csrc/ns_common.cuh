// Device code of the Newton-Schulz kernels: the shared-memory product
// routine and the block maximum (K1, K8 in newton_schulz.cu; K6, K11 in
// gp.cu, for their fp32 residual), and the cold-start seed and the
// fixed-schedule round loop on shared-memory operands, which emulate bf16
// on CUDA cores and now serve K1 and K8 only (K6 and K11 run their rounds
// on the tensor cores, gp.cu::ns_mma_rounds).
// The seed (ns_seed) and the rounds (ns_rounds) are separate, as the JAX
// package's ns_vmem_iterate and ns_vmem_rounds are: the warm kernel K8
// loads X from a previous inverse and runs the rounds alone (as K11 does on
// the tensor cores), with the
// per-round scalars 2c = 2 and c^2 = 1 (no recentering: a scalar calibrated
// for a cold start would blow a converged start apart).
//
// Arithmetic (the compiled-TPU semantics, mid_split=True):
//   seed   spd: X1 = 2sI - s^2 A, s = 1/||A||_inf;  pan: X0 = A^T/(||A||_1 ||A||_inf)
//   lo     T = 2c I - c^2 (A X);  X = X T        (one-pass bf16 products, or
//                                                 dot3 for the split3 lane)
//   hi     R = I - A X;  X = X + X R             (bf16 lanes: R in fp32 on the
//          last round when polish_highest, dot3 before it, update one-pass;
//          split3: R in fp32, update dot3)
// A "one-pass" product rounds both operands to bf16 (round to nearest even)
// and accumulates in fp32, which is what a bf16 MMA with fp32 accumulation
// computes; dot3(x, y) = hi(x)hi(y) + lo(x)hi(y) + hi(x)lo(y) with
// lo(x) = bf16(x - hi(x)).  Never TF32: the schedules are calibrated for
// bf16 rounding.  The per-round scalars 2c and c^2 come from the host
// (scaled_round_coeffs, computed in double and rounded to fp32).
//
// Layout: the three operands are NP x NP (NP = 16M) fp32 blocks with the
// odd row stride NP + 1, so the column reads of the left operand hit
// distinct banks.  Each of the 256 threads keeps an M x M register tile of
// a product (rows ty + 16r, columns tx + 16c), so one shared-memory load
// feeds M FMAs.  Products into an operand (X = X T, X = X + X R) finish all
// reads before a barrier and only then write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid over the output
constexpr int kMaxRounds = 32;
constexpr int kMaxN = 128;

struct NSParams {
  int n;
  int init_spd;
  int lo;
  int hi;
  int split3;
  int polish_highest;
  float two_c[kMaxRounds];  // fp32(2c) per lo round
  float c_sq[kMaxRounds];   // fp32(c*c) per lo round
};

// Host: fill `prm`; false when an argument is out of range.
inline bool make_ns_params(int n, int init_spd, int lo, int hi, int split3,
                           int polish_highest, const float* two_c,
                           const float* c_sq, NSParams* prm) {
  if (n < 1 || n > kMaxN || lo < 0 || lo > kMaxRounds || hi < 0) return false;
  *prm = NSParams{};
  prm->n = n;
  prm->init_spd = init_spd;
  prm->lo = lo;
  prm->hi = hi;
  prm->split3 = split3;
  prm->polish_highest = polish_highest;
  for (int i = 0; i < lo; ++i) {
    prm->two_c[i] = two_c[i];
    prm->c_sq[i] = c_sq[i];
  }
  return true;
}

// Host: `prm` for the warm rounds, which take no recentering scalars
// (2c = 2, c^2 = 1 in every lo round) and always end on the fp32 residual;
// false when an argument is out of range.
inline bool make_warm_params(int n, int lo, int hi, int split3,
                             NSParams* prm) {
  float two[kMaxRounds], one[kMaxRounds];
  for (int i = 0; i < kMaxRounds; ++i) {
    two[i] = 2.f;
    one[i] = 1.f;
  }
  return make_ns_params(n, /*init_spd=*/0, lo, hi, split3,
                        /*polish_highest=*/1, two, one, prm);
}

// The register tile M (16M >= n) for a matrix dimension n <= kMaxN.
inline int ns_tile(int n) { return n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 4 : 8; }

enum Prec { kF32 = 0, kBF16 = 1, kSplit3 = 2 };

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[r][c] = sum_k P[ty+16r][k] * Q[k][tx+16c] over k < n, in the given
// product precision.  Rows/columns in the zero padding produce zeros.
template <int M, int PREC>
__device__ __forceinline__ void product(const float* __restrict__ P,
                                        const float* __restrict__ Q, int n,
                                        int ty, int tx, float (&acc)[M][M]) {
  constexpr int LD = 16 * M + 1;
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < n; ++k) {
    float p[M], q[M];
#pragma unroll
    for (int r = 0; r < M; ++r) p[r] = P[(ty + 16 * r) * LD + k];
#pragma unroll
    for (int c = 0; c < M; ++c) q[c] = Q[k * LD + tx + 16 * c];
    if (PREC == kF32) {
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], acc[r][c]);
    } else if (PREC == kBF16) {
#pragma unroll
      for (int r = 0; r < M; ++r) p[r] = bf(p[r]);
#pragma unroll
      for (int c = 0; c < M; ++c) q[c] = bf(q[c]);
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], acc[r][c]);
    } else {
      float pl[M], ql[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float h = bf(p[r]);
        pl[r] = bf(p[r] - h);  // the difference is exact in fp32
        p[r] = h;
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const float h = bf(q[c]);
        ql[c] = bf(q[c] - h);
        q[c] = h;
      }
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < M; ++c) {
          acc[r][c] = fmaf(p[r], q[c], acc[r][c]);
          acc[r][c] = fmaf(pl[r], q[c], acc[r][c]);
          acc[r][c] = fmaf(p[r], ql[c], acc[r][c]);
        }
    }
  }
}

template <int M>
__device__ __forceinline__ void product_prec(int prec, const float* P,
                                             const float* Q, int n, int ty,
                                             int tx, float (&acc)[M][M]) {
  if (prec == kF32)
    product<M, kF32>(P, Q, n, ty, tx, acc);
  else if (prec == kBF16)
    product<M, kBF16>(P, Q, n, ty, tx, acc);
  else
    product<M, kSplit3>(P, Q, n, ty, tx, acc);
}

// Max of v over the block (every thread gets the result).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// The cold-start seed X from A (spd or pan, prm.init_spd).  On entry sA
// holds A (zero outside the n x n block), sX is zero, and the block has
// passed a barrier since they were written; on return the same holds for
// the seeded sX.  `red` is kThreads / 32 floats of scratch.
template <int M>
__device__ __forceinline__ void ns_seed(const float* sA, float* sX,
                                        const NSParams& prm, float* red) {
  constexpr int LD = 16 * M + 1;
  const int n = prm.n;
  const int tid = threadIdx.x;

  float row = 0.f, col = 0.f;
  if (tid < n) {
    for (int j = 0; j < n; ++j) row += fabsf(sA[tid * LD + j]);
    for (int i = 0; i < n; ++i) col += fabsf(sA[i * LD + tid]);
  }
  const float r_inf = block_max(row, red);  // ||A||_inf
  const float c_1 = block_max(col, red);    // ||A||_1

  if (prm.init_spd) {
    const float s = 1.f / r_inf;
    const float two_s = 2.f * s;
    const float s2 = __fmul_rn(s, s);
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n, j = e % n;
      sX[i * LD + j] =
          __fsub_rn(i == j ? two_s : 0.f, __fmul_rn(s2, sA[i * LD + j]));
    }
  } else {
    const float scale = 1.f / __fmul_rn(r_inf, c_1);
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n, j = e % n;
      sX[i * LD + j] = __fmul_rn(sA[j * LD + i], scale);
    }
  }
  __syncthreads();
}

// The lo and hi rounds of the schedule, from whatever sX holds.  On entry
// sA holds A and sX the start X (both zero outside the n x n block), sT is
// zero, and the block has passed a barrier since they were written.  On
// return sX holds the refined inverse, and the block has passed a barrier
// since it was written.
template <int M>
__device__ __forceinline__ void ns_rounds(const float* sA, float* sX,
                                          float* sT, const NSParams& prm) {
  const int n = prm.n;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  constexpr int LD = 16 * M + 1;

  float acc[M][M];
  const int contract = prm.split3 ? kSplit3 : kBF16;
  for (int it = 0; it < prm.lo; ++it) {
    const float tc = prm.two_c[it];
    const float c2 = prm.c_sq[it];
    // T = 2c I - c^2 (A X); T is not an operand here, so write at once.
    product_prec<M>(contract, sA, sX, n, ty, tx, acc);
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        if (i < n && j < n)
          sT[i * LD + j] = __fsub_rn(i == j ? tc : 0.f, __fmul_rn(c2, acc[r][c]));
      }
    __syncthreads();
    // X = X T: all reads of X before the barrier, then the write.
    product_prec<M>(contract, sX, sT, n, ty, tx, acc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        if (i < n && j < n) sX[i * LD + j] = acc[r][c];
      }
    __syncthreads();
  }

  for (int it = 0; it < prm.hi; ++it) {
    const bool final_round = (it == prm.hi - 1) && prm.polish_highest;
    const int resid = (prm.split3 || final_round) ? kF32 : kSplit3;
    const int update = prm.split3 ? kSplit3 : kBF16;
    // R = I - A X
    product_prec<M>(resid, sA, sX, n, ty, tx, acc);
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        if (i < n && j < n)
          sT[i * LD + j] = __fsub_rn(i == j ? 1.f : 0.f, acc[r][c]);
      }
    __syncthreads();
    // X = X + X R
    product_prec<M>(update, sX, sT, n, ty, tx, acc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        if (i < n && j < n)
          sX[i * LD + j] = __fadd_rn(sX[i * LD + j], acc[r][c]);
      }
    __syncthreads();
  }
}

}  // namespace
