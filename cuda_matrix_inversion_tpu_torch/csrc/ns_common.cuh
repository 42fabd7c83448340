// Device code of the Newton-Schulz kernels on CUDA cores, around the
// tensor-core round loop that K1, K8, K6 and K11 share
// (ns_mma_rounds.cuh): the round parameters, the fp32 shared-memory
// product of the fp32 residuals, the block maximum and the norms of the
// cold-start seed.  The seed and the rounds are separate, as the JAX
// package's ns_vmem_iterate and ns_vmem_rounds are: the warm kernels K8
// and K11 load X from a previous inverse and run the rounds alone, with the
// per-round scalars 2c = 2 and c^2 = 1 (no recentering: a scalar
// calibrated for a cold start would blow a converged start apart).
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

#pragma once

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

// acc[r][c] = sum_k P[ty+16r][k] * Q[k][tx+16c] over k < n in fp32, P and
// Q NP x NP (NP = 16M) fp32 blocks with the odd row stride NP + 1, so the
// column reads of P hit distinct banks.  Each of the 256 threads keeps an
// M x M register tile (rows ty + 16r, columns tx + 16c), so one
// shared-memory load feeds M FMAs.  Rows/columns in the zero padding
// produce zeros.
template <int M>
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
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], acc[r][c]);
  }
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

// ||A||_inf and ||A||_1 of the n x n block of sA (row stride 16M + 1),
// thread i summing row i and column i in order; every thread gets both.
// The block has passed a barrier since sA was written; `red` is
// kThreads / 32 floats of scratch.
template <int M>
__device__ __forceinline__ void ns_norms(const float* sA, int n, float* red,
                                         float& r_inf, float& c_1) {
  constexpr int LD = 16 * M + 1;
  const int tid = threadIdx.x;
  float row = 0.f, col = 0.f;
  if (tid < n) {
    for (int j = 0; j < n; ++j) row += fabsf(sA[tid * LD + j]);
    for (int i = 0; i < n; ++i) col += fabsf(sA[i * LD + tid]);
  }
  r_inf = block_max(row, red);
  c_1 = block_max(col, red);
}

}  // namespace
