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
// (scaled_round_coeffs, computed in double and rounded to fp32) in a
// device buffer the wrapper fills, so a schedule may take any number of lo
// rounds; the warm kernels pass none and run 2c = 2, c^2 = 1.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid over the output
constexpr int kMaxN = 128;
// Past kMaxN, up to the JAX kernels' ceiling, K1, K6, K8 and K11 run one
// thread-block cluster a matrix: the slab loop (ns_cluster_rounds.cuh, K8
// and K11) or the quadrant loop (ns_quad_rounds.cuh, K1 and K6).
constexpr int kBandMaxN = 224;

// The padded size NP of the cluster instances for 129 <= n <= 224.
inline int band_np(int n) { return n <= 160 ? 160 : n <= 192 ? 192 : 224; }

// CTAs an SM the cluster instances are built for (__launch_bounds__): two
// at NP = 160 for the bf16 schedules (at most 128 registers a thread),
// else one.
__host__ __device__ constexpr int band_ctas_per_sm(int np, bool split3) {
  return np == 160 && !split3 ? 2 : 1;
}

struct NSParams {
  int n;
  int init_spd;
  int lo;
  int hi;
  int split3;
  int polish_highest;
  const float* two_c;  // device: fp32(2c) per lo round; null: 2 every round
  const float* c_sq;   // device: fp32(c*c) per lo round; null: 1 every round
};

// Host: fill `prm`; false when an argument is out of range (n past
// `max_n`: the single-block kernels' kMaxN unless the caller serves more).
// two_c and c_sq are device arrays of `lo` floats, or both null for the
// unscaled rounds.
inline bool make_ns_params(int n, int init_spd, int lo, int hi, int split3,
                           int polish_highest, const float* two_c,
                           const float* c_sq, NSParams* prm,
                           int max_n = kMaxN) {
  if (n < 1 || n > max_n || lo < 0 || hi < 0 ||
      (two_c == nullptr) != (c_sq == nullptr))
    return false;
  *prm = NSParams{n, init_spd, lo, hi, split3, polish_highest, two_c, c_sq};
  return true;
}

// Host: `prm` for the warm rounds, which take no recentering scalars
// (2c = 2, c^2 = 1 in every lo round) and always end on the fp32 residual;
// false when an argument is out of range.
inline bool make_warm_params(int n, int lo, int hi, int split3,
                             NSParams* prm, int max_n = kMaxN) {
  return make_ns_params(n, /*init_spd=*/0, lo, hi, split3,
                        /*polish_highest=*/1, nullptr, nullptr, prm, max_n);
}

// Device: lo round r's scalars fp32(2c) and fp32(c^2).
__device__ __forceinline__ void round_scalars(const NSParams& prm, int r,
                                              float& two_c, float& c_sq) {
  two_c = prm.two_c ? __ldg(prm.two_c + r) : 2.f;
  c_sq = prm.c_sq ? __ldg(prm.c_sq + r) : 1.f;
}

// The register tile M (16M >= n) for a matrix dimension n <= kMaxN; 0
// past it, where no single-block instance exists.
inline int ns_tile(int n) {
  return n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 4 : n <= kMaxN ? 8 : 0;
}

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
