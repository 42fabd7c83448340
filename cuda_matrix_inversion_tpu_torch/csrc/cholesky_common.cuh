// Device code shared by K3, K4 (cholesky.cu) and K5, K10 (gp.cu): one
// right-looking Cholesky factorization of a matrix held in shared memory,
// and the inverse W = L^-1 of the factor (K3 and K10's emit_w variant).
//
// Arithmetic, column k (the JAX kernel's _cholesky_factor_body):
//   inv = 1 / sqrtf(K[k][k])      IEEE sqrt and a true division, never
//                                 rsqrtf (the TPU kernel avoids its
//                                 approximate rsqrt for the same reason)
//   L[i][k] = K[i][k] * inv       (i > k),  L[k][k] = K[k][k] * inv
//   K[i][j] -= L[i][k] * L[j][k]  (k < j <= i), the rank-1 trailing update
// Every update is spelled __fmul_rn / __fsub_rn (no FMA contraction), so
// the factor repeats the plain PyTorch version in ops/cuda_cholesky.py
// operation for operation.  A member that is not positive definite gives
// NaN (or inf) from its failing column on; other blocks are untouched.

#pragma once

#include <cuda_runtime.h>

namespace {

// Row stride of an n x n matrix in shared memory: odd, so the column reads
// (lanes on consecutive rows, one column) hit distinct banks.
__host__ __device__ __forceinline__ int chol_ld(int n) {
  return (n % 2 == 0) ? n + 1 : n;
}

// Factor the symmetric matrix in K (row stride ld; only the lower triangle
// is read) in place: on return the lower triangle holds L, the strict upper
// triangle is untouched.  The caller has passed a barrier since K was
// written; the function ends with one.  Two barriers per column.
__device__ __forceinline__ void chol_factor(float* K, int n, int ld) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  for (int k = 0; k < n; ++k) {
    const float akk = K[k * ld + k];
    const float inv = 1.0f / sqrtf(akk);
    for (int i = k + 1 + tid; i < n; i += nthreads)
      K[i * ld + k] = __fmul_rn(K[i * ld + k], inv);
    __syncthreads();
    // K[k][k] is read by no thread below, so it is written here.
    if (tid == 0) K[k * ld + k] = __fmul_rn(akk, inv);
    for (int i = k + 1 + warp; i < n; i += nwarps) {
      const float lik = K[i * ld + k];
      for (int j = k + 1 + lane; j <= i; j += 32)
        K[i * ld + j] = __fsub_rn(K[i * ld + j], __fmul_rn(lik, K[j * ld + k]));
    }
    __syncthreads();
  }
}

// W = L^-1 for the factor in the lower triangle of L (row stride ld), into
// W (row stride ld), zeros above the diagonal.  Thread j owns column j: the
// forward substitution of L w = e_j, in the order of the plain version
// (row k divided by L[k][k], then eliminated from the rows below), with no
// barrier inside.  The caller has passed a barrier since L was written and
// adds one before W is read by other threads.
__device__ __forceinline__ void chol_tri_inverse(const float* L, float* W,
                                                 int n, int ld) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    for (int i = 0; i < n; ++i) W[i * ld + j] = i == j ? 1.f : 0.f;
    for (int k = j; k < n; ++k) {
      const float wk = W[k * ld + j] / L[k * ld + k];
      W[k * ld + j] = wk;
      for (int i = k + 1; i < n; ++i)
        W[i * ld + j] = __fsub_rn(W[i * ld + j], __fmul_rn(L[i * ld + k], wk));
    }
  }
}

}  // namespace
