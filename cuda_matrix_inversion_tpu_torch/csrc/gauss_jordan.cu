// K7: batched Gauss-Jordan inverse with partial pivoting, one thread block
// per matrix, for sm_90a.
//
// Replaces the TPU kernel cuda_matrix_inversion_tpu/ops/pallas_gauss_jordan.py::
// _gauss_jordan_kernel (pallas_call in inverse_gauss_jordan).  The TPU kernel
// keeps [A | I] transposed (2 n^2 fp32) and never moves a row, because Mosaic
// cannot index lanes dynamically: it pivots among the unused rows, records
// the pivot rows and applies the permutation at the end as a one-hot matmul.
// Shared memory indexes freely, so this kernel runs the classical in-place
// Gauss-Jordan with partial pivoting on one n x n buffer.  Step k:
//   p       first maximum of |W[i][k]| over rows i >= k (exactly the TPU
//           kernel's unused rows), found by one warp with shuffles
//   f[i]    column k of every row i != k, as it stands after the swap
//   swap    rows k and p; then row k = (row k with W[k][k] := 1) * (1 / pivot)
//   update  W[i][j] = (j == k ? 0 : W[i][j]) - f[i] * W[k][j] for i != k
// and at the end the column swaps (k, p_k) are undone in reverse order as a
// gather on the way out.  The division is IEEE (1 / pivot), every update is
// spelled __fmul_rn / __fsub_rn, so the plain PyTorch version in
// ops/cuda_gauss_jordan.py repeats the kernel operation for operation.  A
// zero pivot gives inf / NaN in that matrix alone.  The wrapper adds the JAX
// wrapper's fp32 Newton polish (two cuBLAS products) after the kernel.
//
// What bounds it on the card: not bytes (one read and one write of n^2 fp32
// per matrix, 13 MB at 100 x 128 x 128, ~4 us of HBM time).  The n steps run
// in series, each with three block barriers around an n^2 rank-1 update, so
// the limit is that chain of barriers and the n^3 fp32 FMAs on CUDA cores.
// What the design does about it: the matrix lives in shared memory for the
// whole factorization (n (n+1) fp32 with an odd row stride, so the pivot
// column reads hit distinct banks: 148 KB at n = 192, the JAX kernel's
// ceiling, which needs the opt-in attribute); the update maps warps to rows
// and lanes to columns, so each warp reads the pivot row and writes its own
// row on consecutive addresses.  Several matrices per block at small n and
// a register-tiled update are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 192;

// Odd row stride, so a warp reading one column hits distinct banks.
__host__ __device__ __forceinline__ int gj_ld(int n) {
  return (n % 2 == 0) ? n + 1 : n;
}

__global__ void __launch_bounds__(kThreads)
    gauss_jordan_kernel(const float* __restrict__ a, float* __restrict__ inv,
                        int n) {
  extern __shared__ float smem[];
  __shared__ float s_inv;
  __shared__ int s_p;
  const int ld = gj_ld(n);
  float* W = smem;                              // n x n, row stride ld
  float* f = W + n * ld;                        // column-k multipliers
  int* piv = reinterpret_cast<int*>(f + n);     // pivot row of each step
  int* src = piv + n;                           // source column of each output
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  for (int i = warp; i < n; i += kWarps)
    for (int j = lane; j < n; j += 32) W[i * ld + j] = a[base + i * n + j];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      // first maximum of |W[i][k]| over i >= k; a strict comparison keeps
      // the lowest row of each lane, the shuffle prefers the lower row on a
      // tie.  A column of NaN leaves p = k (the matrix is lost either way).
      float best = -1.f;
      int bi = n;
      for (int i = k + lane; i < n; i += 32) {
        const float v = fabsf(W[i * ld + k]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int p = bi < n ? bi : k;
      for (int i = lane; i < n; i += 32)
        f[i] = i == p ? W[k * ld + k] : W[i * ld + k];
      if (lane == 0) {
        s_p = p;
        piv[k] = p;
        s_inv = 1.f / W[p * ld + k];
      }
    }
    __syncthreads();
    // swap rows k and p, and scale the pivot row
    const int p = s_p;
    const float r = s_inv;
    for (int j = tid; j < n; j += kThreads) {
      const float t = W[p * ld + j];
      if (p != k) W[p * ld + j] = W[k * ld + j];
      W[k * ld + j] = __fmul_rn(j == k ? 1.f : t, r);
    }
    __syncthreads();
    // eliminate column k from every other row
    for (int i = warp; i < n; i += kWarps) {
      if (i == k) continue;
      const float fi = f[i];
      for (int j = lane; j < n; j += 32)
        W[i * ld + j] = __fsub_rn(j == k ? 0.f : W[i * ld + j],
                                  __fmul_rn(fi, W[k * ld + j]));
    }
    __syncthreads();
  }

  // undo the column swaps in reverse order: output column j is W's column
  // src[j]
  if (tid == 0) {
    for (int j = 0; j < n; ++j) src[j] = j;
    for (int k = n - 1; k >= 0; --k) {
      const int p = piv[k];
      const int t = src[k];
      src[k] = src[p];
      src[p] = t;
    }
  }
  __syncthreads();
  for (int i = warp; i < n; i += kWarps)
    for (int j = lane; j < n; j += 32)
      inv[base + i * n + j] = W[i * ld + src[j]];
}

}  // namespace

// a, inv: (batch, n, n) fp32, contiguous, on `device`; 1 <= n <= 192.
// Returns the CUDA error of the launch.
extern "C" int cmi_gauss_jordan(const float* a, float* inv, int batch, int n,
                                int device, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      (static_cast<size_t>(n) * gj_ld(n) + n) * sizeof(float) +
      2ull * n * sizeof(int);
  err = cudaFuncSetAttribute(gauss_jordan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gauss_jordan_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a, inv, n);
  return static_cast<int>(cudaGetLastError());
}
