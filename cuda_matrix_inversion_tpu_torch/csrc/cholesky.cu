// K4: batched lower Cholesky factor, and K3: batched SPD inverse through it,
// one thread block per matrix, for sm_90a.
//
// Replaces the TPU kernels cuda_matrix_inversion_tpu/ops/pallas_cholesky.py::
//   _chol_factor_kernel (pallas_call in cholesky)                        K4
//   _blocked_chol_inverse_kernel / _chol_inverse_kernel (pallas_call in
//   inverse_cholesky)                                                    K3
// K4 factors A = L L^T (cholesky_common.cuh) and writes L with zeros above
// the diagonal, for 1 <= n <= 256 as the JAX kernel does: up to 128 on the
// square layout, past it on the packed lower triangle
// (chol_factor_band_kernel, one block a matrix).  K3 factors in
// place, forms W = L^-1 by forward
// substitution into a second shared buffer, and writes A^-1 = W^T W, all in
// fp32 (the TPU kernel's products are Precision.HIGHEST).  Both triangles
// of A^-1 are written; the product is computed so that entry (i, j) and
// entry (j, i) take the same operations, so the output is exactly
// symmetric.  A member that is not positive definite comes out non-finite,
// the others are unaffected.
//
// What bounds it on the card: not bytes.  At 100 x 128 x 128 the kernel reads
// 6.55 MB and writes 6.55 MB (~4 us of HBM time).  The limit is the chain
// inside one block (cholesky_common.cuh): the factor's n pivots, each an
// IEEE sqrt and reciprocal on one warp (~134 clocks a step alone, up to
// 3.5x that beside busy tile warps), then W = L^-1's n dependent
// divisions down its first column, then the n^3 FMAs of W^T W on CUDA
// cores.  K4's band instance at 1600 x 256 writes 419 MB of L, ~10 us of
// each block's ~140 at 3.35 TB/s when every SM stores at once.
// What the design does about it: the matrix and W stay in shared memory for
// the whole chain (2 n ld fp32 with ld = chol_ld(n) = 132 at n = 128: 135
// KB, so one block per SM; K4 needs half and fits three; K4's packed
// instance takes 55, 78, 105 and 136 KB at n = 160, 192, 224 and 256, and
// two, two, two and one blocks an SM of 256 threads), rows on 16 bytes so
// every hot read is a float4 free of bank conflicts, and the matrix is
// loaded with several float4 reads in flight a thread.  The factor and W
// go by panels (cholesky_common.cuh): the chains run on one warp (the
// factor's diagonal blocks) or one thread a column (W's panel rows) while
// the other warps apply the previous panel from register tiles, so the
// barriers fall to two a panel for the factor and one for W.  Where one
// 512-thread block holds an SM, K4's band instance runs the band factor
// (its panel warp a panel ahead, two named-barrier hand-offs a panel);
// where two blocks share an SM the two-barrier factor measured faster and
// stays.  Either writes L after the factor as float4 rows.  Each of the 256
// threads keeps an M x M register tile of W^T W, so one shared-memory
// load feeds M FMAs.  None of the TPU kernel's workarounds (transposed
// factor, one-hot lane selects) is needed.  W^T W on tensor cores in an
// fp32-exact form, and more than one matrix per block, are later work.

#include <cuda_runtime.h>

#include "cholesky_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid over the W^T W output
constexpr int kMaxN = 128;      // K3, and K4's square instance
constexpr int kBandMaxN = 256;  // K4's packed instance, the JAX kernel's

__device__ __forceinline__ void load_matrix(const float* __restrict__ a,
                                            float* K, int n, int ld) {
  chol_load(a + static_cast<size_t>(blockIdx.x) * n * n, K, n, CholSquare{ld},
            [](int, int, float v) { return v; });
}

// At most 80 registers a thread, so three blocks (~67 KB each at n = 128)
// share an SM.
__global__ void __launch_bounds__(kThreads, 3)
    chol_factor_kernel(const float* __restrict__ a, float* __restrict__ l,
                       int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  load_matrix(a, smem, n, ld);
  __syncthreads();
  chol_factor(smem, n, CholSquare{ld});
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    l[base + e] = j <= i ? smem[i * ld + j] : 0.f;
  }
}

// K4 past n = 128 (129 <= n <= 256) on the packed lower triangle
// (cholesky_common.cuh::CholPacked, 136 KB at n = 256), the same bits.
// kBand (chol_band_plan): the band factor (chol_factor_band) on 512
// threads, one block an SM, a panel warp a panel ahead of the tile warps;
// else the two-barrier factor (chol_factor) on 256 threads, two blocks an
// SM (n <= 232, a batch past one block an SM), faster there.  At most 128
// registers a thread.  L after the factor goes out a row a warp: the
// float4s up to the one that holds the diagonal (its columns past the
// diagonal zeroed), zeros after it; single floats where the rows do not
// start on 16 bytes.
template <bool kBand>
__global__ void __launch_bounds__(chol_plan_threads(kBand),
                                  512 / chol_plan_threads(kBand))
    chol_factor_band_kernel(const float* __restrict__ a,
                            float* __restrict__ l, int n) {
  constexpr int T = chol_plan_threads(kBand);
  extern __shared__ __align__(16) float smem[];
  const CholPacked lay;
  float* out = l + static_cast<size_t>(blockIdx.x) * n * n;
  const int lane = threadIdx.x & 31;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(l) & 15) == 0;
  chol_load(a + static_cast<size_t>(blockIdx.x) * n * n, smem, n, lay,
            [](int, int, float v) { return v; });
  __syncthreads();
  if constexpr (kBand) {
    chol_factor_band<false>(smem, n);
  } else {
    chol_factor(smem, n, lay);
  }
  for (int i = threadIdx.x >> 5; i < n; i += T / 32) {
    const float* src = smem + lay.row(i);
    float* dst = out + static_cast<size_t>(i) * n;
    if (vec) {
      for (int q = lane; q < n / 4; q += 32) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q <= i) {
          v = *reinterpret_cast<const float4*>(src + 4 * q);
          if (4 * q + 1 > i) v.y = 0.f;
          if (4 * q + 2 > i) v.z = 0.f;
          if (4 * q + 3 > i) v.w = 0.f;
        }
        *reinterpret_cast<float4*>(dst + 4 * q) = v;
      }
    } else {
      for (int j = lane; j < n; j += 32) dst[j] = j <= i ? src[j] : 0.f;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    chol_inverse_kernel(const float* __restrict__ a, float* __restrict__ inv,
                        int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  float* L = smem;
  float* W = smem + n * ld;
  const int tid = threadIdx.x;
  load_matrix(a, L, n, ld);
  __syncthreads();
  chol_factor(L, n, CholSquare{ld});
  chol_tri_inverse(L, W, n, ld);  // W = L^-1 by row panels
  __syncthreads();

  // A^-1 = W^T W: acc[r][c] = sum_m W[m][i] W[m][j] with i = ty + 16r,
  // j = tx + 16c.  Both operands are rows of W; indices past n are clamped
  // (their outputs are not written).
  const int tx = tid % 16, ty = tid / 16;
  int ri[M], ci[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    ri[r] = min(ty + 16 * r, n - 1);
    ci[r] = min(tx + 16 * r, n - 1);
  }
  float acc[M][M];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) acc[r][c] = 0.f;
  for (int m = 0; m < n; ++m) {
    const float* row = W + m * ld;
    float p[M], q[M];
#pragma unroll
    for (int r = 0; r < M; ++r) p[r] = row[ri[r]];
#pragma unroll
    for (int c = 0; c < M; ++c) q[c] = row[ci[c]];
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], acc[r][c]);
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      if (i < n && j < n) inv[base + i * n + j] = acc[r][c];
    }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const float* a, float* out, int batch,
                   int n, size_t smem, cudaStream_t stream,
                   int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, threads, smem, stream>>>(a, out, n);
  return cudaGetLastError();
}

}  // namespace

// a, l: (batch, n, n) fp32, contiguous, on `device`; 1 <= n <= 256, one
// block a matrix (the square layout up to 128, the packed one past it).
// Returns the CUDA error of the launch.
extern "C" int cmi_chol_factor(const float* a, float* l, int batch, int n,
                               int device, void* stream) {
  if (n < 1 || n > kBandMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) {
    const CholBandPlan plan = chol_band_plan(n, batch, false, device);
    return static_cast<int>(
        plan.band ? launch(chol_factor_band_kernel<true>, a, l, batch, n,
                           plan.smem, s, plan.threads)
                  : launch(chol_factor_band_kernel<false>, a, l, batch, n,
                           plan.smem, s, plan.threads));
  }
  const size_t smem = static_cast<size_t>(n) * chol_ld(n) * sizeof(float);
  return static_cast<int>(launch(chol_factor_kernel, a, l, batch, n, smem,
                                 s));
}

// a, inv: (batch, n, n) fp32, contiguous, on `device`.  Returns the CUDA
// error of the launch.
extern "C" int cmi_chol_inverse(const float* a, float* inv, int batch, int n,
                                int device, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 2ull * n * chol_ld(n) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) err = launch(chol_inverse_kernel<1>, a, inv, batch, n, smem, s);
  else if (n <= 32) err = launch(chol_inverse_kernel<2>, a, inv, batch, n, smem, s);
  else if (n <= 64) err = launch(chol_inverse_kernel<4>, a, inv, batch, n, smem, s);
  else err = launch(chol_inverse_kernel<8>, a, inv, batch, n, smem, s);
  return static_cast<int>(err);
}
