// K1: fixed-schedule scaled Newton-Schulz batched inverse, and K8: its
// warm-start refinement, one thread block per matrix, for sm_90a.
//
// Replaces the TPU kernel cuda_matrix_inversion_tpu/ops/newton_schulz.py::
// ns_vmem_iterate / ns_vmem_rounds (pallas_call in
// inverse_newton_schulz_pallas), with the compiled-TPU semantics
// (mid_split=True):
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
// What bounds it on the card: not bytes.  At 100 x 128 x 128 the kernel reads
// A once (6.55 MB) and writes X once (6.55 MB), about 4 us of HBM time,
// while each matrix needs ~18 dependent 128^3 products (the spd lane).  The
// limit is that serial chain of products inside one block, at one block per
// SM (198 KB of shared memory each), on CUDA-core FMAs.
//
// What the design does about it: A, X and T stay in shared memory for the
// whole schedule, so device memory sees one read and one write per matrix
// (the point of the TPU kernel's VMEM residency).  Each of the 256 threads
// keeps an M x M register tile of the product (rows ty + 16r, columns
// tx + 16c), so one shared-memory load feeds M FMAs; the row stride is odd
// (16M + 1) so the column reads of the left operand hit distinct banks.
// Products into an operand (X = X T, X = X + X R) finish all reads before a
// barrier and only then write.  Tensor cores (mma.sync / wgmma) and
// splitting a matrix across blocks are later work.  The product routine,
// the seed and the round loop live in ns_common.cuh; its round loop now
// serves K1 and K8 only, since K6 and K11 (gp.cu) run theirs on the tensor
// cores (ns_mma.cuh), which K8's rounds can move onto next.
//
// K8 replaces cuda_matrix_inversion_tpu/ops/newton_schulz.py::
// _ns_warm_kernel (pallas_call in inverse_newton_schulz_warm): X is loaded
// from a previous inverse X0 of a nearby batch instead of seeded, then the
// same rounds run without recentering scalars (2c = 2, c^2 = 1): `lo`
// rounds X = X(2I - AX) and `hi` polish rounds, the last residual in fp32;
// bf16 one-pass products, or the 3-pass split for the split3 precision.
// Valid while the drift delta of A satisfies delta * kappa <~ 0.3 (bf16 also
// kappa <~ 30).  What bounds it: as K1, the serial chain of dependent
// products (2 x 2 + 2 at the default 2 + 1 rounds against K1 spd10's 12),
// with one more n^2 read (X0) than K1.  A, X and T live in shared memory
// (3 n (n+1) fp32, the K1 footprint), so n <= 128.

#include "ns_common.cuh"

namespace {

template <int M>
__global__ void __launch_bounds__(kThreads)
    ns_kernel(const float* __restrict__ a, float* __restrict__ x,
              NSParams prm) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  float* sA = smem;
  float* sX = sA + NP * LD;
  float* sT = sX + NP * LD;
  const int n = prm.n;
  const int tid = threadIdx.x;
  const float* ab = a + static_cast<size_t>(blockIdx.x) * n * n;
  float* xb = x + static_cast<size_t>(blockIdx.x) * n * n;

  // A into shared memory; every buffer's padding is zero and stays zero
  // (the identity terms are restricted to i < n), so the n x n block of
  // each product is exact.
  for (int e = tid; e < NP * NP; e += kThreads) {
    const int i = e / NP, j = e % NP;
    sA[i * LD + j] = (i < n && j < n) ? ab[i * n + j] : 0.f;
    sX[i * LD + j] = 0.f;
    sT[i * LD + j] = 0.f;
  }
  __syncthreads();

  ns_seed<M>(sA, sX, prm, red);
  ns_rounds<M>(sA, sX, sT, prm);

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    xb[i * n + j] = sX[i * LD + j];
  }
}

// K8: A and X0 into shared memory (zero padding, as in K1), the rounds, X
// out.
template <int M>
__global__ void __launch_bounds__(kThreads)
    ns_warm_kernel(const float* __restrict__ a, const float* __restrict__ x0,
                   float* __restrict__ x, NSParams prm) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sX = sA + NP * LD;
  float* sT = sX + NP * LD;
  const int n = prm.n;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  for (int e = tid; e < NP * NP; e += kThreads) {
    const int i = e / NP, j = e % NP;
    const bool in = i < n && j < n;
    sA[i * LD + j] = in ? a[base + i * n + j] : 0.f;
    sX[i * LD + j] = in ? x0[base + i * n + j] : 0.f;
    sT[i * LD + j] = 0.f;
  }
  __syncthreads();

  ns_rounds<M>(sA, sX, sT, prm);

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    x[base + e] = sX[i * LD + j];
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int m, int batch, cudaStream_t stream,
                   Args... args) {
  const size_t np = 16ull * m;
  const size_t smem = 3 * np * (np + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// a, x: (batch, n, n) fp32, contiguous, on `device`.  two_c / c_sq: host
// arrays of `lo` fp32 scalars.  Returns the CUDA error of the launch.
extern "C" int cmi_ns_inverse(const float* a, float* x, int batch, int n,
                              int init_spd, int lo, int hi, int split3,
                              int polish_highest, const float* two_c,
                              const float* c_sq, int device, void* stream) {
  NSParams prm;
  if (batch < 0 || !make_ns_params(n, init_spd, lo, hi, split3,
                                   polish_highest, two_c, c_sq, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns_tile(n)) {
    case 1: err = launch(ns_kernel<1>, 1, batch, s, a, x, prm); break;
    case 2: err = launch(ns_kernel<2>, 2, batch, s, a, x, prm); break;
    case 4: err = launch(ns_kernel<4>, 4, batch, s, a, x, prm); break;
    default: err = launch(ns_kernel<8>, 8, batch, s, a, x, prm); break;
  }
  return static_cast<int>(err);
}

// K8.  a, x0, x: (batch, n, n) fp32, contiguous, on `device`.  `lo` unscaled
// rounds and `hi` polish rounds, one-pass bf16 products or (split3) the
// 3-pass split.  Returns the CUDA error of the launch.
extern "C" int cmi_ns_warm(const float* a, const float* x0, float* x,
                           int batch, int n, int lo, int hi, int split3,
                           int device, void* stream) {
  NSParams prm;
  if (batch < 0 || !make_warm_params(n, lo, hi, split3, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns_tile(n)) {
    case 1: err = launch(ns_warm_kernel<1>, 1, batch, s, a, x0, x, prm); break;
    case 2: err = launch(ns_warm_kernel<2>, 2, batch, s, a, x0, x, prm); break;
    case 4: err = launch(ns_warm_kernel<4>, 4, batch, s, a, x0, x, prm); break;
    default: err = launch(ns_warm_kernel<8>, 8, batch, s, a, x0, x, prm); break;
  }
  return static_cast<int>(err);
}
