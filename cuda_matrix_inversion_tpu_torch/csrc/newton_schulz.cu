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
// while each matrix needs a chain of dependent 128^3 products (14 passes
// of the spd10 lane: 13 in bf16, one in fp32; 90 of the pan500 lane, 88 in
// bf16 and 2 in fp32).  Its bound is those operations, the bf16 passes at
// the tensor cores' rate and the fp32 ones at the CUDA cores'; inside one
// block they are a serial chain, 3 barriers a round, at one block an SM.
//
// What the design does about it: every schedule runs the round loop K1
// and K8 share with K6 and K11 (ns_mma_rounds.cuh): bf16 products on the
// tensor cores through mma.sync m16n8k16 from ldmatrix fragments
// (ns_mma.cuh), where a bf16 x bf16 product is exact in fp32, so they
// compute what the plain version's products compute up to the order of
// the sums; the 3-pass split as three MMAs into one accumulator; the fp32
// master X in the warps' accumulator fragments, published to shared memory
// as bf16 (and its lo part) once a round for both products; the fp32
// residuals on CUDA cores.  A goes in with 16-byte cp.async copies and is
// staged in fp32 (the fp32 residual, the split's parts) and, for the bf16
// schedules, as a bf16 tile; split3 keeps T's lo part in that tile's place
// and rounds A's two parts from the fp32 copy as they load: 200.5 KB at
// n = 128 either way, one block an SM.  K1 writes its seed straight into
// the fragments (spd: 2sI - s^2 A, s = 1/||A||_inf; pan:
// A^T / (||A||_1 ||A||_inf), read transposed from the fp32 copy; each norm
// a row or column sum in order by one thread, ns_common.cuh::ns_norms);
// K8 reads X0 from device memory straight into them while A's copies are
// in flight.  X goes out from the fp32 copy the loop leaves, in coalesced
// stores.
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
// with one more n^2 read (X0) than K1.

#include "ns_mma_rounds.cuh"

namespace {

// K1 (WARM = false) and K8 (WARM = true), bf16 (SPLIT3 = false) or split3
// schedules.
template <int M, bool WARM, bool SPLIT3>
__global__ void __launch_bounds__(kThreads)
    ns_mma_kernel(const float* __restrict__ a, const float* __restrict__ x0,
                  float* __restrict__ x, NSParams prm) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  using G = MmaGeometry<NP>;
  extern __shared__ __align__(16) unsigned char ns_smem[];
  __shared__ float red[kThreads / 32];
  const NsSmem<M, SPLIT3> sm(ns_smem);
  const int n = prm.n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  ns_load(sm, a + base, n);
  const WarpTile w = warp_tile<NP>();
  float xm[G::kMT][G::kNT][4];
  if constexpr (WARM) {
    if (w.active)
      tile_for_each(xm, w, [&](int i, int j, float& v) {
        v = (i < n && j < n) ? x0[base + i * n + j] : 0.f;
      });
  }
  ns_stage(sm, n, [](int, int, float v) { return v; });
  if constexpr (!WARM) {
    // The seed, straight into the fragments: s = 1/||A||_inf,
    // X = 2sI - s^2 A (spd) or A^T / (||A||_1 ||A||_inf) (pan).
    const float* sA = sm.A;
    float r_inf, c_1;
    ns_norms<M>(sA, n, red, r_inf, c_1);
    if (prm.init_spd) {
      const float s = 1.f / r_inf;
      const float two_s = 2.f * s;
      const float s2 = __fmul_rn(s, s);
      if (w.active)
        tile_for_each(xm, w, [&](int i, int j, float& v) {
          v = (i < n && j < n) ? __fsub_rn(i == j ? two_s : 0.f,
                                           __fmul_rn(s2, sA[i * LD + j]))
                               : 0.f;
        });
    } else {
      const float scale = 1.f / __fmul_rn(r_inf, c_1);
      if (w.active)
        tile_for_each(xm, w, [&](int i, int j, float& v) {
          v = (i < n && j < n) ? __fmul_rn(sA[j * LD + i], scale) : 0.f;
        });
    }
  }

  ns_mma_rounds<M, SPLIT3>(xm, sm, prm, w);
  float* xb = x + base;
  for (int e = threadIdx.x; e < n * n; e += kThreads)
    xb[e] = sm.Xf[(e / n) * LD + e % n];
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int batch, cudaStream_t stream,
                   const float* a, const float* x0, float* x,
                   const NSParams& prm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(a, x0, x, prm);
  return cudaGetLastError();
}

// K1 or K8 at the instance for prm.n and prm.split3.
template <int M, bool WARM>
cudaError_t launch_m(const NSParams& prm, int batch, cudaStream_t s,
                     const float* a, const float* x0, float* x) {
  const size_t smem = ns_smem_bytes(16 * M);
  return prm.split3
             ? launch(ns_mma_kernel<M, WARM, true>, smem, batch, s, a, x0, x,
                      prm)
             : launch(ns_mma_kernel<M, WARM, false>, smem, batch, s, a, x0, x,
                      prm);
}

template <bool WARM>
cudaError_t launch_ns(const NSParams& prm, int batch, cudaStream_t s,
                      const float* a, const float* x0, float* x) {
  switch (ns_tile(prm.n)) {
    case 1: return launch_m<1, WARM>(prm, batch, s, a, x0, x);
    case 2: return launch_m<2, WARM>(prm, batch, s, a, x0, x);
    case 4: return launch_m<4, WARM>(prm, batch, s, a, x0, x);
    default: return launch_m<8, WARM>(prm, batch, s, a, x0, x);
  }
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
  err = launch_ns<false>(prm, batch, static_cast<cudaStream_t>(stream), a,
                          nullptr, x);
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
  err = launch_ns<true>(prm, batch, static_cast<cudaStream_t>(stream), a,
                         x0, x);
  return static_cast<int>(err);
}
