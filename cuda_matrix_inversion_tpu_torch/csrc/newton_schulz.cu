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
//
// Past n = 128, up to the JAX kernels' 224, K1 and K8 run as one
// thread-block cluster a matrix, each on its own loop.  K8
// (ns_band_kernel on ns_cluster_rounds.cuh, the slab loop): C = NP / 32
// CTAs (NP = 160, 192, 224) each iterate a 32-row slab, reading the right
// operand's other slabs from the peers' shared memory; K8's bound stays
// the operations (5 bf16 and 1 fp32 product of 2 NP^3 at the default bf16
// rounds), and the cluster adds a bulk copy of every peer's chunks to
// every CTA (87 KB a CTA a bf16 product at NP = 224) and two cluster
// barriers a round.  K1 (ns_quad_kernel on ns_quad_rounds.cuh, the
// quadrant loop): a 2 x 2 cluster of four CTAs, each holding one NP / 2
// quadrant of A, X and T; a product brings each CTA one quadrant of the
// left operand from its row peer and one of the right from its column peer
// (54 KB a bf16 product at NP = 224, for 5.6 MFLOP of MMA, three times the
// slab loop's work a byte received), and 30 matrices run at once at
// NP = 224 where the slab loop holds 15.  K1 seeds X over the cluster (quad_seed:
// row and column sums of each quadrant added with the peer's half, the
// maxima exchanged through the peers' shared memory).  The split3
// schedule accumulates the residuals in fp64 on both loops.  K1 spd10's
// bound: 13 bf16 products and 1 fp32 of 2 NP^3.

#include "ns_cluster_rounds.cuh"
#include "ns_mma_rounds.cuh"
#include "ns_quad_rounds.cuh"

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
    case 8: return launch_m<8, WARM>(prm, batch, s, a, x0, x);
    default: return cudaErrorInvalidValue;
  }
}

// K8 for 129 <= n <= 224: one cluster of C = NP / 32 CTAs a matrix,
// each refining its 32-row slab from x0 (ns_cluster_rounds.cuh).
template <int NP, bool SPLIT3>
__global__ void __launch_bounds__(kThreads, band_ctas_per_sm(NP, SPLIT3))
    ns_band_kernel(const float* __restrict__ a, const float* __restrict__ x0,
                   float* __restrict__ x, NSParams prm) {
  using G = BandGeometry<NP>;
  extern __shared__ __align__(16) unsigned char band_smem[];
  const BandSmem<NP, SPLIT3> sm(band_smem);
  const int n = prm.n;
  const int rank = cluster_rank();
  const size_t base = static_cast<size_t>(blockIdx.x / G::C) * n * n;
  const WarpTile w = band_warp_tile<NP>();
  float xm[1][G::NT][4];
  band_load_x<NP>(xm, x0 + base, n, rank, w);
  const float* ab = a + base;
  band_stage(sm, n, rank, [=](int i, int j) { return ab[i * n + j]; });
  band_rounds<NP, SPLIT3>(xm, sm, prm, w, rank);
  band_store_x(sm, x + base, n, rank);
}

template <int NP>
cudaError_t launch_band_np(const NSParams& prm, int batch, cudaStream_t s,
                           const float* a, const float* x0, float* x) {
  constexpr int C = BandGeometry<NP>::C;
  return prm.split3
             ? band_launch(ns_band_kernel<NP, true>, C, batch,
                           band_smem_bytes(NP, true), s, a, x0, x, prm)
             : band_launch(ns_band_kernel<NP, false>, C, batch,
                           band_smem_bytes(NP, false), s, a, x0, x, prm);
}

cudaError_t launch_band(const NSParams& prm, int batch, cudaStream_t s,
                        const float* a, const float* x0, float* x) {
  switch (band_np(prm.n)) {
    case 160: return launch_band_np<160>(prm, batch, s, a, x0, x);
    case 192: return launch_band_np<192>(prm, batch, s, a, x0, x);
    default: return launch_band_np<224>(prm, batch, s, a, x0, x);
  }
}

// K1 for 129 <= n <= 224: one 2 x 2 cluster of four CTAs a matrix, each
// iterating one NP / 2 quadrant (ns_quad_rounds.cuh), X seeded over the
// cluster (quad_seed).
template <int NP, bool SPLIT3>
__global__ void __launch_bounds__(kThreads, band_ctas_per_sm(NP, SPLIT3))
    ns_quad_kernel(const float* __restrict__ a, float* __restrict__ x,
                   NSParams prm) {
  extern __shared__ __align__(16) unsigned char quad_smem[];
  __shared__ float red[kThreads / 32];
  const QuadSmem<NP> sm(quad_smem);
  const QuadCta c;
  const int n = prm.n;
  const size_t base = static_cast<size_t>(blockIdx.x / kQuadCtas) * n * n;
  const QuadPlainA src{a + base, n};
  const WarpTile w = quad_warp_tile<NP>();
  float xm[1][QuadGeometry<NP>::NT][4];
  quad_stage<NP, SPLIT3>(sm, c, src, n, !prm.init_spd);
  quad_seed<NP>(xm, sm, c, n, prm.init_spd, red, w);
  quad_rounds<NP, SPLIT3>(xm, sm, prm, c, src, w);
  quad_store_x(sm, c, x + base, n);
}

// The instance at NP; *np_out = NP once it launched.
template <int NP>
cudaError_t launch_quad_np(const NSParams& prm, int batch, cudaStream_t s,
                           const float* a, float* x, int* np_out) {
  const size_t smem = quad_smem_bytes(NP);
  const cudaError_t err =
      prm.split3 ? cluster_launch(ns_quad_kernel<NP, true>, kQuadCtas, batch,
                                  kThreads, smem, s, a, x, prm)
                 : cluster_launch(ns_quad_kernel<NP, false>, kQuadCtas, batch,
                                  kThreads, smem, s, a, x, prm);
  if (err == cudaSuccess) *np_out = NP;
  return err;
}

cudaError_t launch_quad(const NSParams& prm, int batch, cudaStream_t s,
                        const float* a, float* x, int* np_out) {
  switch (band_np(prm.n)) {
    case 160: return launch_quad_np<160>(prm, batch, s, a, x, np_out);
    case 192: return launch_quad_np<192>(prm, batch, s, a, x, np_out);
    default: return launch_quad_np<224>(prm, batch, s, a, x, np_out);
  }
}

}  // namespace

// K1.  a, x: (batch, n, n) fp32, contiguous, on `device`, 1 <= n <= 224:
// one block a matrix up to 128, one 2 x 2 cluster a matrix past it.  two_c /
// c_sq: device arrays of `lo` fp32 scalars (any lo).  *quad_np (when not
// null): the padded size of the cluster instance launched, else 0.
// Returns the CUDA error of the launch (cudaErrorInvalidValue past 224).
extern "C" int cmi_ns_inverse(const float* a, float* x, int batch, int n,
                              int init_spd, int lo, int hi, int split3,
                              int polish_highest, const float* two_c,
                              const float* c_sq, int device, void* stream,
                              int* quad_np) {
  int np_launched = 0;
  if (quad_np == nullptr) quad_np = &np_launched;
  *quad_np = 0;
  NSParams prm;
  if (batch < 0 || (lo > 0 && two_c == nullptr) ||
      !make_ns_params(n, init_spd, lo, hi, split3, polish_highest, two_c,
                      c_sq, &prm, kBandMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = n <= kMaxN ? launch_ns<false>(prm, batch, s, a, nullptr, x)
                   : launch_quad(prm, batch, s, a, x, quad_np);
  return static_cast<int>(err);
}

// K8.  a, x0, x: (batch, n, n) fp32, contiguous, on `device`, 1 <= n <=
// 224: one block a matrix up to 128, one cluster a matrix past it.  `lo`
// unscaled rounds and `hi` polish rounds, one-pass bf16 products or
// (split3) the 3-pass split.  Returns the CUDA error of the launch
// (cudaErrorInvalidValue past 224).
extern "C" int cmi_ns_warm(const float* a, const float* x0, float* x,
                           int batch, int n, int lo, int hi, int split3,
                           int device, void* stream) {
  NSParams prm;
  if (batch < 0 ||
      !make_warm_params(n, lo, hi, split3, &prm, kBandMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = n <= kMaxN ? launch_ns<true>(prm, batch, s, a, x0, x)
                   : launch_band(prm, batch, s, a, x0, x);
  return static_cast<int>(err);
}
