// K5, K6 and K11: the fused GP mean/variance, and K10: the fused log
// marginal likelihood, one thread block per system, for sm_90a.  For every
// system of the batch, with K = B + diag(c),
//     mean = a^T K^-1 d,    var = e - a^T K^-1 a,
// and only those two floats are written, so device memory sees B read once.
//
// K5 replaces cuda_matrix_inversion_tpu/ops/pallas_gp.py::_gp_kernel
// (pallas_call in gp_mean_variance_fused).  It stages K while loading B,
// factors it in place (cholesky_common.cuh), and forward-solves
// L [y_d y_a] = [d a]; then mean = y_a . y_d and var = e - y_a . y_a.  The
// TPU kernel builds the whole W = L^-1 and multiplies rows by it because the
// TPU wants MXU matmuls; two right-hand sides cost O(n^2) after the
// O(n^3 / 3) factor, so K5 never forms W.  Past n = 128, up to the JAX
// kernel's 256, K5 runs on the packed lower triangle (gp_chol_band_kernel).
// Where one 512-thread block holds an SM, d^T and a^T are bordered below it
// as rows n and n + 1 (cholesky_common.cuh::CholBand<true>): the band
// factor carries them as rows of the factor, dividing by L[k][k] where L's
// rows multiply by inv_k, so y_d and y_a come out of it with the forward
// substitution's bits and no substitution runs after it (138 KB at 256).
// Where two 256-thread blocks share an SM the substitutions after the
// factor stay: the other block's work hides them.

// K6 replaces ops/pallas_gp.py::_gp_ns_kernel (pallas_call in
// gp_mean_variance_fused_ns).  It loads B with asynchronous copies, stages K,
// seeds X1 = 2sI - s^2 K (K1's spd seed, s = 1/||K||_inf) and runs the
// spd schedule the host resolves (resolve_schedule(init="spd"): 6 lo rounds
// at mu_min 0.01, then 2 polish rounds), then x = [d a] X in fp32,
// mean = x_d . a and var = e - x_a . a.  Its 16 dependent products are 18
// n^3 passes: 17 in bf16 (the 12 of the lo rounds, the 3 of the split
// residual of the first polish round, and both polish updates X + X R) and
// one in fp32.  The rounds are the loop K1 and K8 share
// (ns_mma_rounds.cuh): the bf16 passes on the tensor cores (ns_mma.cuh:
// mma.sync m16n8k16 bf16 -> fp32 from ldmatrix fragments), where a
// bf16 x bf16 product is exact in fp32, so they compute what the plain
// version's one-pass products compute up to the order of the sums; the
// last residual R = I - K X true fp32 on CUDA cores
// (ns_common.cuh::product).  Never TF32: the schedule's scalars
// were calibrated for bf16 rounding.
//
// What bounds K5 and K6 on the card: not bytes (one read of B, 6.55 MB at
// 100 x 128 x 128).  K5 is the factor's chain (cholesky_common.cuh: one
// warp's n pivots of an IEEE sqrt and reciprocal, slowed by the issue
// slots of the warps beside it), then, up to n = 128, n warp-synchronous
// substitution steps; its n ld + 2n fp32 of shared memory (68.6 KB at n =
// 128, ld = chol_ld(n) = 132) and at most 80 registers a thread let three
// blocks share an SM.  Past 128, where one block holds an SM, the
// substitutions are gone (the border) and the chain is the band factor's:
// the panel warp's pivots and the tile warps' tiles around it.  K6's
// bound is its operations: 17 bf16 passes at the tensor cores' rate and
// the one fp32 product at the CUDA cores', which is half of it.  Inside the
// block it is a chain of dependent products, 3 barriers a round.
// What the design does about it: everything stays in shared memory or
// registers from the load of B to the two scalars.  K5's two substitutions
// run on two warps with no block barrier (or, on the band where one block
// holds an SM, inside the factor), and its dot products are warp reductions.  K6 keeps the fp32 master X
// in the warps' accumulator fragments and publishes bf16(X) to shared
// memory once a round
// (ns_mma_rounds.cuh); K stays in shared memory in fp32 for the fp32
// residual and the split's lo part, and as a bf16 copy for the one-pass
// products.  Shared memory at n = 128: K 66 KB, four bf16 tiles (K, X,
// T or R, X's lo part) 34 KB each, with X in fp32 over the last two where
// needed, then [d a]: 201.5 KB, one block an SM.  Several systems per
// block and wgmma are later work.  Past n = 128, up to the JAX kernel's
// 224, K6 runs as one 2 x 2 thread-block cluster a system
// (gp_ns_quad_kernel on ns_quad_rounds.cuh, K1's quadrant loop): K1's spd
// seed taken over the cluster (quad_seed), the spd schedule's rounds, and
// an epilogue that sums each quadrant's part (quad_gp_epilogue).
//
// K11 replaces ops/pallas_gp.py::_gp_warm_kernel (pallas_call in
// gp_mean_variance_fused_warm): K6 with X loaded from the previous
// timestep's K^-1 instead of seeded, K8's unscaled rounds (2 + 1 by
// default: 2c = 2, c^2 = 1), the same fp32 epilogue, and the refined X
// written back so the caller can chain it into the next timestep.  It runs
// K6's staging and the shared round loop (ns_mma_rounds.cuh: bf16 products
// on the tensor cores, the last residual in fp32 on CUDA cores) in K6's shared
// memory, 201.5 KB at n = 128, one block an SM; X0 goes from device memory
// straight into the accumulator fragments while B's copies are in flight.
// Device memory sees B and X0 read and X written once; the chain of
// products is 6 instead of K6's 16.  Past n = 128, up to the JAX kernel's
// 224, K11 runs as one thread-block cluster a system (gp_warm_band_kernel
// on ns_cluster_rounds.cuh, K8's band loop): each of the C = NP / 32 CTAs
// stages its 32-row slab of K, refines it, sums the epilogue over its rows
// and writes its rows of K^-1; rank 0 adds the C partial sums in order.
//
// K10 replaces ops/pallas_gp.py::_gp_lml_kernel (pallas_call in
// _lml_fused_quad_logdet): per system quad = d^T K^-1 d and
// logdet = 2 sum_k log L[k][k].  Without emit_w it factors K (the shared
// chol_factor) and one warp forward-solves y = L^-1 d as K5 does,
// quad = y . y; n ld + 2n fp32 of shared memory (ld = chol_ld(n), 132 at
// n = 128).  With emit_w (the autograd forward) it also forms W = L^-1 by
// K3's row-panel substitution (chol_tri_inverse), t = W d (thread i owns
// row i), alpha = W^T t = K^-1 d (thread j owns column j), quad = t . t,
// and writes W and alpha for the backward; 2 n ld + 2n fp32.  Bound as K5
// and K3: the panel factor's chain of pivots, then (with emit_w) W's chain
// of divisions.  Without emit_w three blocks share an SM (at most 80
// registers a thread), with it one.  Past n = 128, up to the JAX kernel's
// 256, both variants run on the packed lower triangle (gp_lml_band_kernel,
// 256 or 512 threads a block by chol_band_threads): with emit_w, W = L^-1
// replaces L in place, right-looking by 8-row panels: one thread a column
// finishes a panel's rows while every warp applies the previous panel to
// the rows below from register tiles whose L operand was saved to a strip
// (cholesky_common.cuh::chol_tri_inverse_in_place), and L's diagonal is
// kept aside for log|K| (143.5 KB at 256, 138 KB without emit_w).  There
// t, alpha, quad and log|K| are summed in the plain version's order (a
// rounded product, then a rounded sum), so every output repeats it bit for
// bit.

#include <cuda_runtime.h>

#include "cholesky_common.cuh"
#include "ns_cluster_rounds.cuh"
#include "ns_common.cuh"
#include "ns_mma_rounds.cuh"
#include "ns_quad_rounds.cuh"

namespace {

// Largest n of K5 and K10 (one block a system; the packed layout past
// kMaxN), the JAX kernels' ceiling.
constexpr int kCholMaxN = 256;

// Sum of v over the block (every thread gets the result).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r += red[w];
  __syncthreads();
  return r;
}

// K5's body on the layout lay, T threads a block: K in shared memory at
// K, Y (2n floats) after it.
template <int T, typename Lay>
__device__ __forceinline__ void gp_chol_body(
    float* K, float* Y, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ d, const float* __restrict__ e,
    float* __restrict__ out, int n, Lay lay) {
  // Y[0..n) = y_d, Y[n..2n) = y_a
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const float* bs = b + sys * n * n;
  const float* cs = c + sys * n;
  chol_load(bs, K, n, lay, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;  // as gp_ns_stage_k rounds it
  });
  for (int i = tid; i < n; i += T) {
    Y[i] = d[sys * n + i];
    Y[n + i] = a[sys * n + i];
  }
  __syncthreads();
  chol_factor(K, n, lay);

  if (warp < 2) {
    // L y = rhs, one warp per right-hand side, in the plain version's
    // order: y[k] /= L[k][k], then eliminated from the rows below.
    float* y = Y + warp * n;
    for (int k = 0; k < n; ++k) {
      const float yk = y[k] / K[lay.row(k) + k];
      __syncwarp();
      if (lane == 0) y[k] = yk;
      for (int i = k + 1 + lane; i < n; i += 32)
        y[i] = __fsub_rn(y[i], __fmul_rn(K[lay.row(i) + k], yk));
      __syncwarp();
    }
  }
  __syncthreads();
  if (warp < 2) {
    // warp 0: y_a . y_d (the mean), warp 1: y_a . y_a
    const float* u = Y + warp * n;
    const float* ya = Y + n;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s = fmaf(ya[i], u[i], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[2 * sys + warp] = warp == 0 ? s : e[sys] - s;
  }
}

// K5's body where one block holds an SM past n = 128 (512 threads): d and
// a bordered below the packed triangle as rows n and n + 1
// (CholBand<true>), which the band factor turns into y_d and y_a, then
// gp_chol_body's two dot products.
template <int T>
__device__ __forceinline__ void gp_chol_border_body(
    float* K, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ d,
    const float* __restrict__ e, float* __restrict__ out, int n) {
  const CholBand<true> lay{n};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const float* bs = b + sys * n * n;
  const float* cs = c + sys * n;
  chol_load(bs, K, n, lay, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;  // as gp_ns_stage_k rounds it
  });
  float* yd = K + lay.row(n);
  float* ya = K + lay.row(n + 1);
  for (int i = tid; i < n; i += T) {
    yd[i] = d[sys * n + i];
    ya[i] = a[sys * n + i];
  }
  __syncthreads();
  chol_factor_band<true>(K, n);  // ends with a barrier
  if (warp < 2) {
    // warp 0: y_a . y_d (the mean), warp 1: y_a . y_a
    const float* u = warp == 0 ? yd : ya;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s = fmaf(ya[i], u[i], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[2 * sys + warp] = warp == 0 ? s : e[sys] - s;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    gp_chol_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ d,
                   const float* __restrict__ e, float* __restrict__ out,
                   int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  gp_chol_body<kThreads>(smem, smem + n * ld, a, b, c, d, e, out, n,
                         CholSquare{ld});
}

// K5 past n = 128 (129 <= n <= 256) on the packed lower triangle.  kBand
// (chol_band_plan: 512 threads, one block an SM): d and a bordered below
// the triangle and carried through the band factor (gp_chol_border_body,
// cholesky_common.cuh::CholBand<true>, chol_band_floats: 138 KB at n =
// 256).  Else (256 threads, two blocks an SM: n <= 224, a batch past one
// block an SM): gp_chol_body on
// CholPacked, the two-barrier factor and then the two one-warp
// substitutions from Y after the triangle, which the other block's work
// hides (faster there than the border, which puts 8 divisions a panel on
// the factor's chain).  At most 128 registers a thread.
template <bool kBand>
__global__ void __launch_bounds__(chol_plan_threads(kBand),
                                  512 / chol_plan_threads(kBand))
    gp_chol_band_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ c,
                        const float* __restrict__ d,
                        const float* __restrict__ e, float* __restrict__ out,
                        int n) {
  constexpr int T = chol_plan_threads(kBand);
  extern __shared__ __align__(16) float smem[];
  if constexpr (kBand) {
    gp_chol_border_body<T>(smem, a, b, c, d, e, out, n);
  } else {
    gp_chol_body<T>(smem, smem + chol_packed_floats(n), a, b, c, d, e, out,
                    n, CholPacked{});
  }
}

// The fp32 epilogue of K6 and K11 from X ~= K^-1 in sX and sv = [d a]:
// x_d[j] = sum_i d[i] X[i][j] and x_a likewise (thread j), then
// mean = x_d . a and var = e - x_a . a into out[0], out[1].  The block has
// passed a barrier since sX was written.
template <int M>
__device__ __forceinline__ void ns_gp_epilogue(const float* sX,
                                               const float* sv, int n,
                                               float e, float* out,
                                               float* red) {
  constexpr int LD = 16 * M + 1;
  const int tid = threadIdx.x;
  float mean_part = 0.f, quad_part = 0.f;
  if (tid < n) {
    float xd = 0.f, xa = 0.f;
    for (int i = 0; i < n; ++i) {
      const float xij = sX[i * LD + tid];
      xd = fmaf(sv[i], xij, xd);
      xa = fmaf(sv[n + i], xij, xa);
    }
    mean_part = __fmul_rn(xd, sv[n + tid]);
    quad_part = __fmul_rn(xa, sv[n + tid]);
  }
  const float mean = block_sum(mean_part, red);
  const float quad = block_sum(quad_part, red);
  if (tid == 0) {
    out[0] = mean;
    out[1] = e - quad;
  }
}

// Start reading system `sys`: B with asynchronous copies into sm.stage, and
// [d a] into sm.rest.  gp_ns_stage_k waits for the copies.
template <int M>
__device__ __forceinline__ void gp_ns_load_b(const NsSmem<M>& sm,
                                             const float* a, const float* bs,
                                             const float* d, size_t sys,
                                             int n) {
  ns_load(sm, bs, n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm.rest[i] = d[sys * n + i];
    sm.rest[n + i] = a[sys * n + i];
  }
}

// K = B + diag(c), zero padded to NP, in fp32 (sm.A) and bf16 (sm.Ah), once
// B has arrived, with K[i][i] = B[i][i] + c[i] as the plain version's
// b + eye * c rounds it; the block has passed a barrier when it returns.
template <int M>
__device__ __forceinline__ void gp_ns_stage_k(const NsSmem<M>& sm,
                                              const float* cs, int n) {
  ns_stage(sm, n, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;
  });
}

// K6.  The fp32 master X lives in the warps' accumulator fragments (xm).
template <int M>
__global__ void __launch_bounds__(kThreads)
    gp_ns_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ d,
                 const float* __restrict__ e, float* __restrict__ out,
                 NSParams prm) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  using G = MmaGeometry<NP>;
  extern __shared__ __align__(16) unsigned char gp_ns_smem[];
  __shared__ float red[kThreads / 32];
  const NsSmem<M> sm(gp_ns_smem);
  const float* sK = sm.A;
  const int n = prm.n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t sys = blockIdx.x;

  // B, read once, with asynchronous copies; then K = B + diag(c), zero
  // padded to NP, in fp32 and bf16.
  gp_ns_load_b<M>(sm, a, b + sys * n * n, d, sys, n);
  gp_ns_stage_k<M>(sm, c + sys * n, n);

  // The spd seed X1 = 2sI - s^2 K, s = 1/||K||_inf (K1's seed, the row
  // sums a warp each), straight into the fragments.
  float rmax = 0.f;
  for (int i = tid >> 5; i < n; i += kThreads / 32) {
    float r = 0.f;
    for (int j = lane; j < n; j += 32) r += fabsf(sK[i * LD + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    rmax = fmaxf(rmax, r);
  }
  const float s_inv = 1.f / block_max(rmax, red);
  const float two_s = 2.f * s_inv;
  const float s2 = __fmul_rn(s_inv, s_inv);
  const WarpTile w = warp_tile<NP>();
  float xm[G::kMT][G::kNT][4];
  if (w.active)
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      v = (i < n && j < n)
              ? __fsub_rn(i == j ? two_s : 0.f, __fmul_rn(s2, sK[i * LD + j]))
              : 0.f;
    });

  ns_mma_rounds<M>(xm, sm, prm, w);
  ns_gp_epilogue<M>(sm.Xf, sm.rest, n, e[sys], out + 2 * sys, red);
}

// K11: K6 with X loaded from x0 instead of seeded, and the refined X written
// to kinv.  X0 goes from device memory straight into the fragments while
// B's asynchronous copies are in flight.
template <int M>
__global__ void __launch_bounds__(kThreads)
    gp_warm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ d,
                   const float* __restrict__ e, const float* __restrict__ x0,
                   float* __restrict__ out, float* __restrict__ kinv,
                   NSParams prm) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  using G = MmaGeometry<NP>;
  extern __shared__ __align__(16) unsigned char gp_ns_smem[];
  __shared__ float red[kThreads / 32];
  const NsSmem<M> sm(gp_ns_smem);
  const int n = prm.n;
  const size_t sys = blockIdx.x;
  const float* xs = x0 + sys * n * n;

  gp_ns_load_b<M>(sm, a, b + sys * n * n, d, sys, n);
  const WarpTile w = warp_tile<NP>();
  float xm[G::kMT][G::kNT][4];
  if (w.active)
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      v = (i < n && j < n) ? xs[i * n + j] : 0.f;
    });
  gp_ns_stage_k<M>(sm, c + sys * n, n);

  ns_mma_rounds<M>(xm, sm, prm, w);
  ns_gp_epilogue<M>(sm.Xf, sm.rest, n, e[sys], out + 2 * sys, red);
  float* ks = kinv + sys * n * n;
  for (int x = threadIdx.x; x < n * n; x += kThreads)
    ks[x] = sm.Xf[(x / n) * LD + x % n];
}

// K11's band instance (129 <= n <= 224): [d a] of system
// `sys` into sm.rest, d at [0, NP) and a at [NP, 2 NP).
template <int NP>
__device__ __forceinline__ void band_gp_load_da(const BandSmem<NP, false>& sm,
                                                const float* a,
                                                const float* d, size_t sys,
                                                int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm.rest[i] = d[sys * n + i];
    sm.rest[NP + i] = a[sys * n + i];
  }
}

// The slab of K = B + diag(c) (bs, cs: the system's B and c), with
// K[i][i] = B[i][i] + c[i] as the plain version's b + eye * c rounds it.
template <int NP>
__device__ __forceinline__ void band_gp_stage_k(const BandSmem<NP, false>& sm,
                                                const float* bs,
                                                const float* cs, int n,
                                                int rank) {
  band_stage(sm, n, rank, [=](int i, int j) {
    const float v = bs[i * n + j];
    return i == j ? __fadd_rn(v, cs[i]) : v;
  });
}

// K11's band epilogue from the slab of X in sm.Xf and [d a] in
// sm.rest: each CTA sums over its rows x_d[j] = sum_i d[i] X[i][j] and x_a
// likewise (thread j) into the partials mean_s = x_d . a and
// quad_s = x_a . a, and stores them in rank 0's partials (sm.rest at
// 2 NP); rank 0 adds the C partials in rank order into out[0] = mean and
// out[1] = *e - quad, so two runs give the same bits.  The cluster has
// passed a barrier since sm.Xf was written.
template <int NP>
__device__ __forceinline__ void band_gp_epilogue(
    const BandSmem<NP, false>& sm, int n, int rank, const float* e,
    float* out, float* red) {
  using G = BandGeometry<NP>;
  const int tid = threadIdx.x;
  const float* sd = sm.rest;
  const float* sa = sm.rest + NP;
  float* partials = sm.rest + 2 * NP;
  const int rows = min(kSlab, n - kSlab * rank);
  float mean_part = 0.f, quad_part = 0.f;
  if (tid < n) {
    float xd = 0.f, xa = 0.f;
    for (int i = 0; i < rows; ++i) {
      const float xij = sm.Xf[i * G::LDF + tid];
      xd = fmaf(sd[kSlab * rank + i], xij, xd);
      xa = fmaf(sa[kSlab * rank + i], xij, xa);
    }
    mean_part = __fmul_rn(xd, sa[tid]);
    quad_part = __fmul_rn(xa, sa[tid]);
  }
  const float mean_s = block_sum(mean_part, red);
  const float quad_s = block_sum(quad_part, red);
  if (tid == 0) {
    st_peer_f32(peer_addr(partials + 2 * rank, 0), mean_s);
    st_peer_f32(peer_addr(partials + 2 * rank + 1, 0), quad_s);
  }
  cluster_sync();
  if (rank == 0 && tid == 0) {
    float mean = 0.f, quad = 0.f;
    for (int r = 0; r < G::C; ++r) {
      mean += partials[2 * r];
      quad += partials[2 * r + 1];
    }
    out[0] = mean;
    out[1] = *e - quad;
  }
}

// K11 for 129 <= n <= 224: one cluster of C = NP / 32 CTAs a system, each
// refining a 32-row slab of X (ns_cluster_rounds.cuh) from x0, then
// band_gp_epilogue and the slab's rows of K^-1.
template <int NP>
__global__ void __launch_bounds__(kThreads, band_ctas_per_sm(NP, false))
    gp_warm_band_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ c,
                        const float* __restrict__ d,
                        const float* __restrict__ e,
                        const float* __restrict__ x0,
                        float* __restrict__ out, float* __restrict__ kinv,
                        NSParams prm) {
  using G = BandGeometry<NP>;
  extern __shared__ __align__(16) unsigned char band_smem[];
  __shared__ float red[kThreads / 32];
  const BandSmem<NP, false> sm(band_smem);
  const int n = prm.n;
  const int rank = cluster_rank();
  const size_t sys = blockIdx.x / G::C;
  band_gp_load_da(sm, a, d, sys, n);
  const WarpTile w = band_warp_tile<NP>();
  float xm[1][G::NT][4];
  band_load_x<NP>(xm, x0 + sys * n * n, n, rank, w);
  band_gp_stage_k(sm, b + sys * n * n, c + sys * n, n, rank);

  band_rounds<NP, false>(xm, sm, prm, w, rank);
  band_gp_epilogue(sm, n, rank, e + sys, out + 2 * sys, red);
  band_store_x(sm, kinv + sys * n * n, n, rank);
}

// K = B + diag(c) (K6's A): B read as it is, then c added to the
// diagonal of a loaded quadrant, K[i][i] = B[i][i] + c[i] as the plain
// version's b + eye * c rounds it.
struct QuadGpK {
  const float* b;
  const float* c;
  int n;
  __device__ const float* at(int i, int j) const {
    return b + static_cast<size_t>(i) * n + j;
  }
  // dst holds the quadrant at global (gi0, gj0): thread t < Q adds c to
  // the diagonal element of its row, where the quadrant has one
  template <int NP>
  __device__ void fix(float* dst, int gi0, int gj0) const {
    using G = QuadGeometry<NP>;
    const int t = threadIdx.x, gi = gi0 + t, j = gi - gj0;
    if (t < G::Q && gi < n && j >= 0 && j < G::Q)
      dst[t * G::LD + j] = __fadd_rn(dst[t * G::LD + j], c[gi]);
  }
};

// K6's epilogue on the quadrant loop, from the quadrant of X in kF0 and
// [d a] in sm.rest: thread j < Q sums its column over the quadrant's rows,
// x_d[j] = sum_i d[i] X[i][j] and x_a likewise, into the partials
// mean_s = x_d . a and quad_s = x_a . a over the quadrant's columns, and
// stores them in rank 0's partials; rank 0 adds the four in rank order
// into out[0] = mean and out[1] = *e - quad, so two runs give the same
// bits.  The cluster has passed a barrier since kF0 was written.
template <int NP>
__device__ __forceinline__ void quad_gp_epilogue(const QuadSmem<NP>& sm,
                                                 const QuadCta& c, int n,
                                                 const float* e, float* out,
                                                 float* red) {
  using G = QuadGeometry<NP>;
  constexpr int Q = G::Q;
  const int tid = threadIdx.x;
  const float* sd = sm.rest;
  const float* sa = sm.rest + NP;
  const float* xf = sm.area(kF0);
  const int gi0 = c.p * Q, gj = c.q * Q + tid;
  const int rows = min(Q, n - gi0);
  float mean_part = 0.f, quad_part = 0.f;
  if (tid < Q && gj < n) {
    float xd = 0.f, xa = 0.f;
    for (int i = 0; i < rows; ++i) {
      const float xij = xf[i * G::LD + tid];
      xd = fmaf(sd[gi0 + i], xij, xd);
      xa = fmaf(sa[gi0 + i], xij, xa);
    }
    mean_part = __fmul_rn(xd, sa[gj]);
    quad_part = __fmul_rn(xa, sa[gj]);
  }
  const float mean_s = block_sum(mean_part, red);
  const float quad_s = block_sum(quad_part, red);
  if (tid == 0) {
    st_peer_f32(peer_addr(sm.partials() + 2 * c.rank, 0), mean_s);
    st_peer_f32(peer_addr(sm.partials() + 2 * c.rank + 1, 0), quad_s);
  }
  cluster_sync();
  if (c.rank == 0 && tid == 0) {
    float mean = 0.f, quad = 0.f;
    for (int r = 0; r < kQuadCtas; ++r) {
      mean += sm.partials()[2 * r];
      quad += sm.partials()[2 * r + 1];
    }
    out[0] = mean;
    out[1] = *e - quad;
  }
}

// K6 for 129 <= n <= 224: one 2 x 2 cluster of four CTAs a system, each
// iterating one NP / 2 quadrant of K = B + diag(c) (ns_quad_rounds.cuh)
// from K1's spd seed taken over the cluster (quad_seed), the spd
// schedule's rounds, then quad_gp_epilogue.
template <int NP>
__global__ void __launch_bounds__(kThreads, band_ctas_per_sm(NP, false))
    gp_ns_quad_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ d,
                      const float* __restrict__ e, float* __restrict__ out,
                      NSParams prm) {
  extern __shared__ __align__(16) unsigned char quad_smem[];
  __shared__ float red[kThreads / 32];
  const QuadSmem<NP> sm(quad_smem);
  const QuadCta cta;
  const int n = prm.n;
  const size_t sys = blockIdx.x / kQuadCtas;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm.rest[i] = d[sys * n + i];
    sm.rest[NP + i] = a[sys * n + i];
  }
  const QuadGpK src{b + sys * n * n, c + sys * n, n};
  const WarpTile w = quad_warp_tile<NP>();
  float xm[1][QuadGeometry<NP>::NT][4];
  quad_stage<NP, false>(sm, cta, src, n, /*pan=*/false);
  quad_seed<NP>(xm, sm, cta, n, /*spd=*/true, red, w);
  quad_rounds<NP, false>(xm, sm, prm, cta, src, w);
  quad_gp_epilogue(sm, cta, n, e + sys, out + 2 * sys, red);
}

// acc + x * y in K10's sums: fused on the square layout; on the packed one
// a rounded product and a rounded sum, which the plain version
// (ops/cuda_gp_lml.py::lml_quad_logdet_plain) repeats bit for bit.
template <typename Lay>
__device__ __forceinline__ float lml_madd(float x, float y, float acc) {
  if constexpr (Lay::kPacked) {
    return __fadd_rn(acc, __fmul_rn(x, y));
  } else {
    return fmaf(x, y, acc);
  }
}

// K10's body on the layout lay, T threads a block.  EMIT_W = false: quad
// and logdet only; true: also W = L^-1 and alpha = K^-1 d.  K (the factor,
// then with EMIT_W on the packed layout W in its place), W (EMIT_W on the
// square layout: a second matrix; on the packed one the scratch of the
// in-place W), v (2n floats: d, then t)
// and, on the packed layout with EMIT_W, diag (n floats: L's diagonal,
// kept for log|K|) in shared memory.
// t = W d (thread i owns row i) and alpha = W^T t (thread j owns column j)
// sum in increasing index, and quad and log|K| lane by lane on warp 0 (lane
// l takes the elements l, l + 32, ...) and then over the lanes by xor
// shuffles.
template <bool EMIT_W, int T, typename Lay>
__device__ __forceinline__ void gp_lml_body(
    float* K, float* W, float* v, float* diag, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ d,
    float* __restrict__ out, float* __restrict__ w_out,
    float* __restrict__ alpha_out, int n, Lay lay) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const float* bs = b + sys * n * n;
  const float* cs = c + sys * n;
  chol_load(bs, K, n, lay, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;  // as gp_ns_stage_k rounds it
  });
  for (int i = tid; i < n; i += T) v[i] = d[sys * n + i];
  __syncthreads();
  chol_factor(K, n, lay);

  const float* u = v;  // the vector whose squares sum to quad
  const float* ldiag = nullptr;  // L's diagonal where W replaced L
  if (!EMIT_W) {
    if (warp == 0) {
      // L y = d in place, in the plain version's order (as K5)
      for (int k = 0; k < n; ++k) {
        const float yk = v[k] / K[lay.row(k) + k];
        __syncwarp();
        if (lane == 0) v[k] = yk;
        for (int i = k + 1 + lane; i < n; i += 32)
          v[i] = __fsub_rn(v[i], __fmul_rn(K[lay.row(i) + k], yk));
        __syncwarp();
      }
    }
  } else {
    if constexpr (Lay::kPacked) {
      for (int i = tid; i < n; i += T) diag[i] = K[lay.row(i) + i];
      chol_tri_inverse_in_place(K, W, n, lay);  // ends with a barrier
      W = K;
      ldiag = diag;
    } else {
      chol_tri_inverse(K, W, n, lay.ld);
      __syncthreads();
    }
    // t = W d, thread i owns row i (W is zero above the diagonal)
    for (int i = tid; i < n; i += T) {
      float t = 0.f;
      for (int k4 = 0; k4 <= i; k4 += 4) {  // float4 reads of row i
        float w4[4];
        chol_get4(w4, W + lay.row(i) + k4);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u <= i) t = lml_madd<Lay>(w4[u], v[k4 + u], t);
      }
      v[n + i] = t;
    }
    __syncthreads();
    // alpha = W^T t, thread j owns column j
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int i = j; i < n; ++i)
        s = lml_madd<Lay>(W[lay.row(i) + j], v[n + i], s);
      alpha_out[sys * n + j] = s;
    }
    float* ws = w_out + sys * n * n;
    if constexpr (Lay::kPacked) {
      for (int i = warp; i < n; i += T / 32) {  // a row a warp
        const float* wr = W + lay.row(i);
        for (int j = lane; j < n; j += 32)
          ws[i * n + j] = j <= i ? wr[j] : 0.f;
      }
    } else {
      for (int x = tid; x < n * n; x += T) {
        const int i = x / n, j = x % n;
        ws[x] = j <= i ? W[lay.row(i) + j] : 0.f;
      }
    }
    u = v + n;
  }
  __syncthreads();
  if (warp == 0) {
    float q = 0.f, ld_sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      q = lml_madd<Lay>(u[i], u[i], q);
      ld_sum += logf(ldiag ? ldiag[i] : K[lay.row(i) + i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      q += __shfl_xor_sync(0xffffffffu, q, o);
      ld_sum += __shfl_xor_sync(0xffffffffu, ld_sum, o);
    }
    if (lane == 0) {
      out[2 * sys] = q;
      out[2 * sys + 1] = 2.f * ld_sum;
    }
  }
}

// K10, n <= 128: K, then W (EMIT_W), then v.
template <bool EMIT_W>
__global__ void __launch_bounds__(kThreads, EMIT_W ? 1 : 3)
    gp_lml_kernel(const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ d, float* __restrict__ out,
                  float* __restrict__ w_out, float* __restrict__ alpha_out,
                  int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  gp_lml_body<EMIT_W, kThreads>(smem, smem + n * ld,
                                smem + (EMIT_W ? 2 : 1) * n * ld, nullptr, b,
                                c, d, out, w_out, alpha_out, n,
                                CholSquare{ld});
}

// Floats of K10's packed instance's shared memory: the packed triangle,
// with EMIT_W the in-place W's scratch, then v and (EMIT_W) diag; 143.5 KB
// at n = 256 with W, 138 KB without.
size_t gp_lml_band_floats(int n, bool emit_w) {
  return chol_packed_floats(n) +
         (emit_w ? chol_w_scratch_floats(n) + 3ull * n : 2ull * n);
}

// K10 past n = 128 (129 <= n <= 256): the packed lower triangle, with
// EMIT_W turned into W in place (cholesky_common.cuh::
// chol_tri_inverse_in_place, right-looking by row panels), T = 256 or 512
// threads (chol_band_threads), at most 128 registers a thread.
template <bool EMIT_W, int T>
__global__ void __launch_bounds__(T, 512 / T)
    gp_lml_band_kernel(const float* __restrict__ b,
                       const float* __restrict__ c,
                       const float* __restrict__ d, float* __restrict__ out,
                       float* __restrict__ w_out,
                       float* __restrict__ alpha_out, int n) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + chol_packed_floats(n);
  float* v = scratch + (EMIT_W ? chol_w_scratch_floats(n) : 0);
  gp_lml_body<EMIT_W, T>(smem, scratch, v, v + 2 * n, b, c, d, out, w_out,
                         alpha_out, n, CholPacked{});
}

// Bytes of K6's and K11's shared memory for NP = np: NsSmem, then [d a]
// (201.5 KB at n = 128).
size_t gp_ns_smem_bytes(size_t np, int n) {
  return ns_smem_bytes(np) + 2ull * n * sizeof(float);
}

template <typename Kernel, typename... Args>
cudaError_t launch_threads(Kernel kernel, int threads, size_t smem,
                           int batch, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int batch, cudaStream_t stream,
                   Args... args) {
  return launch_threads(kernel, kThreads, smem, batch, stream, args...);
}

}  // namespace

// a, c, d: (batch, n); b: (batch, n, n); e: (batch,); out: (batch, 2) =
// [mean, var]; all fp32, contiguous, on `device`.  Returns the CUDA error of
// the launch.
extern "C" int cmi_gp_fused(const float* a, const float* b, const float* c,
                            const float* d, const float* e, float* out,
                            int batch, int n, int device, void* stream) {
  if (n < 1 || n > kCholMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) {
    const CholBandPlan plan = chol_band_plan(n, batch, true, device);
    return static_cast<int>(
        plan.band ? launch_threads(gp_chol_band_kernel<true>, plan.threads,
                                   plan.smem, batch, s, a, b, c, d, e, out, n)
                  : launch_threads(gp_chol_band_kernel<false>, plan.threads,
                                   plan.smem, batch, s, a, b, c, d, e, out,
                                   n));
  }
  const size_t smem =
      (static_cast<size_t>(n) * chol_ld(n) + 2ull * n) * sizeof(float);
  return static_cast<int>(launch(gp_chol_kernel, smem, batch, s, a, b, c, d,
                                 e, out, n));
}

namespace {

// K6 past n = 128: one 2 x 2 cluster a system at NP = 160, 192 or 224.
// *np_out = NP once it launched.
template <int NP>
cudaError_t launch_gp_ns_quad_np(const NSParams& prm, int batch,
                                 cudaStream_t s, const float* a,
                                 const float* b, const float* c,
                                 const float* d, const float* e, float* out,
                                 int* np_out) {
  const cudaError_t err =
      cluster_launch(gp_ns_quad_kernel<NP>, kQuadCtas, batch, kThreads,
                     quad_smem_bytes(NP), s, a, b, c, d, e, out, prm);
  if (err == cudaSuccess) *np_out = NP;
  return err;
}

cudaError_t launch_gp_ns_quad(const NSParams& prm, int batch, cudaStream_t s,
                              const float* a, const float* b, const float* c,
                              const float* d, const float* e, float* out,
                              int* np_out) {
  switch (band_np(prm.n)) {
    case 160:
      return launch_gp_ns_quad_np<160>(prm, batch, s, a, b, c, d, e, out,
                                       np_out);
    case 192:
      return launch_gp_ns_quad_np<192>(prm, batch, s, a, b, c, d, e, out,
                                       np_out);
    default:
      return launch_gp_ns_quad_np<224>(prm, batch, s, a, b, c, d, e, out,
                                       np_out);
  }
}

}  // namespace

// As cmi_gp_fused, with K^-1 by the spd Newton-Schulz schedule: `lo` scaled
// rounds with the fp32 scalars two_c / c_sq (device arrays of `lo` floats),
// then `hi` polish rounds, the last residual in fp32; 1 <= n <= 224, one
// block a system up to 128 and one 2 x 2 cluster past it
// (cudaErrorInvalidValue past 224).  *quad_np (when not null): the padded
// size of the cluster instance launched, else 0.
extern "C" int cmi_gp_fused_ns(const float* a, const float* b, const float* c,
                               const float* d, const float* e, float* out,
                               int batch, int n, int lo, int hi,
                               const float* two_c, const float* c_sq,
                               int device, void* stream, int* quad_np) {
  int np_launched = 0;
  if (quad_np == nullptr) quad_np = &np_launched;
  *quad_np = 0;
  NSParams prm;
  if (batch < 0 || (lo > 0 && two_c == nullptr) ||
      !make_ns_params(n, /*init_spd=*/1, lo, hi, /*split3=*/0,
                      /*polish_highest=*/1, two_c, c_sq, &prm, kBandMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = ns_tile(n);
  const size_t np = 16ull * m;
  const size_t smem = gp_ns_smem_bytes(np, n);
  switch (m) {
    case 1: err = launch(gp_ns_kernel<1>, smem, batch, s, a, b, c, d, e, out, prm); break;
    case 2: err = launch(gp_ns_kernel<2>, smem, batch, s, a, b, c, d, e, out, prm); break;
    case 4: err = launch(gp_ns_kernel<4>, smem, batch, s, a, b, c, d, e, out, prm); break;
    case 8: err = launch(gp_ns_kernel<8>, smem, batch, s, a, b, c, d, e, out, prm); break;
    default: err = launch_gp_ns_quad(prm, batch, s, a, b, c, d, e, out, quad_np); break;
  }
  return static_cast<int>(err);
}

namespace {

// K11 past n = 128: one cluster a system at NP = 160, 192 or 224.
cudaError_t launch_gp_warm_band(const NSParams& prm, int batch,
                                cudaStream_t s, const float* a,
                                const float* b, const float* c,
                                const float* d, const float* e,
                                const float* x0, float* out, float* kinv) {
  switch (band_np(prm.n)) {
    case 160:
      return band_launch(gp_warm_band_kernel<160>, BandGeometry<160>::C,
                         batch, band_smem_bytes(160, false), s, a, b, c, d,
                         e, x0, out, kinv, prm);
    case 192:
      return band_launch(gp_warm_band_kernel<192>, BandGeometry<192>::C,
                         batch, band_smem_bytes(192, false), s, a, b, c, d,
                         e, x0, out, kinv, prm);
    default:
      return band_launch(gp_warm_band_kernel<224>, BandGeometry<224>::C,
                         batch, band_smem_bytes(224, false), s, a, b, c, d,
                         e, x0, out, kinv, prm);
  }
}

}  // namespace

// K11.  As cmi_gp_fused_ns, with X loaded from x0 (batch, n, n) instead of
// seeded, `lo` unscaled bf16 rounds and `hi` polish rounds (the last
// residual in fp32), and the refined X written to kinv (batch, n, n); 1 <=
// n <= 224, one block a system up to 128 and one cluster past it
// (cudaErrorInvalidValue past 224).
extern "C" int cmi_gp_fused_warm(const float* a, const float* b,
                                 const float* c, const float* d,
                                 const float* e, float* out, int batch, int n,
                                 const float* x0, float* kinv, int lo, int hi,
                                 int device, void* stream) {
  NSParams prm;
  if (batch < 0 ||
      !make_warm_params(n, lo, hi, /*split3=*/0, &prm, kBandMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = ns_tile(n);
  const size_t np = 16ull * m;
  const size_t smem = gp_ns_smem_bytes(np, n);
  switch (m) {
    case 1: err = launch(gp_warm_kernel<1>, smem, batch, s, a, b, c, d, e, x0, out, kinv, prm); break;
    case 2: err = launch(gp_warm_kernel<2>, smem, batch, s, a, b, c, d, e, x0, out, kinv, prm); break;
    case 4: err = launch(gp_warm_kernel<4>, smem, batch, s, a, b, c, d, e, x0, out, kinv, prm); break;
    case 8: err = launch(gp_warm_kernel<8>, smem, batch, s, a, b, c, d, e, x0, out, kinv, prm); break;
    default: err = launch_gp_warm_band(prm, batch, s, a, b, c, d, e, x0, out, kinv); break;
  }
  return static_cast<int>(err);
}

// K10.  b: (batch, n, n); c, d: (batch, n); out: (batch, 2) = [quad,
// logdet]; with emit_w also w: (batch, n, n) = L^-1 and alpha: (batch, n) =
// K^-1 d (both ignored, and may be null, without it).  All fp32,
// contiguous, on `device`.  Returns the CUDA error of the launch.
extern "C" int cmi_gp_lml(const float* b, const float* c, const float* d,
                          float* out, float* w, float* alpha, int batch,
                          int n, int emit_w, int device, void* stream) {
  if (n < 1 || n > kCholMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) {
    const size_t smem = gp_lml_band_floats(n, emit_w) * sizeof(float);
    const bool wide = chol_band_threads(smem) == 512;
    if (emit_w)
      err = wide ? launch_threads(gp_lml_band_kernel<true, 512>, 512, smem,
                                  batch, s, b, c, d, out, w, alpha, n)
                 : launch_threads(gp_lml_band_kernel<true, 256>, 256, smem,
                                  batch, s, b, c, d, out, w, alpha, n);
    else
      err = wide ? launch_threads(gp_lml_band_kernel<false, 512>, 512, smem,
                                  batch, s, b, c, d, out, w, alpha, n)
                 : launch_threads(gp_lml_band_kernel<false, 256>, 256, smem,
                                  batch, s, b, c, d, out, w, alpha, n);
    return static_cast<int>(err);
  }
  const size_t mats = emit_w ? 2 : 1;
  const size_t smem = (mats * n * chol_ld(n) + 2ull * n) * sizeof(float);
  if (emit_w)
    err = launch(gp_lml_kernel<true>, smem, batch, s, b, c, d, out, w, alpha,
                 n);
  else
    err = launch(gp_lml_kernel<false>, smem, batch, s, b, c, d, out, w, alpha,
                 n);
  return static_cast<int>(err);
}
