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
// O(n^3 / 3) factor, so K5 never forms W.
//
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
// warp's n pivots of an IEEE sqrt and reciprocal, beside the other warps'
// register-tiled panel updates, two barriers a panel), then n
// warp-synchronous substitution steps; its n ld + 2n fp32 of shared memory
// (68.6 KB at n = 128, ld = chol_ld(n) = 132) and at most 80 registers a
// thread let three blocks share an SM.  K6's bound is its operations: 17 bf16 passes at the tensor
// cores' rate and the one fp32 product at the CUDA cores', which is half of
// it.  Inside the block it is a chain of dependent products, 3 barriers a
// round.
// What the design does about it: everything stays in shared memory or
// registers from the load of B to the two scalars.  K5's two substitutions
// run on two warps with no block barrier, and its dot products are warp
// reductions.  K6 keeps the fp32 master X in the warps' accumulator
// fragments and publishes bf16(X) to shared memory once a round
// (ns_mma_rounds.cuh); K stays in shared memory in fp32 for the fp32
// residual and the split's lo part, and as a bf16 copy for the one-pass
// products.  Shared memory at n = 128: K 66 KB, four bf16 tiles (K, X,
// T or R, X's lo part) 34 KB each, with X in fp32 over the last two where
// needed, then [d a]: 201.5 KB, one block an SM.  Several systems per
// block and wgmma are later work.
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
// products is 6 instead of K6's 16.
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
// registers a thread), with it one.

#include <cuda_runtime.h>

#include "cholesky_common.cuh"
#include "ns_common.cuh"
#include "ns_mma_rounds.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads, 3)
    gp_chol_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ d,
                   const float* __restrict__ e, float* __restrict__ out,
                   int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  float* K = smem;
  float* Y = smem + n * ld;  // Y[0..n) = y_d, Y[n..2n) = y_a
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const float* bs = b + sys * n * n;
  const float* cs = c + sys * n;
  chol_load(bs, K, n, ld, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;  // as gp_ns_stage_k rounds it
  });
  for (int i = tid; i < n; i += kThreads) {
    Y[i] = d[sys * n + i];
    Y[n + i] = a[sys * n + i];
  }
  __syncthreads();
  chol_factor(K, n, ld);

  if (warp < 2) {
    // L y = rhs, one warp per right-hand side, in the plain version's
    // order: y[k] /= L[k][k], then eliminated from the rows below.
    float* y = Y + warp * n;
    for (int k = 0; k < n; ++k) {
      const float yk = y[k] / K[k * ld + k];
      __syncwarp();
      if (lane == 0) y[k] = yk;
      for (int i = k + 1 + lane; i < n; i += 32)
        y[i] = __fsub_rn(y[i], __fmul_rn(K[i * ld + k], yk));
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

// K10.  EMIT_W = false: quad and logdet only; true: also W = L^-1 and
// alpha = K^-1 d.
template <bool EMIT_W>
__global__ void __launch_bounds__(kThreads, EMIT_W ? 1 : 3)
    gp_lml_kernel(const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ d, float* __restrict__ out,
                  float* __restrict__ w_out, float* __restrict__ alpha_out,
                  int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = chol_ld(n);
  float* K = smem;
  float* W = smem + n * ld;                     // EMIT_W only
  float* v = smem + (EMIT_W ? 2 : 1) * n * ld;  // v[0..n) = d, v[n..2n) = t
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const float* bs = b + sys * n * n;
  const float* cs = c + sys * n;
  chol_load(bs, K, n, ld, [=](int i, int j, float v) {
    return i == j ? __fadd_rn(v, cs[i]) : v;  // as gp_ns_stage_k rounds it
  });
  for (int i = tid; i < n; i += kThreads) v[i] = d[sys * n + i];
  __syncthreads();
  chol_factor(K, n, ld);

  const float* u = v;  // the vector whose squares sum to quad
  if (!EMIT_W) {
    if (warp == 0) {
      // L y = d in place, in the plain version's order (as K5)
      for (int k = 0; k < n; ++k) {
        const float yk = v[k] / K[k * ld + k];
        __syncwarp();
        if (lane == 0) v[k] = yk;
        for (int i = k + 1 + lane; i < n; i += 32)
          v[i] = __fsub_rn(v[i], __fmul_rn(K[i * ld + k], yk));
        __syncwarp();
      }
    }
  } else {
    chol_tri_inverse(K, W, n, ld);
    __syncthreads();
    // t = W d, thread i owns row i (W is zero above the diagonal)
    for (int i = tid; i < n; i += kThreads) {
      float t = 0.f;
      for (int k4 = 0; k4 <= i; k4 += 4) {  // float4 reads of row i
        float w4[4];
        chol_get4(w4, W + i * ld + k4);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u <= i) t = fmaf(w4[u], v[k4 + u], t);
      }
      v[n + i] = t;
    }
    __syncthreads();
    // alpha = W^T t, thread j owns column j
    for (int j = tid; j < n; j += kThreads) {
      float s = 0.f;
      for (int i = j; i < n; ++i) s = fmaf(W[i * ld + j], v[n + i], s);
      alpha_out[sys * n + j] = s;
    }
    float* ws = w_out + sys * n * n;
    for (int x = tid; x < n * n; x += kThreads) {
      const int i = x / n, j = x % n;
      ws[x] = j <= i ? W[i * ld + j] : 0.f;
    }
    u = v + n;
  }
  __syncthreads();
  if (warp == 0) {
    float q = 0.f, ld_sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      q = fmaf(u[i], u[i], q);
      ld_sum += logf(K[i * ld + i]);
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

// Bytes of K6's and K11's shared memory for NP = np: NsSmem, then [d a]
// (201.5 KB at n = 128).
size_t gp_ns_smem_bytes(size_t np, int n) {
  return ns_smem_bytes(np) + 2ull * n * sizeof(float);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int batch, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// a, c, d: (batch, n); b: (batch, n, n); e: (batch,); out: (batch, 2) =
// [mean, var]; all fp32, contiguous, on `device`.  Returns the CUDA error of
// the launch.
extern "C" int cmi_gp_fused(const float* a, const float* b, const float* c,
                            const float* d, const float* e, float* out,
                            int batch, int n, int device, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      (static_cast<size_t>(n) * chol_ld(n) + 2ull * n) * sizeof(float);
  return static_cast<int>(launch(gp_chol_kernel, smem, batch,
                                 static_cast<cudaStream_t>(stream), a, b, c,
                                 d, e, out, n));
}

// As cmi_gp_fused, with K^-1 by the spd Newton-Schulz schedule: `lo` scaled
// rounds with the host's fp32 scalars two_c / c_sq, then `hi` polish rounds,
// the last residual in fp32.
extern "C" int cmi_gp_fused_ns(const float* a, const float* b, const float* c,
                               const float* d, const float* e, float* out,
                               int batch, int n, int lo, int hi,
                               const float* two_c, const float* c_sq,
                               int device, void* stream) {
  NSParams prm;
  if (batch < 0 ||
      !make_ns_params(n, /*init_spd=*/1, lo, hi, /*split3=*/0,
                      /*polish_highest=*/1, two_c, c_sq, &prm))
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
    default: err = launch(gp_ns_kernel<8>, smem, batch, s, a, b, c, d, e, out, prm); break;
  }
  return static_cast<int>(err);
}

// K11.  As cmi_gp_fused_ns, with X loaded from x0 (batch, n, n) instead of
// seeded, `lo` unscaled bf16 rounds and `hi` polish rounds (the last
// residual in fp32), and the refined X written to kinv (batch, n, n).
extern "C" int cmi_gp_fused_warm(const float* a, const float* b,
                                 const float* c, const float* d,
                                 const float* e, float* out, int batch, int n,
                                 const float* x0, float* kinv, int lo, int hi,
                                 int device, void* stream) {
  NSParams prm;
  if (batch < 0 || !make_warm_params(n, lo, hi, /*split3=*/0, &prm))
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
    default: err = launch(gp_warm_kernel<8>, smem, batch, s, a, b, c, d, e, x0, out, kinv, prm); break;
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
  if (n < 1 || n > kMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
