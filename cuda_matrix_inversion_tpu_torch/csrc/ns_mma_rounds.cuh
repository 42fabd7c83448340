// The Newton-Schulz round loop on the tensor cores that K1 and K8
// (newton_schulz.cu) and K6 and K11 (gp.cu) share, with its shared-memory
// layout and the load and staging of the matrix A it inverts (K6 and K11:
// K = B + diag(c)).  SPLIT3 = false runs the bf16 schedules (one-pass
// products, the 3-pass split in the polish residuals before the last);
// SPLIT3 = true the split3 ones (every product the 3-pass split, every
// polish residual fp32).
//
// Shared memory (NP = 16M, LD = NP + 1, LDB = NP + 8): A in fp32 (NP x LD:
// the fp32 residual and the split's parts of A read it); then four bf16
// tiles (NP x LDB).  bf16: Ah, bf16(A); Xh, bf16(X); T, T or R; Xl, the
// split's lo part of X.  split3: Xl; Xh; T, the hi part of T or R; Tl, its
// lo part (A has no tile: both its parts round as they load).  Xf, X in
// fp32 (NP x LD), lies over the last two tiles, written only where neither
// is live.  The source matrix is copied in over the last three tiles
// (stage) before A is staged from it.  ns_smem_bytes: 200.5 KB at n =
// 128, one block an SM (K6 and K11 keep [d a] past it: 201.5 KB).
//
// The fp32 master X lives in the warps' accumulator fragments (xm: each
// warp owns a 32 x 64 tile of every product at n = 128) and is published
// to shared memory as bf16 (and its lo part where a split reads it) once a
// round, where it feeds both A X and X T; T and R go to shared memory as
// bf16, since their next product rounds them anyway.  The bf16 passes run
// on the tensor cores (ns_mma.cuh); the fp32 residuals R = I - A X are
// true fp32 on CUDA cores (ns_common.cuh::product).

#pragma once

#include <cstdint>

#include "ns_common.cuh"
#include "ns_mma.cuh"

namespace {

template <int M, bool SPLIT3 = false>
struct NsSmem {
  static constexpr int NP = 16 * M;
  static constexpr int LD = NP + 1;
  static constexpr int LDB = MmaGeometry<NP>::kLd;
  float* A;
  bf16* Ah;  // bf16 only
  bf16* Xh;
  bf16* T;
  bf16* Xl;
  bf16* Tl;  // split3 only
  float* Xf;
  float* stage;
  float* rest;  // past the layout: K6 and K11 keep [d a] there
  __device__ explicit NsSmem(unsigned char* base)
      : A(reinterpret_cast<float*>(base)),
        Ah(SPLIT3 ? nullptr : tile(0)),
        Xh(tile(1)),
        T(tile(2)),
        Xl(tile(SPLIT3 ? 0 : 3)),
        Tl(SPLIT3 ? tile(3) : nullptr),
        Xf(reinterpret_cast<float*>(tile(2))),
        stage(reinterpret_cast<float*>(tile(1))),
        rest(reinterpret_cast<float*>(tile(4))) {}
  // The k-th bf16 tile past A.
  __device__ bf16* tile(int k) const {
    return reinterpret_cast<bf16*>(A + NP * LD) + k * NP * LDB;
  }
};

// Bytes of NsSmem for NP = np, the launches' size (200.5 KB at n = 128).
inline constexpr size_t ns_smem_bytes(size_t np) {
  return np * (np + 1) * sizeof(float) + 4 * mma_tile_bytes(np);
}

// Start copying the n x n matrix src into sm.stage with asynchronous
// copies; ns_stage waits for them.
template <int M, bool SPLIT3>
__device__ __forceinline__ void ns_load(const NsSmem<M, SPLIT3>& sm,
                                        const float* src, int n) {
  const int tid = threadIdx.x;
  const int nn = n * n;
  if ((nn & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int x = 4 * tid; x < nn; x += 4 * kThreads)
      cp_async16(sm.stage + x, src + x);
  } else {
    for (int x = tid; x < nn; x += kThreads) cp_async4(sm.stage + x, src + x);
  }
}

// A[i][j] = f(i, j, src[i][j]) for i, j < n, zero padded to NP, in fp32
// (sm.A) and, for the bf16 schedules, bf16 (sm.Ah), once the copies of
// ns_load have arrived; the block has passed a barrier when it returns.
template <int M, bool SPLIT3, class F>
__device__ __forceinline__ void ns_stage(const NsSmem<M, SPLIT3>& sm, int n,
                                         F f) {
  using S = NsSmem<M, SPLIT3>;
  cp_async_wait_all();
  __syncthreads();
  for (int x = threadIdx.x; x < S::NP * S::NP; x += kThreads) {
    const int i = x / S::NP, j = x % S::NP;
    const float v = (i < n && j < n) ? f(i, j, sm.stage[i * n + j]) : 0.f;
    sm.A[i * S::LD + j] = v;
    if constexpr (!SPLIT3) sm.Ah[i * S::LDB + j] = __float2bfloat16_rn(v);
  }
  __syncthreads();
}

// The lo and hi rounds on the tensor cores, from the fp32 master X in the
// warps' accumulator fragments xm (zero in the padding).  On entry sm.A
// (and sm.Ah) hold A and the block has passed a barrier since; on return
// sm.Xf holds the refined X in fp32 and the block has passed a barrier
// since it was written.  A lo round is T = 2c I - c^2 (A X), X = X T; a hi
// round R = I - A X, X = X + X R.  bf16: one-pass products, R the 3-pass
// split or, on the last round when prm.polish_highest, fp32.  split3: every
// product the 3-pass split, every R fp32.
template <int M, bool SPLIT3>
__device__ __forceinline__ void ns_mma_rounds(
    float (&xm)[MmaGeometry<16 * M>::kMT][MmaGeometry<16 * M>::kNT][4],
    const NsSmem<M, SPLIT3>& sm, const NSParams& prm, WarpTile w) {
  constexpr int NP = 16 * M;
  constexpr int LD = NP + 1;
  using G = MmaGeometry<NP>;
  constexpr int LDB = G::kLd;
  constexpr int MT = G::kMT;
  constexpr int NT = G::kNT;
  const float* sA = sm.A;
  const bf16* sAh = sm.Ah;
  bf16* sXh = sm.Xh;
  bf16* sT = sm.T;
  bf16* sXl = sm.Xl;
  bf16* sTl = sm.Tl;
  float* sXf = sm.Xf;
  const int n = prm.n;
  const int tid = threadIdx.x;
  // The split's parts of the left operand: A from its fp32 copy (split3),
  // or its bf16 tile and the fp32 copy for the lo part (bf16); X from its
  // two tiles.
  auto a_parts = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int row0,
                     int k0) {
    if constexpr (SPLIT3) {
      frag_a_split(hi, lo, sA, LD, row0, k0);
    } else {
      frag_a_bf16(hi, sAh, LDB, row0, k0);
      frag_a_rem(lo, sA, LD, row0, k0);
    }
  };
  auto x_parts = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int row0,
                     int k0) {
    frag_a_bf16(hi, sXh, LDB, row0, k0);
    frag_a_bf16(lo, sXl, LDB, row0, k0);
  };

  // Publish X for round `r` (r = lo + hi: the epilogue): bf16(X) for every
  // product, its lo part before a split that reads it, fp32 before an fp32
  // residual and the epilogue.  The first barrier ends every read of the
  // buffers written here.
  const int rounds = prm.lo + prm.hi;
  auto f32_round = [&](int r) {
    return r == rounds || (SPLIT3 && r >= prm.lo) ||
           (r == rounds - 1 && prm.polish_highest);
  };
  auto publish = [&](int r) {
    __syncthreads();
    if (w.active) {
      if (r < rounds) store_tile_bf16(xm, sXh, LDB, w);
      if (r < rounds && (SPLIT3 || (r >= prm.lo && !f32_round(r))))
        store_tile_bf16<MT, NT, true>(xm, sXl, LDB, w);
      if (f32_round(r)) store_tile_f32(xm, sXf, LD, w);
    }
    __syncthreads();
  };
  publish(0);

  float acc[MT][NT][4];
  for (int r = 0; r < prm.lo; ++r) {
    // T = 2c I - c^2 (A X), then X = X T (the fp32 master is replaced)
    float tc, c2;
    round_scalars(prm, r, tc, c2);
    if (w.active) {
      if constexpr (SPLIT3)
        mma_split3<NP>(acc, a_parts, sXh, sXl, w);
      else
        mma_tiles<NP>(acc, sAh, sXh, w);
      tile_for_each(acc, w, [&](int i, int j, float& v) {
        v = (i < n && j < n) ? __fsub_rn(i == j ? tc : 0.f, __fmul_rn(c2, v))
                             : 0.f;
      });
      store_tile_bf16(acc, sT, LDB, w);
      if constexpr (SPLIT3) store_tile_bf16<MT, NT, true>(acc, sTl, LDB, w);
    }
    __syncthreads();
    if (w.active) {
      if constexpr (SPLIT3)
        mma_split3<NP>(xm, x_parts, sT, sTl, w);
      else
        mma_tiles<NP>(xm, sXh, sT, w);
    }
    publish(r + 1);
  }
  for (int r = prm.lo; r < rounds; ++r) {
    // R = I - A X (the 3-pass split, or fp32 on CUDA cores), X = X + X R
    if (f32_round(r)) {
      float accf[M][M];
      const int tx = tid % 16, ty = tid / 16;
      product<M>(sA, sXf, n, ty, tx, accf);
      __syncthreads();  // sXf lies under sT
#pragma unroll
      for (int p = 0; p < M; ++p)
#pragma unroll
        for (int q = 0; q < M; ++q) {
          const int i = ty + 16 * p, j = tx + 16 * q;
          const float v = (i < n && j < n)
                              ? __fsub_rn(i == j ? 1.f : 0.f, accf[p][q])
                              : 0.f;
          sT[i * LDB + j] = __float2bfloat16_rn(v);
          if constexpr (SPLIT3)
            sTl[i * LDB + j] = __float2bfloat16_rn(bf16_rem(v));
        }
    } else if (w.active) {
      mma_split3<NP>(acc, a_parts, sXh, sXl, w);
      tile_for_each(acc, w, [&](int i, int j, float& v) {
        v = (i < n && j < n) ? __fsub_rn(i == j ? 1.f : 0.f, v) : 0.f;
      });
      store_tile_bf16(acc, sT, LDB, w);
    }
    __syncthreads();
    if (w.active) {
      if constexpr (SPLIT3)
        mma_split3<NP>(acc, x_parts, sT, sTl, w);
      else
        mma_tiles<NP>(acc, sXh, sT, w);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xm[m][j][q] = __fadd_rn(xm[m][j][q], acc[m][j][q]);
    }
    publish(r + 1);
  }
}

}  // namespace
