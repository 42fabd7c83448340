// Tensor-core tile routines for the Newton-Schulz kernels on sm_90a: bf16
// operands in shared memory, fp32 accumulators in registers, through
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 and ldmatrix.  K1
// and K8 (newton_schulz.cu, the bf16 schedules) and K6 and K11 (gp.cu) run
// their bf16 products on them, through the round loop they share
// (ns_mma_rounds.cuh).
//
// Geometry.  An NP x NP product (NP = 16M, zero padded past n) is cut over
// the block's 8 warps into warp tiles of MT x NT m16n8 tiles: warp w owns
// the output rows [row0, row0 + 16 MT) and columns [col0, col0 + 8 NT) and
// holds them as MT x NT accumulator fragments, 4 fp32 a thread each.  At
// NP = 128 a warp tile is 32 x 64 (MT = 2, NT = 8): a k-step loads 2 left
// and 4 right ldmatrix.x4 for 16 MMAs, against 1 and 8 for a 16 x 128
// strip.  At NP = 16 two warps own tiles and the rest only take part in the
// barriers.
//
// Operands.  A bf16 tile is NP rows of kLd = NP + 8 values: the 16-byte pad
// puts the 8 rows one ldmatrix phase reads on distinct banks.  Values are
// rounded to bf16 (nearest even) where they are stored into a tile.  The
// left operand's 16x16 fragment comes from a bf16 tile through ldmatrix,
// or from its fp32 original in shared memory, rounded as it loads (the
// 3-pass split's lo part bf16(x - bf16(x)), or both parts).  The right
// operand's 16x8 fragments come from a bf16 tile stored row-major as [k][n]
// through ldmatrix.trans.
//
// Arithmetic.  A bf16 x bf16 product is exact in fp32 and the tensor cores
// accumulate in fp32, so a one-pass product computes what the plain
// versions' one-pass product (bf16-rounded operands, fp32 sums) computes,
// up to the order of the sums; the 3-pass split adds hi*hi, lo*hi and hi*lo into one
// accumulator.  Never TF32.  NaN and Inf pass through the conversions and
// the MMAs.
//
// Fragment layouts (PTX ISA, m16n8k16 with 16-bit operands), g = lane / 4,
// t = lane % 4: A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// C c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).  The lower k or column
// sits in the lower 16 bits.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int NP>
struct MmaGeometry {
  static_assert(NP % 16 == 0 && NP <= 128, "NP = 16M, at most 128");
  static constexpr int kLd = NP + 8;  // bf16 tile row stride
  static constexpr int kMT = NP >= 64 ? 2 : 1;  // m16 tiles a warp owns
  static constexpr int kNT = NP == 128 ? 8 : NP == 64 ? 2 : 1;  // n8 tiles
  static constexpr int kColBlocks = NP / (8 * kNT);
  static constexpr int kWarps = NP / (16 * kMT) * kColBlocks;  // with a tile
  static_assert(kWarps <= 8, "8 warps a block");
};

// Bytes of one NP x NP bf16 tile.
inline constexpr size_t mma_tile_bytes(size_t np) {
  return np * (np + 8) * sizeof(bf16);
}

// The calling warp's output tile: rows [row0, row0 + 16 MT), columns
// [col0, col0 + 8 NT); `active` is false for a warp without one.
struct WarpTile {
  int row0, col0;
  bool active;
};

template <int NP>
__device__ __forceinline__ WarpTile warp_tile() {
  using G = MmaGeometry<NP>;
  const int w = threadIdx.x >> 5;
  return {16 * G::kMT * (w / G::kColBlocks),
          8 * G::kNT * (w % G::kColBlocks), w < G::kWarps};
}

// (x0, x1) rounded to bf16 (nearest even), x0 in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x - bf16(x), exact in fp32: the 3-pass split's lo part before rounding.
__device__ __forceinline__ float bf16_rem(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The left operand's fragment at (row0, k0) of a bf16 tile.
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4], const bf16* tile,
                                            int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The left operand's fragment at (row0, k0) of the split's lo part
// bf16(x - bf16(x)) of an fp32 matrix P (row stride ld), rounded as it
// loads.
__device__ __forceinline__ void frag_a_rem(uint32_t (&lo)[4], const float* P,
                                           int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = P + (row0 + g + 8 * (i & 1)) * ld + k0 + 2 * t +
                     8 * (i >> 1);
    lo[i] = pack_bf16(bf16_rem(p[0]), bf16_rem(p[1]));
  }
}

// Both parts of the split, bf16(x) and bf16(x - bf16(x)), of the left
// operand's fragment at (row0, k0) of an fp32 matrix P (row stride ld),
// rounded as they load.
__device__ __forceinline__ void frag_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float* P, int ld,
                                             int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = P + (row0 + g + 8 * (i & 1)) * ld + k0 + 2 * t +
                     8 * (i >> 1);
    hi[i] = pack_bf16(p[0], p[1]);
    lo[i] = pack_bf16(bf16_rem(p[0]), bf16_rem(p[1]));
  }
}

// acc[m][j] += a[m] B[k0:k0+16, col0+8j : col0+8j+8] for m < MT, j < NT,
// B a bf16 tile stored [k][n]: each right fragment is loaded once for the
// MT left ones.
template <int MT, int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4],
                                        const uint32_t (&a)[MT][4],
                                        const bf16* B, int ld, int k0,
                                        int col0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = B + (k0 + (lane & 15)) * ld + col0;
  if constexpr (NT == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, p);
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_bf16(acc[m][0], a[m], b[0], b[1]);
  } else {
    static_assert(NT % 2 == 0, "two n8 tiles a ldmatrix.x4");
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, p + 8 * j + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][j], a[m], b[0], b[1]);
        mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_tile(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// acc = A B over k < NP in one pass, A and B bf16 tiles.
template <int NP, int MT, int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4],
                                          const bf16* A, const bf16* B,
                                          WarpTile w) {
  constexpr int LD = MmaGeometry<NP>::kLd;
  zero_tile(acc);
#pragma unroll 2
  for (int k0 = 0; k0 < NP; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) frag_a_bf16(a[m], A, LD, w.row0 + 16 * m, k0);
    mma_k16(acc, a, B, LD, k0, w.col0);
  }
}

// The 3-pass split acc = hi(P) hi(Y) + lo(P) hi(Y) + hi(P) lo(Y): the
// left operand's two parts at (row0, k0) from load_p(hi, lo, row0, k0),
// Y's halves in the bf16 tiles Yh and Yl.
template <int NP, int MT, int NT, class LoadP>
__device__ __forceinline__ void mma_split3(float (&acc)[MT][NT][4],
                                           LoadP load_p, const bf16* Yh,
                                           const bf16* Yl, WarpTile w) {
  constexpr int LD = MmaGeometry<NP>::kLd;
  zero_tile(acc);
  for (int k0 = 0; k0 < NP; k0 += 16) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) load_p(hi[m], lo[m], w.row0 + 16 * m, k0);
    mma_k16(acc, hi, Yh, LD, k0, w.col0);
    mma_k16(acc, lo, Yh, LD, k0, w.col0);
    mma_k16(acc, hi, Yl, LD, k0, w.col0);
  }
}

// f(i, j, v) on every element v of the warp tile's fragments (V is float
// or const float).
template <int MT, int NT, class V, class F>
__device__ __forceinline__ void tile_for_each(V (&v)[MT][NT][4], WarpTile w,
                                              F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(w.row0 + 16 * m + g + 8 * (e >> 1), w.col0 + 8 * j + 2 * t + (e & 1),
          v[m][j][e]);
}

// The warp tile into a bf16 tile, rounded (REM: x - bf16(x) rounded, the
// split's lo part), one 32-bit store per pair of columns.
template <int MT, int NT, bool REM = false>
__device__ __forceinline__ void store_tile_bf16(const float (&v)[MT][NT][4],
                                                bf16* tile, int ld,
                                                WarpTile w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = v[m][j][2 * h], x1 = v[m][j][2 * h + 1];
        *reinterpret_cast<uint32_t*>(
            tile + (w.row0 + 16 * m + g + 8 * h) * ld + w.col0 + 8 * j +
            2 * t) =
            REM ? pack_bf16(bf16_rem(x0), bf16_rem(x1)) : pack_bf16(x0, x1);
      }
}

// The warp tile into an fp32 matrix P (row stride ld).
template <int MT, int NT>
__device__ __forceinline__ void store_tile_f32(const float (&v)[MT][NT][4],
                                               float* P, int ld, WarpTile w) {
  tile_for_each(v, w, [&](int i, int j, float x) { P[i * ld + j] = x; });
}

}  // namespace
