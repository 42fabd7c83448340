// The Newton-Schulz round loop of ns_mma_rounds.cuh spread over a
// thread-block cluster of 32-row slabs, for 129 <= n <= 224, where one
// block's 227 KB of shared memory cannot hold the single-block layout
// (ns_smem_bytes: 310.6 KB at NP = 160, 444.8 at 192, 602.9 at 224).  The
// warm kernels K8 (newton_schulz.cu::ns_band_kernel) and K11
// (gp.cu::gp_warm_band_kernel) run it there: the loop takes X in the
// fragments as the single-block one does, loaded from a previous inverse.
// The cold kernels K1 and K6 run the quadrant loop (ns_quad_rounds.cuh).
//
// Geometry.  n pads with zeros to NP in {160, 192, 224} and the matrix is
// cut into C = NP / 32 row slabs of 32 rows (5, 6 or 7 CTAs a cluster,
// all portable sizes; the grid is batch x C).  CTA `rank` of a cluster owns
// rows [32 rank, 32 rank + 32) of A, of X and of T/R: its 8 warps hold the
// slab's 32 x NP output as 2 row halves x 4 column quarters, one m16 tile
// by NT = NP / 32 n8 tiles a warp.  The fp32 master X lives in those
// accumulator fragments, as in the single-block loop.
//
// Products.  Every product is rows-of-left x whole-right: the left operand
// is the CTA's own slab, the right one has its 16-row k-chunk c in CTA
// c / 2's slab, at the same offset in every CTA.  ldmatrix cannot address
// a peer's shared memory and a chunk pulled through registers exposes its
// whole latency (~0.5 us, from a peer as from L2), so the owners push:
// right after the cluster barrier that published a right operand, warp 0
// of each CTA issues one bulk copy a part (cp.async.bulk shared::cluster:
// its slab's two contiguous 16-row chunks, 10.5 - 29.2 KB) into every
// peer's staging area, completing on an mbarrier in that peer, one a peer
// slab, which the peer arms with the bytes it expects.  Many chunks are in
// flight at once; the CTA's walk starts at its own two chunks, read in
// place, which hide the first arrival, and then waits on each peer's
// barrier just before the MMAs that read its chunks.  The walk visits the
// slabs in the order rank, rank + 1, ... (mod C), so no two CTAs read one
// owner at once, and every sum runs over k in that order whatever carries
// the chunks.
// The MMAs are ns_mma.cuh's fragments, unchanged.  The staging area holds
// the most that fits beside the slab tiles (band_stage_bytes): the whole
// bf16 walk at every NP, and every walk at NP = 192 and at 160 for split3;
// where a walk's chunks do not fit (the split's two-part chunks and the
// residual's fp32 chunks at 224, and all but the bf16 walk at 160, where
// the bf16 instance keeps two CTAs an SM), the walk goes in windows of as
// many peers as fit, one cluster barrier between two windows: the barrier
// proves that no CTA still reads the slots the next window's pushes fill.
//
// The fp32 residual R = I - A X runs on CUDA cores over chunks of X in
// fp32 pushed the same way; the split3 schedule accumulates it in fp64, as
// linalg.residual_f64 does on the routes past the kernels: past n = 128 an
// fp32 residual leaves the kappa = 500 class over the 1e-4 gate (1.05e-4 at
// n = 224 in the plain version).  Each thread owns 4 adjacent rows and NT
// columns of one column half: one 16-byte load of A feeds 4 k steps and X
// comes in one 16-, one 8- and one 4-byte load, 4 + 3 loads a k step where
// a tile of rows 8 apart took 4 + 7.  A warp's load still costs one
// shared-memory wavefront a 4-byte value a lane, 11 a k step against 28
// FMAs, so the shared-memory pipe paces the residual, not the FMA pipe.
// Each sum runs over k in the walk's order.
//
// Barriers.  A publish (X into the slab tiles) and a T/R store end in a
// cluster barrier (fence.proxy.async, then barrier.cluster.arrive.release
// / wait.acquire), two a round, plus the walks' window barriers; every
// push of a buffer lies between the barrier that published it and the next
// barrier of the CTA that overwrites it, and every CTA waits for all its
// chunks before it arrives at the next barrier, so a barrier also proves
// that every earlier push has landed.  The last publish is that barrier
// for the final X, so no CTA exits while a peer may still read its slab or
// a copy is in flight.
//
// Shared memory a CTA (LDF = NP + 4 fp32, LDB = NP + 8 bf16 a row): A and
// Xf in fp32 (32 x LDF each), four bf16 slab tiles (as ns_mma_rounds.cuh:
// bf16 Ah, Xh, T, Xl; split3 Tl, Xh, T, Xl), the staging area, eight
// mbarriers, then K11's [d a] and the cluster's partial sums: 203.9 /
// 225.6 / 105.4 KB (split3 168.4) at NP = 224 / 192 / 160, one CTA an SM
// (two at NP = 160 bf16); the staging area is 12 bf16 chunks (87.0 KB) at
// 224, 20 (125 KB) at 192, 4 (21 KB; split3 16) at 160.

#pragma once

#include <cstdint>
#include <type_traits>

#include "cluster_common.cuh"
#include "ns_common.cuh"
#include "ns_mma.cuh"

namespace {

constexpr int kSlab = 32;       // rows a CTA owns
constexpr int kBandBars = 8;    // mbarriers reserved a CTA (C - 1 used)

// Bytes of the staging area at NP = np: whole 16-row bf16 chunks (16 x
// (np + 8) x 2 bytes), as many as fit beside the rest (band_smem_bytes)
// in a CTA's 227 KB, but at NP = 160 for the bf16 schedules only 4, so
// that two CTAs of 105.4 KB share an SM.
__host__ __device__ constexpr size_t band_stage_bytes(size_t np,
                                                  bool split3) {
  return 16 * (np + 8) * 2 *
         (np == 224 ? 12 : np == 192 ? 20 : split3 ? 16 : 4);
}

template <int NP>
struct BandGeometry {
  static_assert(NP % kSlab == 0 && NP <= kBandMaxN, "NP = 32 C");
  static constexpr int C = NP / kSlab;  // CTAs a cluster
  static_assert(C - 1 <= kBandBars, "an mbarrier a peer");
  static constexpr int NT = NP / 32;    // n8 tiles a warp
  static constexpr int LDB = NP + 8;    // bf16 row stride
  static constexpr int LDF = NP + 4;    // fp32 row stride
  static constexpr int kChunks = NP / 16;
  static constexpr int kTile = kSlab * LDB;  // bf16 slab tile, elements
  static constexpr int kSlabF = kSlab * LDF;  // fp32 slab, elements
};

template <int NP, bool SPLIT3>
struct BandSmem {
  using G = BandGeometry<NP>;
  static constexpr size_t kStage = band_stage_bytes(NP, SPLIT3);
  float* A;
  float* Xf;
  bf16* Ah;  // bf16 only
  bf16* Xh;
  bf16* T;
  bf16* Xl;
  bf16* Tl;  // split3 only
  unsigned char* stage;  // the peers' chunks of the walk's current window
  uint64_t* bars;        // bars[d - 1]: the chunks of the peer rank + d
  // K11: d at [0, NP), a at [NP, 2 NP), partials past them
  float* rest;
  __device__ explicit BandSmem(unsigned char* base)
      : A(reinterpret_cast<float*>(base)),
        Xf(A + G::kSlabF),
        Ah(SPLIT3 ? nullptr : tile(0)),
        Xh(tile(1)),
        T(tile(2)),
        Xl(tile(3)),
        Tl(SPLIT3 ? tile(0) : nullptr),
        stage(reinterpret_cast<unsigned char*>(tile(4))),
        bars(reinterpret_cast<uint64_t*>(stage + kStage)),
        rest(reinterpret_cast<float*>(bars + kBandBars)) {}
  __device__ bf16* tile(int k) const {
    return reinterpret_cast<bf16*>(A + 2 * G::kSlabF) + k * G::kTile;
  }
};

// Bytes of BandSmem for NP = np (the launches' size).
inline constexpr size_t band_smem_bytes(size_t np, bool split3) {
  const size_t ldb = np + 8, ldf = np + 4;
  return 2 * kSlab * ldf * sizeof(float) + 4 * kSlab * ldb * sizeof(bf16) +
         band_stage_bytes(np, split3) + kBandBars * sizeof(uint64_t) +
         (2 * np + 2 * (np / kSlab)) * sizeof(float);
}

// The calling warp's tile of the slab's 32 x NP output: rows
// [row0, row0 + 16), columns [col0, col0 + 8 NT).
template <int NP>
__device__ __forceinline__ WarpTile band_warp_tile() {
  const int w = threadIdx.x >> 5;
  return {16 * (w >> 2), (w & 3) * (NP / 4), true};
}

// Walk the kChunks 16-row k-chunks of a right operand whose parts (NPARTS
// buffers of element type E, EPC elements a chunk) have chunk c at
// parts[p] + (c & 1) * EPC in CTA c / 2: body(c, chunk) with chunk[p] a
// local pointer to part p of chunk c (in place when this CTA owns it,
// else in the staging area).  The cluster has passed a barrier since the
// parts were written, and every peer has finished its previous walk.  CTA
// `rank` takes the chunks in the order c = 2 rank + j (mod kChunks), its
// own two first, then the peer rank + d's two for d = 1 .. C - 1.  At the
// start (and at each further window) this CTA pushes its two chunks to the
// peers that read them next, and lane d - 1 of warp 0 arms the barrier of
// peer slab d with the bytes of its two chunks; `parity` is the barriers'
// phase, one a walk.  The block has passed a barrier since the last body
// when it returns.
template <int NP, bool SPLIT3, int NPARTS, int EPC, class E, class Body>
__device__ __forceinline__ void over_chunks(E* const (&parts)[NPARTS],
                                            const BandSmem<NP, SPLIT3>& sm,
                                            int rank, uint32_t& parity,
                                            Body body) {
  using G = BandGeometry<NP>;
  constexpr int C = G::C;
  constexpr uint32_t kPart = EPC * sizeof(E);      // a part of a chunk
  constexpr uint32_t kPeer = 2 * NPARTS * kPart;  // a peer's two chunks
  static_assert(kPart % 16 == 0, "16-byte bulk copies");
  constexpr int kFit = static_cast<int>(BandSmem<NP, SPLIT3>::kStage / kPeer);
  static_assert(kFit >= 1, "a peer's chunks fit the staging area");
  constexpr int kWindow = kFit < C - 1 ? kFit : C - 1;  // peers a window
  static_assert(NPARTS * kWindow <= 32, "a copy a lane of warp 0");
  static_assert(NPARTS <= 2, "one or two parts");
  const int tid = threadIdx.x;
  // warp 0: this CTA's two chunks of each part, contiguous in its slab
  // tile, in one copy a part to each peer that sees it at distance
  // d = first .. first + kWindow - 1, into the slot part p of d's place
  auto push = [&](int first) {
    const int i = tid;
    if (i < NPARTS * kWindow) {
      const int d = first + i / NPARTS, p = i % NPARTS;
      if (d < C) {
        const int peer = (rank - d + C) % C;
        // parts[p] without a run-time index (no local-memory copy)
        E* const part = p == 0 ? parts[0] : parts[NPARTS - 1];
        push_bulk(peer_addr(sm.stage + (d - first) * kPeer + 2 * p * kPart,
                            peer),
                  part, 2 * kPart, peer_addr(sm.bars + d - 1, peer));
      }
    }
  };
  if (tid < C - 1) mbar_arm(sm.bars + tid, kPeer);
  push(1);
#pragma unroll 1
  for (int j = 0; j < G::kChunks; ++j) {
    const int d = j >> 1;  // the walk's owner: rank + d
    const int first = d > 0 ? 1 + (d - 1) / kWindow * kWindow : 0;
    if (d > 0 && (j & 1) == 0) {
      if (d == first && d > 1) {  // a new window: its slots are free
        cluster_sync();
        push(first);
      }
      mbar_wait(sm.bars + d - 1, parity);
    }
    const int c = (2 * rank + j) % G::kChunks;
    const E* chunk[NPARTS];
#pragma unroll
    for (int p = 0; p < NPARTS; ++p)
      chunk[p] = (d == 0 ? parts[p]
                         : reinterpret_cast<const E*>(
                               sm.stage + (d - first) * kPeer) +
                               2 * p * EPC) +
                 (j & 1) * EPC;
    body(c, chunk);
  }
  parity ^= 1;
  __syncthreads();
}

// The right operand's fragments of a bf16 chunk B (16 rows of stride LDB,
// stored [k][n]) for the warp's NT n8 tiles from col0: b[j] for tile j, an
// odd NT ending on one ldmatrix.x2.  Every load is issued before any MMA
// that reads it, so one load latency a chunk is exposed, not one a pair of
// tiles.
template <int NP>
__device__ __forceinline__ void band_frag_b(
    uint32_t (&b)[BandGeometry<NP>::NT][2], const bf16* B, int col0) {
  using G = BandGeometry<NP>;
  const int lane = threadIdx.x & 31;
  const bf16* p = B + (lane & 15) * G::LDB + col0;
#pragma unroll
  for (int j = 0; j + 1 < G::NT; j += 2) {
    uint32_t r[4];
    ldsm_x4_trans(r, p + 8 * j + (lane >> 4) * 8);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
  if constexpr (G::NT % 2 == 1)
    ldsm_x2_trans(b[G::NT - 1], p + 8 * (G::NT - 1));
}

// acc[0][j] += a b[j] for j < NT.
template <int NP>
__device__ __forceinline__ void band_mma_k16(
    float (&acc)[1][BandGeometry<NP>::NT][4], const uint32_t (&a)[4],
    const uint32_t (&b)[BandGeometry<NP>::NT][2]) {
#pragma unroll
  for (int j = 0; j < BandGeometry<NP>::NT; ++j)
    mma_bf16(acc[0][j], a, b[j][0], b[j][1]);
}

// acc = L R over k < NP in one pass: L the CTA's bf16 slab tile, R a bf16
// operand in the cluster's slab tiles at `right`.
template <int NP, bool SPLIT3>
__device__ __forceinline__ void band_mma_one(
    float (&acc)[1][BandGeometry<NP>::NT][4], const bf16* L, bf16* right,
    const BandSmem<NP, SPLIT3>& sm, int rank, uint32_t& parity,
    WarpTile w) {
  using G = BandGeometry<NP>;
  zero_tile(acc);
  bf16* const parts[1] = {right};
  over_chunks<NP, SPLIT3, 1, 16 * G::LDB>(
      parts, sm, rank, parity, [&](int c, const bf16* const (&chunk)[1]) {
        uint32_t a[4], b[G::NT][2];
        frag_a_bf16(a, L, G::LDB, w.row0, 16 * c);
        band_frag_b<NP>(b, chunk[0], w.col0);
        band_mma_k16<NP>(acc, a, b);
      });
}

// The 3-pass split acc = hi(L) hi(Y) + lo(L) hi(Y) + hi(L) lo(Y): the
// left operand's two parts at (row0, k0) from load_l(hi, lo, row0, k0),
// Y's halves in the cluster's slab tiles Yh and Yl.  Each chunk's
// fragments load once; lo(Y)'s while the first MMAs run.
template <int NP, bool SPLIT3, class LoadL>
__device__ __forceinline__ void band_mma_split3(
    float (&acc)[1][BandGeometry<NP>::NT][4], LoadL load_l, bf16* Yh,
    bf16* Yl, const BandSmem<NP, SPLIT3>& sm, int rank, uint32_t& parity,
    WarpTile w) {
  using G = BandGeometry<NP>;
  zero_tile(acc);
  bf16* const parts[2] = {Yh, Yl};
  over_chunks<NP, SPLIT3, 2, 16 * G::LDB>(
      parts, sm, rank, parity, [&](int c, const bf16* const (&chunk)[2]) {
        uint32_t hi[4], lo[4], bh[G::NT][2], bl[G::NT][2];
        load_l(hi, lo, w.row0, 16 * c);
        band_frag_b<NP>(bh, chunk[0], w.col0);
        band_mma_k16<NP>(acc, hi, bh);
        band_frag_b<NP>(bl, chunk[1], w.col0);
        band_mma_k16<NP>(acc, lo, bh);
        band_mma_k16<NP>(acc, hi, bl);
      });
}

// Component u of v.
__device__ __forceinline__ float f4_at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// R = I - A X for the CTA's slab on CUDA cores, A from the local fp32
// slab, X from the cluster's fp32 slabs Xf; accumulated in fp64 for the
// split3 schedule (fp32 for bf16), each sum in the walk's order over k,
// and rounded to fp32.  Warp w takes rows [8 (w / 2), 8 (w / 2) + 8) and
// the column half h = w % 2 (NH = NP / 2 columns); lane (s, l) = (lane /
// 16, lane % 16) owns rows 8 (w / 2) + 4 s + p (p < 4) and NT columns of
// the half: 4 l + q (q < 4), then 64 + 2 l + q' (q' < 2) where the half
// has 96 or 112 columns, and 64 + l (NH = 80) or 96 + l (NH = 112).  A
// comes 4 k steps a 16-byte load, X a row as one 16-, one 8- and one
// 4-byte load.  R goes into T as bf16 (and its lo part into Tl when
// SPLIT3).
template <int NP, bool SPLIT3>
__device__ __forceinline__ void band_residual(const BandSmem<NP, SPLIT3>& sm,
                                              int n, int rank,
                                              uint32_t& parity) {
  using G = BandGeometry<NP>;
  using Acc = std::conditional_t<SPLIT3, double, float>;
  constexpr int NQ = G::NT;
  constexpr int NH = NP / 2;
  constexpr int kTail = NH - 64;  // 16, 32 or 48 columns past the float4s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 8 * (warp >> 1) + 4 * (lane >> 4);
  const int col0 = (warp & 1) * NH;
  const int l = lane & 15;
  auto column = [&](int q) {
    return col0 + (q < 4               ? 4 * l + q
                   : kTail == 16       ? 64 + l
                   : q < 6             ? 64 + 2 * l + (q - 4)
                                       : 96 + l);
  };
  Acc acc[4][NQ];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[p][q] = 0;
  float* const parts[1] = {sm.Xf};
  over_chunks<NP, SPLIT3, 1, 16 * G::LDF>(
      parts, sm, rank, parity, [&](int c, const float* const (&chunk)[1]) {
#pragma unroll
        for (int k4 = 0; k4 < 16; k4 += 4) {
          float4 a4[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            a4[p] = *reinterpret_cast<const float4*>(
                sm.A + (row0 + p) * G::LDF + 16 * c + k4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* xr = chunk[0] + (k4 + u) * G::LDF + col0;
            float x[NQ];
            const float4 x4 = *reinterpret_cast<const float4*>(xr + 4 * l);
            x[0] = x4.x;
            x[1] = x4.y;
            x[2] = x4.z;
            x[3] = x4.w;
            if constexpr (kTail == 16) {
              x[4] = xr[64 + l];
            } else {
              const float2 x2 =
                  *reinterpret_cast<const float2*>(xr + 64 + 2 * l);
              x[4] = x2.x;
              x[5] = x2.y;
              if constexpr (kTail == 48) x[6] = xr[96 + l];
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const Acc a = f4_at(a4[p], u);
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                if constexpr (SPLIT3)
                  acc[p][q] = __fma_rn(a, static_cast<Acc>(x[q]), acc[p][q]);
                else
                  acc[p][q] = fmaf(a, x[q], acc[p][q]);
              }
            }
          }
        }
      });
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = row0 + p, j = column(q);
      const int gi = kSlab * rank + i;
      float v = 0.f;
      if (gi < n && j < n) {
        if constexpr (SPLIT3)
          v = static_cast<float>((gi == j ? 1.0 : 0.0) - acc[p][q]);
        else
          v = __fsub_rn(gi == j ? 1.f : 0.f, acc[p][q]);
      }
      sm.T[i * G::LDB + j] = __float2bfloat16_rn(v);
      if constexpr (SPLIT3) sm.Tl[i * G::LDB + j] = __float2bfloat16_rn(bf16_rem(v));
    }
}

// A[i][j] = f(gi, j) for the slab's rows gi = 32 rank + i and j < n, zero
// padded to NP, in fp32 (sm.A) and, for the bf16 schedules, bf16 (sm.Ah).
// The loop unrolls, so a thread's NP / 8 loads are in flight at once.  The
// next cluster barrier orders it before the loop's reads.
template <int NP, bool SPLIT3, class F>
__device__ __forceinline__ void band_stage(const BandSmem<NP, SPLIT3>& sm,
                                           int n, int rank, F f) {
  using G = BandGeometry<NP>;
  static_assert(kSlab * NP % kThreads == 0, "whole passes");
#pragma unroll
  for (int x = threadIdx.x; x < kSlab * NP; x += kThreads) {
    const int i = x / NP, j = x % NP;
    const int gi = kSlab * rank + i;
    const float v = (gi < n && j < n) ? f(gi, j) : 0.f;
    sm.A[i * G::LDF + j] = v;
    if constexpr (!SPLIT3) sm.Ah[i * G::LDB + j] = __float2bfloat16_rn(v);
  }
}

// The slab's rows of the n x n matrix src (device memory) into the warps'
// fragments, zero in the padding.
template <int NP>
__device__ __forceinline__ void band_load_x(
    float (&xm)[1][BandGeometry<NP>::NT][4], const float* src, int n,
    int rank, WarpTile w) {
  tile_for_each(xm, w, [&](int i, int j, float& v) {
    const int gi = kSlab * rank + i;
    v = (gi < n && j < n) ? src[static_cast<size_t>(gi) * n + j] : 0.f;
  });
}

// The slab's rows of X (sm.Xf) into the n x n matrix dst (device memory).
template <int NP, bool SPLIT3>
__device__ __forceinline__ void band_store_x(const BandSmem<NP, SPLIT3>& sm,
                                             float* dst, int n, int rank) {
  using G = BandGeometry<NP>;
  const int rows = min(kSlab, n - kSlab * rank);
  float* out = dst + static_cast<size_t>(kSlab) * rank * n;
  for (int x = threadIdx.x; x < rows * n; x += kThreads)
    out[x] = sm.Xf[(x / n) * G::LDF + x % n];
}

// The lo and hi rounds over the cluster, from the slab's rows of X in the
// warps' fragments xm (zero in the padding); ns_mma_rounds' schedule.  On
// entry sm.A (and sm.Ah) hold the slab of A; no peer has been read yet.
// On return sm.Xf holds the slab of the refined X in fp32 and the cluster
// has passed a barrier since it was written.
template <int NP, bool SPLIT3>
__device__ __forceinline__ void band_rounds(
    float (&xm)[1][BandGeometry<NP>::NT][4], const BandSmem<NP, SPLIT3>& sm,
    const NSParams& prm, WarpTile w, int rank) {
  using G = BandGeometry<NP>;
  constexpr int NT = G::NT;
  constexpr int LDB = G::LDB;
  constexpr int LDF = G::LDF;
  const int n = prm.n;
  // the barriers the peers' pushes complete on; the first publish's
  // cluster barrier orders their initialisation before any push
  if (threadIdx.x == 0) {
    for (int d = 0; d < G::C - 1; ++d) mbar_init(sm.bars + d);
    mbar_init_fence();
  }
  uint32_t parity = 0;  // the barriers' phase: one a walk
  auto a_parts = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int row0,
                     int k0) {
    if constexpr (SPLIT3) {
      frag_a_split(hi, lo, sm.A, LDF, row0, k0);
    } else {
      frag_a_bf16(hi, sm.Ah, LDB, row0, k0);
      frag_a_rem(lo, sm.A, LDF, row0, k0);
    }
  };
  auto x_parts = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int row0,
                     int k0) {
    frag_a_bf16(hi, sm.Xh, LDB, row0, k0);
    frag_a_bf16(lo, sm.Xl, LDB, row0, k0);
  };
  // the slab's entries of T or R: (local row, column, value) -> stored
  auto keep = [&](int i, int j, float v, float diag) {
    const int gi = kSlab * rank + i;
    return (gi < n && j < n) ? __fsub_rn(gi == j ? diag : 0.f, v) : 0.f;
  };

  const int rounds = prm.lo + prm.hi;
  auto f32_round = [&](int r) {
    return r == rounds || (SPLIT3 && r >= prm.lo) ||
           (r == rounds - 1 && prm.polish_highest);
  };
  // Publish X for round r (r = rounds: the result) and pass the cluster
  // barrier that makes it visible to the peers.
  auto publish = [&](int r) {
    if (r < rounds) store_tile_bf16(xm, sm.Xh, LDB, w);
    if (r < rounds && (SPLIT3 || (r >= prm.lo && !f32_round(r))))
      store_tile_bf16<1, NT, true>(xm, sm.Xl, LDB, w);
    if (f32_round(r)) store_tile_f32(xm, sm.Xf, LDF, w);
    cluster_sync();
  };
  publish(0);

  float acc[1][NT][4];
  for (int r = 0; r < prm.lo; ++r) {
    // T = 2c I - c^2 (A X), then X = X T
    float tc, c2;
    round_scalars(prm, r, tc, c2);
    if constexpr (SPLIT3)
      band_mma_split3<NP>(acc, a_parts, sm.Xh, sm.Xl, sm, rank, parity, w);
    else
      band_mma_one<NP>(acc, sm.Ah, sm.Xh, sm, rank, parity, w);
    tile_for_each(acc, w, [&](int i, int j, float& v) {
      v = keep(i, j, __fmul_rn(c2, v), tc);
    });
    store_tile_bf16(acc, sm.T, LDB, w);
    if constexpr (SPLIT3) store_tile_bf16<1, NT, true>(acc, sm.Tl, LDB, w);
    cluster_sync();
    if constexpr (SPLIT3)
      band_mma_split3<NP>(xm, x_parts, sm.T, sm.Tl, sm, rank, parity, w);
    else
      band_mma_one<NP>(xm, sm.Xh, sm.T, sm, rank, parity, w);
    publish(r + 1);
  }
  for (int r = prm.lo; r < rounds; ++r) {
    // R = I - A X (fp32 or fp64 on CUDA cores, or the 3-pass split),
    // then X = X + X R
    if (f32_round(r)) {
      band_residual<NP, SPLIT3>(sm, n, rank, parity);
    } else {
      band_mma_split3<NP>(acc, a_parts, sm.Xh, sm.Xl, sm, rank, parity, w);
      tile_for_each(acc, w, [&](int i, int j, float& v) {
        v = keep(i, j, v, 1.f);
      });
      store_tile_bf16(acc, sm.T, LDB, w);
    }
    cluster_sync();
    if constexpr (SPLIT3)
      band_mma_split3<NP>(acc, x_parts, sm.T, sm.Tl, sm, rank, parity, w);
    else
      band_mma_one<NP>(acc, sm.Xh, sm.T, sm, rank, parity, w);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xm[0][j][q] = __fadd_rn(xm[0][j][q], acc[0][j][q]);
    publish(r + 1);
  }
}

// Launch `kernel` as batch clusters of C CTAs (kThreads threads, `smem`
// bytes of dynamic shared memory each) on `stream`; the launch's error.
template <typename Kernel, typename... Args>
cudaError_t band_launch(Kernel kernel, int clusters, int batch, size_t smem,
                        cudaStream_t stream, Args... args) {
  return cluster_launch(kernel, clusters, batch, kThreads, smem, stream,
                        args...);
}

}  // namespace
