// The Newton-Schulz round loop of ns_mma_rounds.cuh spread over a
// thread-block cluster, for 129 <= n <= 224, where one block's 227 KB of
// shared memory cannot hold the single-block layout (ns_smem_bytes: 310.6
// KB at NP = 160, 444.8 at 192, 602.9 at 224).  K8 (newton_schulz.cu) and
// K11 (gp.cu) run it there; the loop takes a seed in the fragments as the
// single-block one does, so K1 and K6 can run on it too.
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
// a peer's shared memory, so each peer chunk is copied (ld.shared::cluster,
// 16 bytes a thread and load) into a local ring of two chunks, one chunk
// ahead of the MMAs that read the other, one barrier a chunk; a chunk the
// CTA owns is read in place.  Each CTA starts the walk at its own slab, so
// no two CTAs read one owner at once.  The MMAs are ns_mma.cuh's fragments,
// unchanged.  The fp32 residual R = I - A X runs on CUDA cores over chunks
// of X in fp32 through the same ring; the split3 schedule accumulates it
// in fp64, as linalg.residual_f64 does on the routes past the kernels:
// past n = 128 an fp32 residual leaves the kappa = 500 class over the
// 1e-4 gate (1.05e-4 at n = 224 in the plain version).
//
// Barriers.  A publish (X into the slab tiles) and a T/R store end in a
// cluster barrier (barrier.cluster.arrive.release / wait.acquire), two a
// round; every peer read of a buffer lies between the barrier that
// published it and the next barrier of the CTA that overwrites it.  The
// last publish is that barrier for the final X, so no CTA exits while a
// peer may still read its slab.
//
// Shared memory a CTA (LDF = NP + 4 fp32, LDB = NP + 8 bf16 a row): A and
// Xf in fp32 (32 x LDF each), four bf16 slab tiles (as ns_mma_rounds.cuh:
// bf16 Ah, Xh, T, Xl; split3 Tl, Xh, T, Xl), the ring (two chunks of two
// bf16 parts, or of fp32 X), then K11's [d a] and the cluster's partial
// sums: 105.3 / 125.5 / 145.8 KB at NP = 160 / 192 / 224.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>

#include "ns_common.cuh"
#include "ns_mma.cuh"

namespace {

constexpr int kBandMaxN = 224;  // the JAX warm kernels' ceiling
constexpr int kSlab = 32;       // rows a CTA owns

// NP for 129 <= n <= 224.
inline int band_np(int n) { return n <= 160 ? 160 : n <= 192 ? 192 : 224; }

template <int NP>
struct BandGeometry {
  static_assert(NP % kSlab == 0 && NP <= kBandMaxN, "NP = 32 C");
  static constexpr int C = NP / kSlab;  // CTAs a cluster
  static constexpr int NT = NP / 32;    // n8 tiles a warp
  static constexpr int LDB = NP + 8;    // bf16 row stride
  static constexpr int LDF = NP + 4;    // fp32 row stride
  static constexpr int kChunks = NP / 16;
  static constexpr int kTile = kSlab * LDB;  // bf16 slab tile, elements
  static constexpr int kSlabF = kSlab * LDF;  // fp32 slab, elements
  static constexpr size_t kRingBytes =
      2 * 16 * LDB * sizeof(bf16) * 2 > 2 * 16 * LDF * sizeof(float)
          ? 2 * 16 * LDB * sizeof(bf16) * 2
          : 2 * 16 * LDF * sizeof(float);
};

template <int NP, bool SPLIT3>
struct BandSmem {
  using G = BandGeometry<NP>;
  float* A;
  float* Xf;
  bf16* Ah;  // bf16 only
  bf16* Xh;
  bf16* T;
  bf16* Xl;
  bf16* Tl;  // split3 only
  unsigned char* ring;
  float* rest;  // K11: d at [0, NP), a at [NP, 2 NP), partials past them
  __device__ explicit BandSmem(unsigned char* base)
      : A(reinterpret_cast<float*>(base)),
        Xf(A + G::kSlabF),
        Ah(SPLIT3 ? nullptr : tile(0)),
        Xh(tile(1)),
        T(tile(2)),
        Xl(tile(3)),
        Tl(SPLIT3 ? tile(0) : nullptr),
        ring(reinterpret_cast<unsigned char*>(tile(4))),
        rest(reinterpret_cast<float*>(ring + G::kRingBytes)) {}
  __device__ bf16* tile(int k) const {
    return reinterpret_cast<bf16*>(A + 2 * G::kSlabF) + k * G::kTile;
  }
};

// Bytes of BandSmem for NP = np (the launches' size).
inline constexpr size_t band_smem_bytes(size_t np) {
  const size_t ldb = np + 8, ldf = np + 4;
  const size_t ring = 4 * 16 * ldb * 2 > 2 * 16 * ldf * 4 ? 4 * 16 * ldb * 2
                                                          : 2 * 16 * ldf * 4;
  return 2 * kSlab * ldf * sizeof(float) + 4 * kSlab * ldb * sizeof(bf16) +
         ring + (2 * np + 2 * (np / kSlab)) * sizeof(float);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// The shared::cluster address of `p` (a local shared address) in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ uint4 ld_peer16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_peer_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
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
// else in the ring).  CTA `rank` takes the chunks in the order
// c = 2 rank + j (mod kChunks), its own two first: at every step the
// cluster's CTAs read from distinct owners.  The copy of the next chunk is
// in flight while body runs on this one; one barrier a chunk, and the
// block has passed a barrier since the last body when it returns.
template <int NP, int NPARTS, int EPC, class E, class Body>
__device__ __forceinline__ void over_chunks(E* const (&parts)[NPARTS],
                                            unsigned char* ring, int rank,
                                            Body body) {
  using G = BandGeometry<NP>;
  constexpr int kVec = EPC * static_cast<int>(sizeof(E)) / 16;  // a part
  static_assert(EPC * sizeof(E) % 16 == 0, "16-byte copies");
  constexpr int kPer = (NPARTS * kVec + kThreads - 1) / kThreads;
  static_assert(2 * NPARTS * EPC * sizeof(E) <= G::kRingBytes, "ring");
  E* slots = reinterpret_cast<E*>(ring);
  const int tid = threadIdx.x;
  auto chunk_at = [&](int j) { return (2 * rank + j) % G::kChunks; };
  uint4 buf[kPer];
  // the j-th chunk of the walk into registers, then into ring slot j & 1
  auto fetch = [&](int j) {
    const int c = chunk_at(j), owner = c >> 1;
    if (owner == rank) return;
    uint32_t src[NPARTS];
#pragma unroll
    for (int p = 0; p < NPARTS; ++p)
      src[p] = peer_addr(parts[p] + (c & 1) * EPC, owner);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < NPARTS * kVec)
        buf[i] = ld_peer16(src[v / kVec] + 16 * (v % kVec));
    }
  };
  auto stash = [&](int j) {
    if ((chunk_at(j) >> 1) == rank) return;
    uint4* dst = reinterpret_cast<uint4*>(slots + (j & 1) * NPARTS * EPC);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < NPARTS * kVec) dst[v] = buf[i];
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < G::kChunks; ++j) {
    if (j + 1 < G::kChunks) fetch(j + 1);
    const int c = chunk_at(j);
    const E* chunk[NPARTS];
    const bool own = (c >> 1) == rank;
#pragma unroll
    for (int p = 0; p < NPARTS; ++p)
      chunk[p] = own ? parts[p] + (c & 1) * EPC
                     : slots + ((j & 1) * NPARTS + p) * EPC;
    body(c, chunk);
    if (j + 1 < G::kChunks) stash(j + 1);
    __syncthreads();
  }
}

// acc[0][j] += a B[0:16, col0 + 8j : col0 + 8j + 8] for j < NT, B a bf16
// chunk (16 rows of stride LDB) stored [k][n]; an odd NT ends on one
// ldmatrix.x2.
template <int NP>
__device__ __forceinline__ void band_mma_k16(
    float (&acc)[1][BandGeometry<NP>::NT][4], const uint32_t (&a)[4],
    const bf16* B, int col0) {
  using G = BandGeometry<NP>;
  const int lane = threadIdx.x & 31;
  const bf16* p = B + (lane & 15) * G::LDB + col0;
#pragma unroll
  for (int j = 0; j + 1 < G::NT; j += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + 8 * j + (lane >> 4) * 8);
    mma_bf16(acc[0][j], a, b[0], b[1]);
    mma_bf16(acc[0][j + 1], a, b[2], b[3]);
  }
  if constexpr (G::NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, p + 8 * (G::NT - 1));
    mma_bf16(acc[0][G::NT - 1], a, b[0], b[1]);
  }
}

// acc = L R over k < NP in one pass: L the CTA's bf16 slab tile, R a bf16
// operand in the cluster's slab tiles at `right`.
template <int NP>
__device__ __forceinline__ void band_mma_one(
    float (&acc)[1][BandGeometry<NP>::NT][4], const bf16* L, bf16* right,
    unsigned char* ring, int rank, WarpTile w) {
  using G = BandGeometry<NP>;
  zero_tile(acc);
  bf16* const parts[1] = {right};
  over_chunks<NP, 1, 16 * G::LDB>(
      parts, ring, rank, [&](int c, const bf16* const (&chunk)[1]) {
        uint32_t a[4];
        frag_a_bf16(a, L, G::LDB, w.row0, 16 * c);
        band_mma_k16<NP>(acc, a, chunk[0], w.col0);
      });
}

// The 3-pass split acc = hi(L) hi(Y) + lo(L) hi(Y) + hi(L) lo(Y): the
// left operand's two parts at (row0, k0) from load_l(hi, lo, row0, k0),
// Y's halves in the cluster's slab tiles Yh and Yl.
template <int NP, class LoadL>
__device__ __forceinline__ void band_mma_split3(
    float (&acc)[1][BandGeometry<NP>::NT][4], LoadL load_l, bf16* Yh,
    bf16* Yl, unsigned char* ring, int rank, WarpTile w) {
  using G = BandGeometry<NP>;
  zero_tile(acc);
  bf16* const parts[2] = {Yh, Yl};
  over_chunks<NP, 2, 16 * G::LDB>(
      parts, ring, rank, [&](int c, const bf16* const (&chunk)[2]) {
        uint32_t hi[4], lo[4];
        load_l(hi, lo, w.row0, 16 * c);
        band_mma_k16<NP>(acc, hi, chunk[0], w.col0);
        band_mma_k16<NP>(acc, lo, chunk[0], w.col0);
        band_mma_k16<NP>(acc, hi, chunk[1], w.col0);
      });
}

// R = I - A X for the CTA's slab on CUDA cores, A from the local fp32
// slab, X from the cluster's fp32 slabs Xf; accumulated in fp64 for the
// split3 schedule (fp32 for bf16), each sum in the walk's order over k,
// and rounded to fp32.  Thread (ty, tx) = (warp, lane) owns rows ty + 8p
// (p < 4), columns tx + 32q (q < NT).  R goes into T as bf16 (and its lo
// part into Tl when SPLIT3).
template <int NP, bool SPLIT3>
__device__ __forceinline__ void band_residual(const BandSmem<NP, SPLIT3>& sm,
                                              int n, int rank) {
  using G = BandGeometry<NP>;
  using Acc = std::conditional_t<SPLIT3, double, float>;
  constexpr int NQ = G::NT;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  Acc acc[4][NQ];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[p][q] = 0;
  float* const parts[1] = {sm.Xf};
  over_chunks<NP, 1, 16 * G::LDF>(
      parts, sm.ring, rank, [&](int c, const float* const (&chunk)[1]) {
#pragma unroll 4
        for (int kk = 0; kk < 16; ++kk) {
          const int k = 16 * c + kk;
          Acc a[4], x[NQ];
#pragma unroll
          for (int p = 0; p < 4; ++p) a[p] = sm.A[(ty + 8 * p) * G::LDF + k];
#pragma unroll
          for (int q = 0; q < NQ; ++q) x[q] = chunk[0][kk * G::LDF + tx + 32 * q];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if constexpr (SPLIT3)
                acc[p][q] = __fma_rn(a[p], x[q], acc[p][q]);
              else
                acc[p][q] = fmaf(a[p], x[q], acc[p][q]);
            }
        }
      });
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = ty + 8 * p, j = tx + 32 * q;
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
// The next cluster barrier orders it before the loop's reads.
template <int NP, bool SPLIT3, class F>
__device__ __forceinline__ void band_stage(const BandSmem<NP, SPLIT3>& sm,
                                           int n, int rank, F f) {
  using G = BandGeometry<NP>;
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
    const float tc = prm.two_c[r], c2 = prm.c_sq[r];
    if constexpr (SPLIT3)
      band_mma_split3<NP>(acc, a_parts, sm.Xh, sm.Xl, sm.ring, rank, w);
    else
      band_mma_one<NP>(acc, sm.Ah, sm.Xh, sm.ring, rank, w);
    tile_for_each(acc, w, [&](int i, int j, float& v) {
      v = keep(i, j, __fmul_rn(c2, v), tc);
    });
    store_tile_bf16(acc, sm.T, LDB, w);
    if constexpr (SPLIT3) store_tile_bf16<1, NT, true>(acc, sm.Tl, LDB, w);
    cluster_sync();
    if constexpr (SPLIT3)
      band_mma_split3<NP>(xm, x_parts, sm.T, sm.Tl, sm.ring, rank, w);
    else
      band_mma_one<NP>(xm, sm.Xh, sm.T, sm.ring, rank, w);
    publish(r + 1);
  }
  for (int r = prm.lo; r < rounds; ++r) {
    // R = I - A X (fp32 or fp64 on CUDA cores, or the 3-pass split),
    // then X = X + X R
    if (f32_round(r)) {
      band_residual<NP, SPLIT3>(sm, n, rank);
    } else {
      band_mma_split3<NP>(acc, a_parts, sm.Xh, sm.Xl, sm.ring, rank, w);
      tile_for_each(acc, w, [&](int i, int j, float& v) {
        v = keep(i, j, v, 1.f);
      });
      store_tile_bf16(acc, sm.T, LDB, w);
    }
    cluster_sync();
    if constexpr (SPLIT3)
      band_mma_split3<NP>(acc, x_parts, sm.T, sm.Tl, sm.ring, rank, w);
    else
      band_mma_one<NP>(acc, sm.Xh, sm.T, sm.ring, rank, w);
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
// A cluster the SMs cannot hold fails here, and the caller raises.
template <typename Kernel, typename... Args>
cudaError_t band_launch(Kernel kernel, int clusters, int batch, size_t smem,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
