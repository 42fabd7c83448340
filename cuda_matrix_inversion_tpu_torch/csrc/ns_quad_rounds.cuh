// The cold Newton-Schulz kernels' round loop on a 2 x 2 thread-block
// cluster, for 129 <= n <= 224: K1's (newton_schulz.cu::ns_quad_kernel,
// every schedule) and K6's (gp.cu::gp_ns_quad_kernel) instances past the
// single block.  The warm kernels K8 and K11 keep the slab loop
// (ns_cluster_rounds.cuh).
//
// Geometry.  n pads with zeros to NP in {160, 192, 224}; the matrix is cut
// into four Q x Q quadrants, Q = NP / 2 = 80, 96 or 112, and CTA rank =
// 2p + q of a cluster of four owns quadrant (p, q) of A, X and T or R.
// Its row peer (p, 1 - q) is rank ^ 1, its column peer (1 - p, q) rank ^ 2.
// Warp w < Q / 16 owns the output rows [16 w, 16 w + 16) of every product
// as one m16 tile by Q / 8 n8 tiles (ns_mma.cuh's fragments, unchanged);
// the fp32 master X lives in those fragments, as in the other loops.
//
// Products.  P = L R gives P_pq = L_p0 R_0q + L_p1 R_1q: the term whose
// left part this CTA owns (k = q) and the term whose left part is the row
// peer's (k = 1 - q).  The right parts of the two terms are R_qq and
// R_(1-q)q: one is this CTA's, the other the column peer's.  So a product
// needs one quadrant of L from the row peer and one of R from the column
// peer, and a diagonal CTA (p = q) has one whole term at home.  The owners
// push: after the cluster barrier that published an operand, one thread
// issues a bulk copy a part (cp.async.bulk shared::cluster, the whole
// quadrant tile) into the peer's staging slot, completing on the peer's
// mbarrier for this CTA's pushes, which the peer arms with the bytes it
// expects.  Each CTA runs its wholly local term first (a diagonal CTA:
// its own term; an off-diagonal CTA: the term with a resident left part
// where there is one), then waits on the slots the other term reads.
// Each sum runs over k term by term and, inside a term, in order.
// A never changes, so its remote quadrant A_p(1-q) is never pushed: the
// bf16 schedules keep its bf16 part in a slot (read once from device
// memory), and every product that needs its fp32 value (the 3-pass split
// of A X, the fp32 residual) reads it from device memory (L2) into a
// dead slot pair while the local term runs.
//
// The 3-pass split of X T (split3) needs four remote parts (hi and lo of X
// from the row peer, of T from the column peer), two more than the
// staging slots hold: the row peer's go into A's own slot pair, which
// split3 reloads from device memory at every A X and residual as it does
// A's remote quadrant.  A 3-pass term loads each k step's left fragments
// once and its right hi fragments once for their two MMAs.
//
// The fp32 residual R = I - A X runs on CUDA cores (fp64 accumulation for
// the split3 schedule, as the slab loop and linalg.residual_f64): X is
// published in fp32 over two slots and pushed to the column peer, whole.
// Thread (rg, l) = (tid / 16, tid % 16) owns rows rg + 16 i and columns
// l + 16 j (i, j < Q / 16): one 16-byte load of A feeds 4 k steps of its
// rows (two rows a warp: no bank conflict), X comes as one 4-byte load a
// column (16 consecutive floats a half-warp).
//
// Barriers (W10 of cluster_common.cuh).  A publish of X and a store of T
// or R end in a cluster barrier; a publish also starts with one, which
// proves that every push out of the X slots of the product before has
// landed (the receivers waited for them before they arrived), except in
// the bf16 schedules' lo rounds, where X's bf16 part takes slots 2 and 3
// in turn (its lo part is unused there) and so overwrites the slot of two
// rounds back, two cluster barriers after its last push.  Every push
// lies between the cluster barrier that published its source and the next
// barrier, and every receiver waits for all its pushes before it arrives
// at the next barrier, so no push fills a slot a peer may still read and
// no CTA overwrites a source a push may still copy.
// tests/test_torch_cold_band.py replays this schedule.
//
// Shared memory a CTA, in slots of one bf16 quadrant tile (Q x (Q + 8)
// bf16; an fp32 quadrant, Q x (Q + 8) floats, is two slots): A (fp32,
// slots 0-1; split3's X T takes the row peer's X there), X's bf16 part (2)
// and lo part (3), T or R (4), A's remote bf16 part (bf16 schedules) or
// T's lo part (split3) (5), the staging slots S0 (6) and S1 (7), two
// mbarriers (one a peer's pushes), then K6's [d a] and the partial sums.
// The fp32 publishes of X lie over slots 2-3, the remote quadrant of A
// over 4-5 and the column peer's X over 6-7: 217,808 / 162,128 / 114,640
// bytes at NP = 224 / 192 / 160, one CTA an SM (two at NP = 160 for the
// bf16 schedules).

#pragma once

#include <cstdint>
#include <type_traits>

#include "cluster_common.cuh"
#include "ns_common.cuh"
#include "ns_mma.cuh"

namespace {

constexpr int kQuadCtas = 4;  // the 2 x 2 grid of quadrants

template <int NP>
struct QuadGeometry {
  static_assert(NP % 32 == 0 && NP <= kBandMaxN, "NP = 32 k");
  static constexpr int Q = NP / 2;      // the quadrant's side
  static constexpr int MT = Q / 16;     // m16 row tiles: warps with a tile
  static constexpr int NT = Q / 8;      // n8 tiles a warp
  static constexpr int QT = Q / 16;     // the residual's thread tile side
  static constexpr int LD = Q + 8;      // row stride, bf16 and fp32
  static constexpr int kSlot = Q * LD;  // elements of a bf16 slot
  static constexpr uint32_t kSlotBytes = kSlot * 2;
  static constexpr uint32_t kAreaBytes = 2 * kSlotBytes;  // an fp32 quadrant
  static_assert(MT <= kThreads / 32 && NT % 2 == 0, "a warp a row tile");
  static_assert(QT * 16 == Q, "16 x 16 threads over the residual");
};

// Slots of QuadSmem; the fp32 areas start at kAF, kF0, kF1 and kF2.
enum : int {
  kAF = 0,  // A's own quadrant in fp32 (slots 0-1; split3's X T: the row
            // peer's X hi and lo)
  kXH = 2,  // X's bf16 part; with kXL the fp32 X (kF0)
  kXL = 3,  // X's lo part (bf16 lo rounds: X's bf16 part in turn)
  kTT = 4,  // T or R; with kT3 the remote quadrant of A in fp32 (kF1)
  kT3 = 5,  // A's remote bf16 part (bf16) or T's lo part (split3)
  kS0 = 6,  // staging; with kS1 the column peer's X in fp32 (kF2)
  kS1 = 7,  // staging
  kF0 = kXH,
  kF1 = kTT,
  kF2 = kS0,
};

template <int NP>
struct QuadSmem {
  using G = QuadGeometry<NP>;
  unsigned char* base;
  uint64_t* bars;  // the two peers' pushes of a product, one barrier each
  // K6: d at [0, NP), a at [NP, 2 NP); the partial sums (8), the seed's
  // partial row and column sums (Q each) and its maxima (8) past them
  float* rest;
  __device__ explicit QuadSmem(unsigned char* b)
      : base(b),
        bars(reinterpret_cast<uint64_t*>(b + 8 * G::kSlotBytes)),
        rest(reinterpret_cast<float*>(bars + 2)) {}
  __device__ bf16* slot(int s) const {
    return reinterpret_cast<bf16*>(base + s * G::kSlotBytes);
  }
  __device__ float* area(int s) const {
    return reinterpret_cast<float*>(base + s * G::kSlotBytes);
  }
  __device__ float* partials() const { return rest + 2 * NP; }
  __device__ float* row_sums() const { return rest + 2 * NP + 8; }
  __device__ float* col_sums() const { return row_sums() + G::Q; }
  __device__ float* maxima() const { return col_sums() + G::Q; }
};

// Bytes of QuadSmem for NP = np (the launches' size).
inline constexpr size_t quad_smem_bytes(size_t np) {
  const size_t q = np / 2;
  return 8 * q * (q + 8) * 2 + 2 * sizeof(uint64_t) +
         (3 * np + 16) * sizeof(float);
}

// The CTA's place in its cluster.
struct QuadCta {
  int rank, p, q;
  bool diag;
  int row_peer, col_peer;
  __device__ QuadCta() {
    rank = cluster_rank();
    p = rank >> 1;
    q = rank & 1;
    diag = p == q;
    row_peer = rank ^ 1;
    col_peer = rank ^ 2;
  }
};

// A in device memory, read as it is (K1).  A source gives the address of
// an element (at) and fixes a loaded quadrant up in shared memory (fix):
// nothing here, K6's adds c to the diagonal.
struct QuadPlainA {
  const float* a;
  int n;
  __device__ const float* at(int i, int j) const {
    return a + static_cast<size_t>(i) * n + j;
  }
  template <int NP>
  __device__ void fix(float*, int, int) const {}
};

// The calling warp's output tile: rows [16 w, 16 w + 16), all Q columns.
template <int NP>
__device__ __forceinline__ WarpTile quad_warp_tile() {
  const int w = threadIdx.x >> 5;
  return {16 * w, 0, w < QuadGeometry<NP>::MT};
}

// Start copying the fp32 quadrant at global (gi0, gj0) into the area dst
// (row stride LD) by cp.async, zero in the padding; quad_load_wait
// completes it.  16-byte copies where n % 4 == 0 and the matrix starts on
// 16 bytes (the quadrant's columns start on a multiple of 4, so every
// 4-column chunk lies inside the matrix or past it), else 4-byte ones.
template <int NP, class Src>
__device__ __forceinline__ void quad_load_area(float* dst, const Src& src,
                                               int n, int gi0, int gj0) {
  using G = QuadGeometry<NP>;
  constexpr int Q = G::Q, Q4 = Q / 4;
  if ((n & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src.at(0, 0)) & 15) == 0) {
    for (int x = threadIdx.x; x < Q * Q4; x += kThreads) {
      const int i = x / Q4, j = 4 * (x % Q4);
      const int gi = gi0 + i, gj = gj0 + j;
      float* d = dst + i * G::LD + j;
      if (gi < n && gj < n)
        cp_async16(d, src.at(gi, gj));
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int x = threadIdx.x; x < Q * Q; x += kThreads) {
      const int i = x / Q, j = x % Q;
      const int gi = gi0 + i, gj = gj0 + j;
      if (gi < n && gj < n)
        cp_async4(dst + i * G::LD + j, src.at(gi, gj));
      else
        dst[i * G::LD + j] = 0.f;
    }
  }
  cp_async_commit();
}

// This thread's quad_load_area copies landed but for the last PENDING
// ones, then the source's fix-up of dst (the quadrant at global (gi0,
// gj0)); the block has passed a barrier on return.
template <int NP, int PENDING = 0, class Src>
__device__ __forceinline__ void quad_load_wait(const Src& src, float* dst,
                                               int gi0, int gj0) {
  cp_async_wait<PENDING>();
  __syncthreads();
  src.template fix<NP>(dst, gi0, gj0);
  __syncthreads();
}

// The left operand's bf16 fragment at (row0, k0) of an fp32 matrix P (row
// stride ld), rounded as it loads: the hi part of frag_a_split.
__device__ __forceinline__ void frag_a_hi(uint32_t (&hi)[4], const float* P,
                                          int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = P + (row0 + g + 8 * (i & 1)) * ld + k0 + 2 * t +
                     8 * (i >> 1);
    hi[i] = pack_bf16(p[0], p[1]);
  }
}

// Where a one-pass product's left part comes from: a bf16 slot, or an fp32
// area rounded to bf16 as it loads.
enum class LPart { kTile, kHi };

// acc += L R over the quadrant's k in one pass: L the part `kind` of
// `left` (a bf16 slot or an fp32 area), R a bf16 slot.
template <int NP, LPart KIND>
__device__ __forceinline__ void quad_pass(
    float (&acc)[1][QuadGeometry<NP>::NT][4], const void* left,
    const bf16* right, WarpTile w) {
  using G = QuadGeometry<NP>;
#pragma unroll 2
  for (int k0 = 0; k0 < G::Q; k0 += 16) {
    uint32_t a[1][4];
    if constexpr (KIND == LPart::kTile)
      frag_a_bf16(a[0], static_cast<const bf16*>(left), G::LD, w.row0, k0);
    else
      frag_a_hi(a[0], static_cast<const float*>(left), G::LD, w.row0, k0);
    mma_k16<1, G::NT>(acc, a, right, G::LD, k0, 0);
  }
}

// acc += hi(L) hi(R) + lo(L) hi(R) + hi(L) lo(R) over the quadrant's k (the
// 3-pass split of one term): L's two parts from an fp32 area, rounded as
// they load (LEFT_F32), or from the bf16 slots lh and ll; each k step
// loads L's fragments once and R's hi fragments once for their two MMAs.
template <int NP, bool LEFT_F32>
__device__ __forceinline__ void quad_split(
    float (&acc)[1][QuadGeometry<NP>::NT][4], const void* lh, const void* ll,
    const bf16* rh, const bf16* rl, WarpTile w) {
  using G = QuadGeometry<NP>;
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k0 = 0; k0 < G::Q; k0 += 16) {
    uint32_t hi[4], lo[4];
    if constexpr (LEFT_F32) {
      frag_a_split(hi, lo, static_cast<const float*>(lh), G::LD, w.row0, k0);
    } else {
      frag_a_bf16(hi, static_cast<const bf16*>(lh), G::LD, w.row0, k0);
      frag_a_bf16(lo, static_cast<const bf16*>(ll), G::LD, w.row0, k0);
    }
    const int at = (k0 + (lane & 15)) * G::LD + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < G::NT; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, rh + at + 8 * j);
      mma_bf16(acc[0][j], hi, b[0], b[1]);
      mma_bf16(acc[0][j + 1], hi, b[2], b[3]);
      mma_bf16(acc[0][j], lo, b[0], b[1]);
      mma_bf16(acc[0][j + 1], lo, b[2], b[3]);
      ldsm_x4_trans(b, rl + at + 8 * j);
      mma_bf16(acc[0][j], hi, b[0], b[1]);
      mma_bf16(acc[0][j + 1], hi, b[2], b[3]);
    }
  }
}

// The CTA's two mbarriers and their phases: wait(s) blocks until the
// pushes onto barrier s of the current phase have landed; arm(s, bytes)
// is the phase's one arrival.
struct QuadBars {
  uint64_t* bars;
  uint32_t parity[2] = {0, 0};
  __device__ void arm(int s, uint32_t bytes) const {
    mbar_arm(bars + s, bytes);
  }
  __device__ void wait(int s) {
    mbar_wait(bars + s, parity[s]);
    parity[s] ^= 1;
  }
};

// Push this CTA's slot `src` (bytes from its start) into slot `dst` of
// CTA `peer`, completing on the peer's barrier `bar`.
template <int NP>
__device__ __forceinline__ void quad_push(const QuadSmem<NP>& sm, int src,
                                          int peer, int dst, int bar,
                                          uint32_t bytes) {
  push_bulk(peer_addr(sm.slot(dst), peer), sm.slot(src), bytes,
            peer_addr(sm.bars + bar, peer));
}

// The stages of the cold kernels before the rounds: the mbarriers, A's own
// quadrant in fp32 (kAF), for the bf16 schedules A's remote quadrant in
// bf16 (kT3), and for the pan seed (A_qp)^T in fp32 (kF2; K1 only).  The
// block has passed a barrier when it returns; no peer has been touched.
template <int NP, bool SPLIT3, class Src>
__device__ __forceinline__ void quad_stage(const QuadSmem<NP>& sm,
                                           const QuadCta& c, const Src& src,
                                           int n, bool pan) {
  using G = QuadGeometry<NP>;
  constexpr int Q = G::Q, LD = G::LD;
  if (threadIdx.x == 0) {
    mbar_init(sm.bars);
    mbar_init(sm.bars + 1);
    mbar_init_fence();
  }
  quad_load_area<NP>(sm.area(kAF), src, n, c.p * Q, c.q * Q);
  if (pan) {
    // X0's quadrant (p, q) is (A_qp)^T: A's row q Q + j, column p Q + i
    // into (i, j) of kF2 (free until the first push), consecutive threads
    // on consecutive columns of A (K1 only: K6 seeds spd)
    float* dst = sm.area(kF2);
    for (int x = threadIdx.x; x < Q * Q; x += kThreads) {
      const int i = x % Q, j = x / Q;
      const int gi = c.p * Q + i, gj = c.q * Q + j;
      if (gi < n && gj < n)
        cp_async4(dst + i * LD + j, src.at(gj, gi));
      else
        dst[i * LD + j] = 0.f;
    }
    cp_async_commit();
  }
  if constexpr (!SPLIT3) {
    // A's remote quadrant through kF0 (free until the first publish) into
    // its bf16 slot
    float* tmp = sm.area(kF0);
    quad_load_area<NP>(tmp, src, n, c.p * Q, (1 - c.q) * Q);
    quad_load_wait<NP>(src, tmp, c.p * Q, (1 - c.q) * Q);
    bf16* ahr = sm.slot(kT3);
    for (int x = threadIdx.x; x < Q * Q; x += kThreads) {
      const int i = x / Q, j = x % Q;
      ahr[i * LD + j] = __float2bfloat16_rn(tmp[i * LD + j]);
    }
  }
  quad_load_wait<NP>(src, sm.area(kAF), c.p * Q, c.q * Q);
}

// K1's and K6's seed, straight into the warps' fragments xm (zero in the
// padding), as the single-block kernels seed (spd: X1 = 2sI - s^2 A,
// s = 1/||A||_inf; pan: X0 = A^T / (||A||_1 ||A||_inf)), once quad_stage
// has run.  Thread i < Q sums row i and (pan) column i of the own
// quadrant in order and stores the sums in the row peer's (column
// peer's) shared memory; each row (column) sum is then the sum of its two
// halves, which both CTAs of the row (column) add alike; each CTA stores
// its two maxima in every CTA's maxima, and every CTA takes the maximum
// over the four.  The first
// cluster barrier proves every CTA of the cluster running (and the
// mbarriers initialised) before any store into a peer; 3 cluster
// barriers.  `red`: kThreads / 32 floats.
template <int NP>
__device__ __forceinline__ void quad_seed(
    float (&xm)[1][QuadGeometry<NP>::NT][4], const QuadSmem<NP>& sm,
    const QuadCta& c, int n, bool spd, float* red, WarpTile w) {
  using G = QuadGeometry<NP>;
  constexpr int Q = G::Q, LD = G::LD;
  const int tid = threadIdx.x;
  const float* af = sm.area(kAF);
  float rs = 0.f, cs = 0.f;
  if (tid < Q) {
    for (int j = 0; j < Q; ++j) rs += fabsf(af[tid * LD + j]);
    if (!spd)
      for (int i = 0; i < Q; ++i) cs += fabsf(af[i * LD + tid]);
  }
  cluster_sync();
  if (tid < Q) {
    st_peer_f32(peer_addr(sm.row_sums() + tid, c.row_peer), rs);
    if (!spd) st_peer_f32(peer_addr(sm.col_sums() + tid, c.col_peer), cs);
  }
  cluster_sync();
  float rmax = 0.f, cmax = 0.f;
  if (tid < Q) {
    rmax = rs + sm.row_sums()[tid];
    if (!spd) cmax = cs + sm.col_sums()[tid];
  }
  rmax = block_max(rmax, red);
  if (!spd) cmax = block_max(cmax, red);
  if (tid < kQuadCtas) {
    st_peer_f32(peer_addr(sm.maxima() + 2 * c.rank, tid), rmax);
    st_peer_f32(peer_addr(sm.maxima() + 2 * c.rank + 1, tid), cmax);
  }
  cluster_sync();
  float r_inf = 0.f, c_1 = 0.f;
#pragma unroll
  for (int r = 0; r < kQuadCtas; ++r) {
    r_inf = fmaxf(r_inf, sm.maxima()[2 * r]);
    c_1 = fmaxf(c_1, sm.maxima()[2 * r + 1]);
  }
  if (!w.active) return;
  const int gi0 = c.p * Q, gj0 = c.q * Q;
  if (spd) {
    const float s = 1.f / r_inf;
    const float two_s = 2.f * s;
    const float s2 = __fmul_rn(s, s);
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      const int gi = gi0 + i, gj = gj0 + j;
      v = (gi < n && gj < n)
              ? __fsub_rn(gi == gj ? two_s : 0.f, __fmul_rn(s2, af[i * LD + j]))
              : 0.f;
    });
  } else {
    const float scale = 1.f / __fmul_rn(r_inf, c_1);
    const float* at = sm.area(kF2);
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      const int gi = gi0 + i, gj = gj0 + j;
      v = (gi < n && gj < n) ? __fmul_rn(at[i * LD + j], scale) : 0.f;
    });
  }
}

// R = I - A X on CUDA cores for the CTA's quadrant, stored as bf16 into
// kTT (and its lo part into kT3 for split3): thread (rg, l) holds rows
// rg + 16 i and columns l + 16 j (zero in the padding), accumulated in
// fp64 for split3 (fp32 for bf16), the own-X term first.  X's fp32
// quadrant is in kF0, the column peer's arrives in kF2 (pushed from its
// kF0 onto bars[0], armed here), A's remote quadrant is loaded into kF1
// (and for split3 its own into kAF).  The cluster has passed a barrier since kF0 was written; no peer reads
// kTT or kT3 before the next one.
template <int NP, bool SPLIT3, class Src>
__device__ __forceinline__ void quad_residual(const QuadSmem<NP>& sm,
                                              const QuadCta& c,
                                              QuadBars& bars, const Src& src,
                                              int n) {
  using G = QuadGeometry<NP>;
  using Acc = std::conditional_t<SPLIT3, double, float>;
  constexpr int Q = G::Q, LD = G::LD, QT = G::QT;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, l = tid & 15;
  const int gi0 = c.p * Q, gj0 = c.q * Q;
  if constexpr (SPLIT3) quad_load_area<NP>(sm.area(kAF), src, n, gi0, gj0);
  quad_load_area<NP>(sm.area(kF1), src, n, gi0, (1 - c.q) * Q);
  if (tid == 0) {
    bars.arm(0, G::kAreaBytes);
    quad_push(sm, kF0, c.col_peer, kF2, 0, G::kAreaBytes);
  }
  Acc acc[QT][QT];
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[i][j] = 0;
  auto term = [&](const float* a, const float* x) {
#pragma unroll 1
    for (int k4 = 0; k4 < Q; k4 += 4) {
      float4 a4[QT];
#pragma unroll
      for (int i = 0; i < QT; ++i)
        a4[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * LD + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float xv[QT];
#pragma unroll
        for (int j = 0; j < QT; ++j) xv[j] = x[(k4 + u) * LD + l + 16 * j];
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const float av = u == 0   ? a4[i].x
                           : u == 1 ? a4[i].y
                           : u == 2 ? a4[i].z
                                    : a4[i].w;
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            if constexpr (SPLIT3)
              acc[i][j] = __fma_rn(static_cast<Acc>(av),
                                   static_cast<Acc>(xv[j]), acc[i][j]);
            else
              acc[i][j] = fmaf(av, xv[j], acc[i][j]);
          }
        }
      }
    }
  };
  // own X (k = p) pairs with A_pp: own for a diagonal CTA, remote else
  if constexpr (SPLIT3) quad_load_wait<NP, 1>(src, sm.area(kAF), gi0, gj0);
  if (!c.diag) quad_load_wait<NP>(src, sm.area(kF1), gi0, (1 - c.q) * Q);
  term(c.diag ? sm.area(kAF) : sm.area(kF1), sm.area(kF0));
  if (c.diag) quad_load_wait<NP>(src, sm.area(kF1), gi0, (1 - c.q) * Q);
  bars.wait(0);
  term(c.diag ? sm.area(kF1) : sm.area(kAF), sm.area(kF2));
  __syncthreads();  // kTT and kT3 lie over kF1
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int gi = gi0 + rg + 16 * i, gj = gj0 + l + 16 * j;
      float v = 0.f;
      if (gi < n && gj < n) {
        if constexpr (SPLIT3)
          v = static_cast<float>((gi == gj ? 1.0 : 0.0) - acc[i][j]);
        else
          v = __fsub_rn(gi == gj ? 1.f : 0.f, acc[i][j]);
      }
      const int at = (rg + 16 * i) * LD + l + 16 * j;
      sm.slot(kTT)[at] = __float2bfloat16_rn(v);
      if constexpr (SPLIT3)
        sm.slot(kT3)[at] = __float2bfloat16_rn(bf16_rem(v));
    }
}

// The lo and hi rounds over the 2 x 2 cluster, from the quadrant of X in
// the warps' fragments xm (zero in the padding); ns_mma_rounds' schedule.
// On entry quad_stage has run and the cluster has passed a barrier (the
// seed's); on return the area kF0 holds the quadrant of the refined X in
// fp32 and the cluster has passed a barrier since it was written.
template <int NP, bool SPLIT3, class Src>
__device__ __forceinline__ void quad_rounds(
    float (&xm)[1][QuadGeometry<NP>::NT][4], const QuadSmem<NP>& sm,
    const NSParams& prm, const QuadCta& c, const Src& src, WarpTile w) {
  using G = QuadGeometry<NP>;
  constexpr int NT = G::NT, LD = G::LD, Q = G::Q;
  constexpr uint32_t kTile = G::kSlotBytes;
  const int n = prm.n;
  const int tid = threadIdx.x;
  const int gi0 = c.p * Q, gj0 = c.q * Q;
  const bool diag = c.diag;
  QuadBars bars{sm.bars};
  // the quadrant's entries of T or R: (local row, column, value) -> stored
  auto keep = [&](int i, int j, float v, float diag_v) {
    const int gi = gi0 + i, gj = gj0 + j;
    return (gi < n && gj < n) ? __fsub_rn(gi == gj ? diag_v : 0.f, v) : 0.f;
  };
  const int rounds = prm.lo + prm.hi;
  // X's fp32 publish lies over its bf16 slots: it serves a hi round's
  // fp32 residual and the result, never a lo round (hi = 0 included)
  auto f32_round = [&](int r) {
    return r == rounds ||
           (r >= prm.lo &&
            (SPLIT3 || (r == rounds - 1 && prm.polish_highest)));
  };
  // X's bf16 part lies in slot xs: kXH, but in the bf16 schedules' lo
  // rounds (where X's lo part is unused) kXH and kXL in turn.
  int xs = kXH;
  // Publish X for round r (r = rounds: the result) and pass the cluster
  // barrier that makes it visible.  Past round 0 a barrier first proves
  // that the last product's pushes out of the X slots landed; a bf16 lo
  // round following a lo round needs none: it writes the other slot,
  // pushed from two rounds back, and every receiver has waited for those
  // pushes and passed two cluster barriers since.
  auto publish = [&](int r) {
    const bool turn = !SPLIT3 && r > 0 && r < prm.lo;
    if (r > 0 && !turn) cluster_sync();
    xs = turn ? kXH + kXL - xs : kXH;
    if (w.active) {
      if (f32_round(r)) {
        store_tile_f32(xm, sm.area(kF0), LD, w);
      } else {
        store_tile_bf16(xm, sm.slot(xs), LD, w);
        if (SPLIT3 || r >= prm.lo)
          store_tile_bf16<1, NT, true>(xm, sm.slot(kXL), LD, w);
      }
    }
    cluster_sync();
  };
  const bf16* xh = sm.slot(kXH);
  const bf16* xl = sm.slot(kXL);
  const bf16* tt = sm.slot(kTT);
  const bf16* t3 = sm.slot(kT3);
  const bf16* s0 = sm.slot(kS0);
  const bf16* s1 = sm.slot(kS1);
  const float* af = sm.area(kAF);
  const float* f1 = sm.area(kF1);

  // A X in one pass (bf16 lo rounds): A's own part from kAF, its remote
  // bf16 part resident in kT3; the column peer's X into S1.
  auto ax_one = [&](float (&acc)[1][NT][4]) {
    const bf16* x = sm.slot(xs);
    if (tid == 0) {
      bars.arm(1, kTile);
      quad_push(sm, xs, c.col_peer, kS1, 1, kTile);
    }
    zero_tile(acc);
    if (diag) {
      if (w.active) quad_pass<NP, LPart::kHi>(acc, af, x, w);
      bars.wait(1);
      if (w.active) quad_pass<NP, LPart::kTile>(acc, t3, s1, w);
    } else {
      if (w.active) quad_pass<NP, LPart::kTile>(acc, t3, x, w);
      bars.wait(1);
      if (w.active) quad_pass<NP, LPart::kHi>(acc, af, s1, w);
    }
  };
  // A X by the 3-pass split (split3 lo rounds, the bf16 schedules'
  // split residual): A's own parts from kAF, its remote ones from kF1
  // (loaded here; for split3 A's own quadrant too, whose slots took the
  // row peer's X in the last X T); the column peer's X hi and lo into S0
  // and S1.  The block has passed a barrier since the last read of kF1 on
  // return.
  auto wait_af = [&] {
    if constexpr (SPLIT3) quad_load_wait<NP, 1>(src, sm.area(kAF), gi0, gj0);
  };
  auto ax_split = [&](float (&acc)[1][NT][4]) {
    if constexpr (SPLIT3)
      quad_load_area<NP>(sm.area(kAF), src, n, gi0, gj0);
    quad_load_area<NP>(sm.area(kF1), src, n, gi0, (1 - c.q) * Q);
    if (tid == 0) {
      bars.arm(0, kTile);
      quad_push(sm, kXH, c.col_peer, kS0, 0, kTile);
    } else if (tid == 1) {
      bars.arm(1, kTile);
      quad_push(sm, kXL, c.col_peer, kS1, 1, kTile);
    }
    zero_tile(acc);
    auto own_l = [&](const bf16* rh, const bf16* rl) {
      if (w.active) quad_split<NP, true>(acc, af, nullptr, rh, rl, w);
    };
    auto rem_l = [&](const bf16* rh, const bf16* rl) {
      if (w.active) quad_split<NP, true>(acc, f1, nullptr, rh, rl, w);
    };
    if (diag) {
      wait_af();
      own_l(xh, xl);
      quad_load_wait<NP>(src, sm.area(kF1), gi0, (1 - c.q) * Q);
      bars.wait(0);
      bars.wait(1);
      rem_l(s0, s1);
    } else {
      wait_af();
      quad_load_wait<NP>(src, sm.area(kF1), gi0, (1 - c.q) * Q);
      rem_l(xh, xl);
      bars.wait(0);
      bars.wait(1);
      own_l(s0, s1);
    }
    __syncthreads();
  };
  // X T (or X R) in one pass (bf16): the row peer's X into S0, the
  // column peer's T into S1.
  auto xt_one = [&](float (&acc)[1][NT][4]) {
    const bf16* x = sm.slot(xs);
    if (tid == 0) {
      bars.arm(0, kTile);
      quad_push(sm, xs, c.row_peer, kS0, 0, kTile);
    } else if (tid == 1) {
      bars.arm(1, kTile);
      quad_push(sm, kTT, c.col_peer, kS1, 1, kTile);
    }
    zero_tile(acc);
    if (diag) {
      if (w.active) quad_pass<NP, LPart::kTile>(acc, x, tt, w);
      bars.wait(0);
      bars.wait(1);
      if (w.active) quad_pass<NP, LPart::kTile>(acc, s0, s1, w);
    } else {
      bars.wait(0);
      if (w.active) quad_pass<NP, LPart::kTile>(acc, s0, tt, w);
      bars.wait(1);
      if (w.active) quad_pass<NP, LPart::kTile>(acc, x, s1, w);
    }
  };
  // X T (or X R) by the 3-pass split (split3): the row peer's X hi and lo
  // into A's own slots kAF and kAF + 1 (A X loads them again), the column
  // peer's T hi and lo into S0 and S1.
  auto xt_split = [&](float (&acc)[1][NT][4]) {
    if (tid == 0) {
      bars.arm(0, 2 * kTile);
      quad_push(sm, kXH, c.row_peer, kAF, 0, kTile);
      quad_push(sm, kXL, c.row_peer, kAF + 1, 0, kTile);
    } else if (tid == 1) {
      bars.arm(1, 2 * kTile);
      quad_push(sm, kTT, c.col_peer, kS0, 1, kTile);
      quad_push(sm, kT3, c.col_peer, kS1, 1, kTile);
    }
    zero_tile(acc);
    const bf16* rh = sm.slot(kAF);
    const bf16* rl = sm.slot(kAF + 1);
    auto split = [&](const bf16* lh, const bf16* ll, const bf16* th,
                     const bf16* tl) {
      if (w.active) quad_split<NP, false>(acc, lh, ll, th, tl, w);
    };
    if (diag) {
      split(xh, xl, tt, t3);
      bars.wait(0);
      bars.wait(1);
      split(rh, rl, s0, s1);
    } else {
      bars.wait(0);
      split(rh, rl, tt, t3);
      bars.wait(1);
      split(xh, xl, s0, s1);
    }
  };
  auto xt = [&](float (&acc)[1][NT][4]) {
    if constexpr (SPLIT3)
      xt_split(acc);
    else
      xt_one(acc);
  };
  // T or R from the warps' fragments into kTT (and its lo part into kT3
  // for split3), then the cluster barrier that publishes it.
  auto store_t = [&](float (&acc)[1][NT][4]) {
    if (w.active) {
      store_tile_bf16(acc, sm.slot(kTT), LD, w);
      if constexpr (SPLIT3)
        store_tile_bf16<1, NT, true>(acc, sm.slot(kT3), LD, w);
    }
    cluster_sync();
  };

  publish(0);
  float acc[1][NT][4];
  for (int r = 0; r < prm.lo; ++r) {
    // T = 2c I - c^2 (A X), then X = X T
    float tc, c2;
    round_scalars(prm, r, tc, c2);
    if constexpr (SPLIT3)
      ax_split(acc);
    else
      ax_one(acc);
    if (w.active)
      tile_for_each(acc, w, [&](int i, int j, float& v) {
        v = keep(i, j, __fmul_rn(c2, v), tc);
      });
    store_t(acc);
    xt(xm);
    publish(r + 1);
  }
  for (int r = prm.lo; r < rounds; ++r) {
    // R = I - A X (fp32 or fp64 on CUDA cores, or the 3-pass split),
    // then X = X + X R
    if (f32_round(r)) {
      quad_residual<NP, SPLIT3>(sm, c, bars, src, n);
      // every push out of kF0 landed: X's bf16 parts go over it
      cluster_sync();
      if (w.active) {
        store_tile_bf16(xm, sm.slot(kXH), LD, w);
        if constexpr (SPLIT3)
          store_tile_bf16<1, NT, true>(xm, sm.slot(kXL), LD, w);
      }
      cluster_sync();
    } else {
      ax_split(acc);
      if (w.active)
        tile_for_each(acc, w, [&](int i, int j, float& v) {
          v = keep(i, j, v, 1.f);
        });
      store_t(acc);
    }
    xt(acc);
    if (w.active) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xm[0][j][e] = __fadd_rn(xm[0][j][e], acc[0][j][e]);
    }
    publish(r + 1);
  }
}

// The quadrant of X (kF0) into the n x n matrix dst (device memory).
template <int NP>
__device__ __forceinline__ void quad_store_x(const QuadSmem<NP>& sm,
                                             const QuadCta& c, float* dst,
                                             int n) {
  using G = QuadGeometry<NP>;
  const float* xf = sm.area(kF0);
  for (int x = threadIdx.x; x < G::Q * G::Q; x += kThreads) {
    const int i = x / G::Q, j = x % G::Q;
    const int gi = c.p * G::Q + i, gj = c.q * G::Q + j;
    if (gi < n && gj < n)
      dst[static_cast<size_t>(gi) * n + gj] = xf[i * G::LD + j];
  }
}

}  // namespace
