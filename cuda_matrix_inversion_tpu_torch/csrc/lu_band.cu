// K2 past one block: batched LU inverse with magnitude partial pivoting on
// a thread-block cluster, for 129 <= n <= 256, on sm_90a.
//
// Replaces the TPU kernel cuda_matrix_inversion_tpu/ops/pallas_lu.py::
// _blocked_lu_inverse_kernel where it serves 129 <= n <= 256 (its
// pallas_call in inverse_lu; lu.cu serves n <= 128).  The function is
// K2's: getrf with the first maximum of |W[i][k]| over the rows at
// positions i >= k as pivot, the multipliers stored in place, the trailing
// block's rank-1 updates, all fp32, then A^-1 = U^-1 L^-1 P; ipiv is
// LAPACK's 0-based one.  Every element takes the plain version's
// operations in the plain order (ops/cuda_lu.py::lu_inverse_plain: each
// update __fmul_rn then __fsub_rn, each quotient the IEEE one), so inv and
// ipiv equal its bits on every finite member.  A zero pivot is never
// clamped: that member alone comes out non-finite; every CTA takes the
// same barriers whatever the values.
//
// Why a cluster.  One block cannot hold this band as K2 holds n <= 128:
// the matrix alone is 100 KB (NP = 160) to 256 KB (NP = 256) of fp32, and
// the inverse as much again, against a block's 227 KB of shared memory or
// 64 K registers.  So the matrix is cut into column slabs.
//
// Geometry.  n pads to NP in {160, 192, 224, 256} with the identity (a
// padding row never wins a pivot over a real one, and every term it adds
// to the n x n result is an exact zero), and a cluster of C = NP / 32 CTAs
// (5 to 8, portable sizes; the grid is batch x C) holds it: CTA `rank`
// owns columns [32 rank, 32 rank + 32) of the matrix W and the same
// columns of Y, whole, in one slab [W | Y] of shared memory.  Y starts as
// the identity, and every step of the factor applies to Y's columns too,
// so the factor also performs the forward substitution against P.  Rows
// never move: slab row s (its slot) keeps row s of A and of I, and a map
// gives the slot at each position (two copies, after even and after odd
// panels, so a panel reads the last one while it writes the next).
//
// Warps.  Four tile warps apply panels to the slab; four panel warps
// factor the owner's panels one ahead of them.  The factor goes by panels
// of 4 columns, 8 a CTA.  Panel p's owner's panel threads hold p's columns
// in registers, two slots a thread: they apply panel p - 1 to them (U12 on
// the rows at p - 1's positions, each taking p - 1's earlier steps in
// order, then the rank-4 update of the rows past; between two panels of
// one owner p - 1's multipliers are still in their registers, at a change
// of owner they come from its slot), factor them (a column's pivot: each
// thread's best candidate key, two redux reductions a warp, each warp's
// best key, row and pivot reciprocal through shared memory, one barrier of
// the panel threads), store them into a slot of shared memory, rows by
// slot, with the pivot tables, and push the slot into the same slot of
// every peer with one cp.async.bulk each.  The tile warps take panel g on
// every quad of W past it and on Y, except the quad of panel g + 1 where
// this CTA owns it (the panel threads'), and the owner's tile warps copy
// the factored panel into its columns of the slab.  Each tile thread forms
// U12 for its quad itself, in the plain order, and the first of each quad
// stores it after the tile warps' one barrier a panel (named barrier 1),
// which also passes on the next panel's slot (one tile thread waits for
// it).  The panel threads' panel p waits until the tile warps have applied
// p - 2 (named barriers 2 and 3 by p's parity: bar.arrive on the tile
// side, bar.sync on the panel threads').  At each change of owner the new
// owner's panel threads start as soon as panel p - 1 lands, with the
// slots' positions pushed by the last owner.
//
// The ring.  Slot j holds panel 8 o + j of owner o.  Each slot has a full
// mbarrier in every CTA (a peer arms it for the push; the owner's panel
// threads arrive on their own) and an empty mbarrier in the next owner:
// each CTA, its tile warps past the panel, arrives on it remotely, and the
// next owner's panel threads wait on it before they write the slot
// anywhere.  Two
// cluster barriers remain, after the mbarriers' initialisation and before
// the back pass (W10).
//
// The back pass needs U's columns in descending order, from every slab:
// each CTA stores its slab's U to a workspace in device memory (the
// wrapper's, batch x NP x NP floats, by blocks of 4 columns), a cluster
// barrier (the last DSMEM access of the kernel: no CTA exits while a push
// may still land), then each CTA solves U Z = Y for its 32 columns alone,
// by blocks of 8 rows descending, U's blocks streamed through a ring in
// the slot area by cp.async, 4 blocks ahead.  Panel warp 0 solves each
// block's triangle, lane c a Y column (each row's terms last first, then
// its quotient), as soon as the other warps have given that block's rows
// the block below's terms; they then give the rows above it those terms,
// last first (named barriers 4 and 5).
//
// What bounds it on the card: not bytes (0.5 MB a matrix in and out at n
// = 256, 0.3 MB of workspace) and not operations (2 n^3, 0.5 us at the
// fp32 peak); the serial chain of 64 panels (at NP = 256), each panel
// p - 1 on p's columns, p's 4 pivot steps on the panel threads (each a
// chain of dependent instructions through two redux reductions and a
// barrier), its store and push, then 32 back-pass triangles beside the
// rows above.
//
// Shared memory a CTA: the slab (NP x 68 floats), the 8 slots (NP x 4 + 16
// floats each; the back pass's ring), the positions pushed at an owner
// change (two NP ints), the map (two NP), the pivots, the panel threads'
// exchange area and 17 mbarriers: 108,440 bytes at NP = 256 (two CTAs an
// SM), 68,120 at NP = 160 (three).

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "cluster_common.cuh"
#include "lu_common.cuh"

namespace {

constexpr int kBandMinN = 129;   // lu.cu serves n <= 128
constexpr int kLuBandMaxN = 256;  // the JAX kernel's ceiling
constexpr int kTileThreads = 128;  // four tile warps
constexpr int kPanelThreads = 128;  // four panel warps
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kPanelT = kLuBandMaxN / kPanelThreads;  // slots a panel thread
constexpr int kBandThreads = kTileThreads + kPanelThreads;
// the back pass: panel warp 0 solves the triangles, the other warps
// give the rows above each block its terms
constexpr int kBackWorkers = kBandThreads - 32;
constexpr int kSlabCols = 32;    // W columns (and Y columns) a CTA owns
constexpr int kPanels = kSlabCols / 4;  // panels a CTA owns, slots a CTA
constexpr int kLdS = 68;         // slab row: 8 W quads, 8 Y quads, padding
constexpr int kYOff = 32;        // Y's first float in a slab row

// NP for 129 <= n <= 256.
int lu_band_np(int n) {
  return n <= 160 ? 160 : n <= 192 ? 192 : n <= 224 ? 224 : 256;
}

// The panel threads' exchange area for one step: each warp's best key and
// its row, the row at position j and its slot (two of each, by the step's
// parity, so a step writes one while slow readers of the last read the
// other).
struct PanelXchg {
  float4 row[2][kPanelWarps];
  float4 jrow[2];
  unsigned long long key[2][kPanelWarps];
  alignas(16) float rcp[2][kPanelWarps];
  int jslot[2];
};

template <int NP>
struct LuBand {
  static_assert(NP % kSlabCols == 0 && NP <= kLuBandMaxN, "NP = 32 C");
  static constexpr int C = NP / kSlabCols;  // CTAs a cluster
  static_assert(C <= 8, "a portable cluster");
  static constexpr int kAll = NP / 4;       // panels
  static constexpr int kBlocks = NP / 8;    // back-pass blocks of 8 rows
  // a slot: the panel by slot (NP float4), then ipv[4], psl[4], sjs[4] and
  // 4 ints of padding (bulk copies move multiples of 16 bytes)
  static constexpr int kSlotFloats = 4 * NP + 16;
  static constexpr uint32_t kSlotBytes = kSlotFloats * sizeof(float);
  static constexpr int kRing = 4;  // U blocks in flight (8 NP floats each)
  static_assert(kRing * 8 * NP <= kPanels * kSlotFloats, "the ring fits");
  static constexpr size_t kSmem =
      (NP * kLdS + kPanels * kSlotFloats) * sizeof(float) +
      5 * NP * sizeof(int) + sizeof(PanelXchg) +
      (2 * kPanels + 1) * sizeof(uint64_t);
};

// Named barriers of N threads: 1 the tile warps; 2 and 3 the tile warps'
// hand-over of panel p - 2 to the panel threads (by p's parity); 4 and 5
// the back pass's hand-overs; 6 the panel threads.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(N) : "memory");
}

// v / d for each element: the compiler's fast path with d's reciprocal rd
// shared where it is exact, the division elsewhere.
__device__ __forceinline__ float quot(float v, float d, float rd) {
  return div_safe(v) && div_safe(d) ? div_fast(v, d, rd) : v / d;
}

// The slot at position i > k0 + 3 after a panel's swaps: the one the last
// swap into i moved there, else the one there before the panel.
__device__ __forceinline__ int slot_after(int i, const int* prev,
                                          const int (&ipv)[4],
                                          const int (&sjs)[4]) {
  int s = prev[i];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    if (ipv[h] == i) s = sjs[h];
  return s;
}

// Panel g's steps (k0 = 4 g) on the panel threads' 4 columns (quad jj of
// the slab), given each slot's position after g, the multipliers of g's
// rows past it (lv, by slot) and of its pivot rows (lp[r]: row r's, r = 1
// .. 3): the rows at g's positions (psl) take g's earlier steps in order
// (U12, their values read from the slab, which holds them as the panel
// threads' registers do), the rows past them its 4 steps in order.
template <int NP>
__device__ __forceinline__ void panel_apply(float4 (&v)[kPanelT],
                                            const int (&pos)[kPanelT],
                                            const float4 (&lv)[kPanelT],
                                            const float4 (&lp)[4],
                                            const int (&psl)[4],
                                            const float* S, int jj, int k0,
                                            int pt) {
  float4 u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = ld4(S + psl[r] * kLdS + 4 * jj);
  u[1] = step4(u[1], lp[1].x, u[0]);
  u[2] = step4(step4(u[2], lp[2].x, u[0]), lp[2].y, u[1]);
  u[3] = step4(step4(step4(u[3], lp[3].x, u[0]), lp[3].y, u[1]), lp[3].z,
               u[2]);
#pragma unroll
  for (int t = 0; t < kPanelT; ++t) {
    const int s = pt + kPanelThreads * t;
    if (pos[t] > k0 + 3) {
      const float4 l = lv[t];
      float4 x = v[t];
      x = step4(x, l.x, u[0]);
      x = step4(x, l.y, u[1]);
      x = step4(x, l.z, u[2]);
      x = step4(x, l.w, u[3]);
      v[t] = x;
    } else {
#pragma unroll
      for (int r = 1; r < 4; ++r)
        if (s == psl[r]) v[t] = u[r];
    }
  }
}

// The factor of panel p (columns k0 .. k0 + 3) on the panel threads'
// registers, rows by slot with each slot's position (updated by the swaps;
// -1 past NP).  A column's pivot is the best candidate key (lu_common.cuh::
// cand_key: the first maximum by position, NaN never winning, no candidate
// leaving the row at position j): a thread's maximum, two redux reductions
// a warp, each warp's best key, row and the reciprocal of its pivot into
// the exchange area, one barrier of the panel threads, then the best of
// the warps'.  Each row past a column takes its step (one quotient, then
// the columns past it).  Thread 0 writes step h's pivot position to tab[h],
// the pivot row's slot to tab[4 + h] and the slot it moved out of position
// j to tab[8 + h]; every thread keeps the pivot rows' slots (psl) and the
// pivot rows (prow[h], whose first h values are their multipliers).
template <int NP>
__device__ __forceinline__ void panel_factor(float4 (&v)[kPanelT],
                                             int (&pos)[kPanelT], int k0,
                                             int pt, int* tab,
                                             PanelXchg* xc, int (&psl)[4],
                                             float4 (&prows)[4]) {
  const int lane = pt & 31, w = pt >> 5;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int j = k0 + h, b = h & 1;
    unsigned long long key = 0ull;
    float4 mine = v[0];  // the row that holds the key (static indices keep
                         // v in registers)
#pragma unroll
    for (int t = 0; t < kPanelT; ++t) {
      const int s = pt + kPanelThreads * t;
      const unsigned long long c =
          pos[t] >= j ? cand_key(comp(v[t], h), pos[t], s) : 0ull;
      const bool take = c > key;
      mine = take ? v[t] : mine;
      key = take ? c : key;
      if (pos[t] == j) {
        xc->jrow[b] = v[t];
        xc->jslot[b] = s;
      }
    }
    const float mrcp = div_rcp(comp(mine, h));  // ahead of the reductions
    const unsigned hi =
        __reduce_max_sync(0xffffffffu, static_cast<unsigned>(key >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu, static_cast<unsigned>(key >> 32) == hi
                         ? static_cast<unsigned>(key)
                         : 0u);
    const unsigned long long wbest =
        static_cast<unsigned long long>(hi) << 32 | lo;
    if (lane == 0) xc->key[b][w] = wbest;
    if (key != 0ull && key == wbest) {
      xc->row[b][w] = mine;
      xc->rcp[b][w] = mrcp;
    }
    named_sync<kPanelThreads>(6);
    // the best of the four warps' keys, as a tree (the first of equals
    // cannot arise: the keys differ in the slot)
    const ulonglong2 k01 = *reinterpret_cast<const ulonglong2*>(xc->key[b]);
    const ulonglong2 k23 =
        *reinterpret_cast<const ulonglong2*>(xc->key[b] + 2);
    const float4 rc = ld4(xc->rcp[b]);
    const bool b1 = k01.y > k01.x, b3 = k23.y > k23.x;
    const unsigned long long ka = b1 ? k01.y : k01.x;
    const unsigned long long kb = b3 ? k23.y : k23.x;
    const bool bb = kb > ka;
    const unsigned long long best = bb ? kb : ka;
    float rp = bb ? (b3 ? rc.w : rc.z) : (b1 ? rc.y : rc.x);
    float4 prow = xc->row[b][bb ? (b3 ? 3 : 2) : (b1 ? 1 : 0)];
    const int sj = xc->jslot[b];
    const bool found = best != 0ull;
    const int p = found ? 0xffff - static_cast<int>(best >> 16 & 0xffff) : j;
    const int sp = found ? static_cast<int>(best & 0xffff) : sj;
    if (!found) {
      prow = xc->jrow[b];
      rp = div_rcp(comp(prow, h));
    }
    const float piv = comp(prow, h);
    psl[h] = sp;
    prows[h] = prow;
    if (pt == 0) {
      tab[h] = p;
      tab[4 + h] = sp;
      tab[8 + h] = sj;
    }
    // each row past the column: its quotient (the fast path where it is
    // exact, the division behind one vote where it is not), then its step
    bool act[kPanelT], slow = false;
    float l[kPanelT];
#pragma unroll
    for (int t = 0; t < kPanelT; ++t) {
      const int s = pt + kPanelThreads * t;
      pos[t] = s == sp ? j : s == sj && p != j ? p : pos[t];
      act[t] = s != sp && pos[t] > j;
      const float a = comp(v[t], h);
      l[t] = div_fast(a, piv, rp);
      slow |= act[t] && !(div_safe(a) && div_safe(piv));
    }
    if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
      for (int t = 0; t < kPanelT; ++t) {
        const float a = comp(v[t], h);
        if (!(div_safe(a) && div_safe(piv))) l[t] = a / piv;
      }
    }
#pragma unroll
    for (int t = 0; t < kPanelT; ++t) {
      float4 x = v[t];
      const float lt = l[t];
      if (h == 0) {
        x.x = lt;
        x.y = __fsub_rn(x.y, __fmul_rn(lt, prow.y));
        x.z = __fsub_rn(x.z, __fmul_rn(lt, prow.z));
        x.w = __fsub_rn(x.w, __fmul_rn(lt, prow.w));
      } else if (h == 1) {
        x.y = lt;
        x.z = __fsub_rn(x.z, __fmul_rn(lt, prow.z));
        x.w = __fsub_rn(x.w, __fmul_rn(lt, prow.w));
      } else if (h == 2) {
        x.z = lt;
        x.w = __fsub_rn(x.w, __fmul_rn(lt, prow.w));
      } else {
        x.w = lt;
      }
      v[t] = act[t] ? x : v[t];
    }
  }
}

// The panel threads' factor loop: this CTA's 8 panels, each one ahead of
// the tile warps.  Thread pt holds slots pt and pt + 128 (those below NP).
// Between two panels of one owner the last panel's multipliers stay in
// registers; at a change of owner they come from its slot.
template <int NP>
__device__ __forceinline__ void panel_threads(float* S, float* slots,
                                              int* pos_out,
                                              const int* pos_in,
                                              PanelXchg* xc, uint64_t* full,
                                              uint64_t* empty,
                                              uint64_t* posbar, int rank) {
  using B = LuBand<NP>;
  constexpr int C = B::C;
  const int pt = threadIdx.x - kTileThreads;
  float4 v[kPanelT], lv[kPanelT], lp[4];
  int pos[kPanelT], psl[4];
#pragma unroll
  for (int t = 0; t < kPanelT; ++t) {
    const int s = pt + kPanelThreads * t;
    pos[t] = s < NP ? s : -1;  // rank 0 starts from the identity
  }
  for (int jj = 0; jj < kPanels; ++jj) {
    const int p = kPanels * rank + jj, k0 = 4 * p;
    float* P = slots + jj * B::kSlotFloats;
    // the tile warps have applied panel p - 2 to this panel's columns
    if (p >= 2) named_sync<kBandThreads>(2 + (p & 1));
    if (jj == 0 && p >= 1) {
      // at a change of owner: the positions after panel p - 1 and its slot
      const float* Pp = slots + (p - 1) % kPanels * B::kSlotFloats;
      mbar_wait(posbar, 0);
      mbar_wait(full + (p - 1) % kPanels, ((p - 1) / kPanels) & 1);
      const int4 t1 = *reinterpret_cast<const int4*>(Pp + 4 * NP + 4);
      psl[0] = t1.x;
      psl[1] = t1.y;
      psl[2] = t1.z;
      psl[3] = t1.w;
#pragma unroll
      for (int r = 1; r < 4; ++r) lp[r] = ld4(Pp + 4 * psl[r]);
#pragma unroll
      for (int t = 0; t < kPanelT; ++t) {
        const int s = pt + kPanelThreads * t;
        if (s < NP) {
          pos[t] = pos_in[s];
          lv[t] = ld4(Pp + 4 * s);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kPanelT; ++t) {
      const int s = pt + kPanelThreads * t;
      v[t] = s < NP ? ld4(S + s * kLdS + 4 * jj)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (p >= 1) panel_apply<NP>(v, pos, lv, lp, psl, S, jj, k0 - 4, pt);
    panel_factor<NP>(v, pos, k0, pt, reinterpret_cast<int*>(P + 4 * NP), xc,
                     psl, lp);
    // every CTA has released this slot's last panel, p - 8
    if (rank > 0) mbar_wait_cluster(empty + jj, 0);
    const bool hand = jj == kPanels - 1 && rank < C - 1;
#pragma unroll
    for (int t = 0; t < kPanelT; ++t) {
      const int s = pt + kPanelThreads * t;
      lv[t] = v[t];
      if (s < NP) {
        st4(P + 4 * s, v[t]);
        if (hand) pos_out[s] = pos[t];
      }
    }
    fence_proxy_async();
    named_sync<kPanelThreads>(6);
    if (pt == 0) mbar_arrive(full + jj);
    if (pt < C - 1) {
      const int peer = (rank + 1 + pt) % C;
      push_bulk(peer_addr(P, peer), P, B::kSlotBytes,
                peer_addr(full + jj, peer));
    }
    if (hand && pt == 0)
      push_bulk(peer_addr(pos_in, rank + 1), pos_out, NP * sizeof(int),
                peer_addr(posbar, rank + 1));
  }
}

// The tile warps' factor loop: every panel on the slab, in order.
template <int NP>
__device__ __forceinline__ void tile_warps(float* S, const float* slots,
                                           int* perm, int* s_ipiv,
                                           uint64_t* full, uint64_t* empty,
                                           int rank) {
  using B = LuBand<NP>;
  const int tid = threadIdx.x;
  // one thread waits for each panel's slot, the others at the barrier after
  // it (the last one of the panel before)
  if (tid == 0) mbar_wait(full, 0);
  named_sync<kTileThreads>(1);
  for (int g = 0; g < B::kAll; ++g) {
    const int o = g / kPanels, jg = g % kPanels, k0 = 4 * g;
    const float* P = slots + jg * B::kSlotFloats;
    const int4 t0 = *reinterpret_cast<const int4*>(P + 4 * NP);
    const int4 t1 = *reinterpret_cast<const int4*>(P + 4 * NP + 4);
    const int4 t2 = *reinterpret_cast<const int4*>(P + 4 * NP + 8);
    const int ipv[4] = {t0.x, t0.y, t0.z, t0.w};
    const int psl[4] = {t1.x, t1.y, t1.z, t1.w};
    const int sjs[4] = {t2.x, t2.y, t2.z, t2.w};
    const int* prev = perm + ((g + 1) & 1) * NP;  // the map after g - 1
    for (int i = tid; i < NP; i += kTileThreads) {  // the map after g
      int s = i < k0 ? prev[i] : slot_after(i, prev, ipv, sjs);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i == k0 + r) s = psl[r];
      perm[(g & 1) * NP + i] = s;
    }
    if (rank == 0 && tid == 0) {
#pragma unroll
      for (int h = 0; h < 4; ++h) s_ipiv[k0 + h] = ipv[h];
    }
    if (o == rank)  // the owner's panel columns: the factored panel
      for (int s = tid; s < NP; s += kTileThreads)
        st4(S + s * kLdS + 4 * jg, ld4(P + 4 * s));
    // quads qa .. 15 take the panel: W's past it but the panel threads'
    // (panel g + 1's, where this CTA owns it), then Y's
    const int qa = min(max(g + 2 - kPanels * rank, 0), kPanels);
    const int na = 16 - qa, per = kTileThreads / na;
    const int tq = tid % na, tr = tid / na, q = qa + tq;
    float4 u[4];
    if (tr < per) {
      // U12: row r takes the panel's earlier steps in order
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = ld4(S + psl[r] * kLdS + 4 * q);
      const float4 l1 = ld4(P + 4 * psl[1]);
      const float4 l2 = ld4(P + 4 * psl[2]);
      const float4 l3 = ld4(P + 4 * psl[3]);
      u[1] = step4(u[1], l1.x, u[0]);
      u[2] = step4(step4(u[2], l2.x, u[0]), l2.y, u[1]);
      u[3] = step4(step4(step4(u[3], l3.x, u[0]), l3.y, u[1]), l3.z, u[2]);
      // the rows past the panel take its 4 steps in order
      for (int i = k0 + 4 + tr; i < NP; i += per) {
        const int s = slot_after(i, prev, ipv, sjs);
        const float4 l = ld4(P + 4 * s);
        float4 x = ld4(S + s * kLdS + 4 * q);
        x = step4(x, l.x, u[0]);
        x = step4(x, l.y, u[1]);
        x = step4(x, l.z, u[2]);
        x = step4(x, l.w, u[3]);
        st4(S + s * kLdS + 4 * q, x);
      }
    }
    if (tid == 0 && g + 1 < B::kAll)
      mbar_wait(full + (g + 1) % kPanels, ((g + 1) / kPanels) & 1);
    named_sync<kTileThreads>(1);
    if (tr == 0) {  // every thread of the quad has read the panel's rows
#pragma unroll
      for (int r = 1; r < 4; ++r) st4(S + psl[r] * kLdS + 4 * q, u[r]);
    }
    if (tid == 0 && g + kPanels < B::kAll) {
      // release the slot to its next owner, and expect that owner's push
      mbar_arrive_cluster(peer_addr(empty + jg, o + 1));
      if (o + 1 != rank) mbar_arm(full + jg, B::kSlotBytes);
    }
    if (g + 2 < B::kAll && (g + 2) / kPanels == rank)
      named_arrive<kBandThreads>(2 + (g & 1));
  }
}

template <int NP>
__global__ void __launch_bounds__(kBandThreads, NP <= 160 ? 3 : 2)
    lu_band_kernel(const float* __restrict__ a, float* __restrict__ inv,
                   int* __restrict__ ipiv, float* __restrict__ ws, int n) {
  using B = LuBand<NP>;
  constexpr int C = B::C;
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                          // NP x kLdS: [W | Y] by slot
  float* slots = S + NP * kLdS;             // kPanels x kSlotFloats
  int* pos_out = reinterpret_cast<int*>(slots + kPanels * B::kSlotFloats);
  int* pos_in = pos_out + NP;  // each slot's position at an owner change
  int* perm = pos_in + NP;     // 2 x NP: the slot at each position
  int* s_ipiv = perm + 2 * NP;  // rank 0's record
  PanelXchg* xc = reinterpret_cast<PanelXchg*>(s_ipiv + NP);
  uint64_t* full = reinterpret_cast<uint64_t*>(xc + 1);
  uint64_t* empty = full + kPanels;
  uint64_t* posbar = empty + kPanels;
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  const int col0 = kSlabCols * rank;
  const size_t mat = blockIdx.x / C;
  const float* A = a + mat * n * n;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(inv)) &
                                  15) == 0;

  if (tid == 0) {
    for (int j = 0; j < kPanels; ++j) {
      mbar_init(full + j);
      mbar_init(empty + j, C);
    }
    mbar_init(posbar);
    // owner 0's panels and the positions pushed to this CTA
    if (rank > 0) {
      for (int j = 0; j < kPanels; ++j) mbar_arm(full + j, B::kSlotBytes);
      mbar_arm(posbar, NP * sizeof(int));
    }
    mbar_init_fence();
  }
  // the slab: A's columns padded with the identity, and Y = I
  for (int idx = tid; idx < NP * 8; idx += kBandThreads) {
    const int i = idx >> 3, q = idx & 7, c = col0 + 4 * q;
    float4 w;
    if (vec && i < n && c < n) {
      w = ld4(A + static_cast<size_t>(i) * n + c);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = i < n && c + e < n ? A[static_cast<size_t>(i) * n + c + e]
                                  : (i == c + e ? 1.f : 0.f);
      w = make_float4(v[0], v[1], v[2], v[3]);
    }
    st4(S + i * kLdS + 4 * q, w);
    st4(S + i * kLdS + kYOff + 4 * q,
        make_float4(i == c ? 1.f : 0.f, i == c + 1 ? 1.f : 0.f,
                    i == c + 2 ? 1.f : 0.f, i == c + 3 ? 1.f : 0.f));
  }
  for (int i = tid; i < NP; i += kBandThreads) perm[NP + i] = i;
  // every CTA's mbarriers initialised before any push (W10)
  cluster_sync();

  if (tid >= kTileThreads)
    panel_threads<NP>(S, slots, pos_out, pos_in, xc, full, empty, posbar,
                      rank);
  else
    tile_warps<NP>(S, slots, perm, s_ipiv, full, empty, rank);
  __syncthreads();

  // U into the workspace by blocks of 4 columns: Wm[kb][i] holds U[i][4 kb
  // .. 4 kb + 3] for i <= 4 kb + 3
  const int* pf = perm + ((B::kAll - 1) & 1) * NP;  // the final map
  float* Wm = ws + mat * NP * NP;
  for (int idx = tid; idx < 8 * NP; idx += kBandThreads) {
    const int q = idx / NP, i = idx % NP, kb = kPanels * rank + q;
    if (i <= 4 * kb + 3)
      st4(Wm + (static_cast<size_t>(kb) * NP + i) * 4,
          ld4(S + pf[i] * kLdS + 4 * q));
  }
  __threadfence();
  // every slab's U in the workspace, and every push landed: no CTA reads
  // or writes a peer's shared memory past this barrier
  cluster_sync();

  // Y = U^-1 Y on this CTA's columns, by blocks of 8 rows descending; U's
  // blocks (ring[i][e] = U[i][8 b + e], i <= 8 b + 7) stream through a
  // ring of kRing in the slot area
  float* ring = slots;
  if (tid >= kTileThreads && tid < kTileThreads + 32) {
    // the triangles: lane c solves Y's column c of each block, rows last
    // first, each row's terms last first, then its quotient
    const int lane = tid - kTileThreads;
    for (int b = B::kBlocks - 1; b >= 0; --b) {
      named_sync<kBandThreads>(4);  // the block's rows have the terms below
      const float* Ub = ring + (b % B::kRing) * 8 * NP + 64 * b;
      int sl[8];
      float y[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        sl[r] = pf[8 * b + r];
        y[r] = S[sl[r] * kLdS + kYOff + lane];
      }
      float d[8], rd[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        d[r] = Ub[9 * r];
        rd[r] = div_rcp(d[r]);
      }
      // the fast quotients where every one is exact (one vote a block),
      // else the block again with the division where it is not
      float y0[8];
      bool ok = true;
#pragma unroll
      for (int r = 7; r >= 0; --r) {
        y0[r] = y[r];
#pragma unroll
        for (int e = 7; e > r; --e)
          y[r] = __fsub_rn(y[r], __fmul_rn(Ub[8 * r + e], y[e]));
        ok = ok && div_safe(y[r]) && div_safe(d[r]);
        y[r] = div_fast(y[r], d[r], rd[r]);
      }
      if (!__all_sync(0xffffffffu, ok)) {
#pragma unroll
        for (int r = 7; r >= 0; --r) {
          y[r] = y0[r];
#pragma unroll
          for (int e = 7; e > r; --e)
            y[r] = __fsub_rn(y[r], __fmul_rn(Ub[8 * r + e], y[e]));
          y[r] = quot(y[r], d[r], rd[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) S[sl[r] * kLdS + kYOff + lane] = y[r];
      named_arrive<kBandThreads>(5);  // the block solved
    }
  } else {
    const int wid = tid < kTileThreads ? tid : tid - 32;  // a worker's index
    auto fetch = [&](int b) {
      if (b >= 0) {
        float* dst = ring + (b % B::kRing) * 8 * NP;
        for (int idx = wid; idx < 16 * (b + 1); idx += kBackWorkers) {
          const int i = idx >> 1, h = idx & 1;
          if (h == 1 || i <= 8 * b + 3)
            cp_async16(dst + 8 * i + 4 * h,
                       Wm + (static_cast<size_t>(2 * b + h) * NP + i) * 4);
        }
      }
      cp_async_commit();
    };
    for (int t = 0; t < B::kRing; ++t) fetch(B::kBlocks - 1 - t);
    cp_async_wait<B::kRing - 1>();
    named_arrive<kBandThreads>(4);  // the last block: no terms below it
    const int yq = wid & 7;  // the Y quad of this thread's rows
    for (int b = B::kBlocks - 1; b >= 0; --b) {
      named_sync<kBandThreads>(5);  // block b solved
      // block b + 1's part of the ring is free: the block kRing below it
      // (an empty group past block 0, so that each block's group stays
      // kRing - 2 behind the newest one here)
      if (b + 1 < B::kBlocks) fetch(b + 1 - B::kRing);
      if (b == 0) break;
      const float* Ub = ring + (b % B::kRing) * 8 * NP;
      const int r0 = 8 * b;
      float4 z[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        z[r] = ld4(S + pf[r0 + r] * kLdS + kYOff + 4 * yq);
      // rows above the block take its 8 terms, last first: first block b -
      // 1's rows (workers 0 .. 63), whose triangle then starts
      auto terms = [&](int i) {
        const int s = pf[i];
        const float4 u0 = ld4(Ub + 8 * i), u1 = ld4(Ub + 8 * i + 4);
        float4 x = ld4(S + s * kLdS + kYOff + 4 * yq);
        x = step4(x, u1.w, z[7]);
        x = step4(x, u1.z, z[6]);
        x = step4(x, u1.y, z[5]);
        x = step4(x, u1.x, z[4]);
        x = step4(x, u0.w, z[3]);
        x = step4(x, u0.z, z[2]);
        x = step4(x, u0.y, z[1]);
        x = step4(x, u0.x, z[0]);
        st4(S + s * kLdS + kYOff + 4 * yq, x);
      };
      if (wid < 64) terms(r0 - 8 + (wid >> 3));
      cp_async_wait<B::kRing - 2>();  // block b - 1's part of the ring
      named_arrive<kBandThreads>(4);
      for (int i = wid >> 3; i < r0 - 8; i += kBackWorkers / 8) terms(i);
    }
  }
  __syncthreads();

  // the inverse, rows by position, this CTA's columns
  float* X = inv + mat * n * n;
  for (int idx = tid; idx < NP * 8; idx += kBandThreads) {
    const int i = idx >> 3, q = idx & 7, c = col0 + 4 * q;
    if (i >= n || c >= n) continue;
    const float4 v = ld4(S + pf[i] * kLdS + kYOff + 4 * q);
    if (vec) {
      st4(X + static_cast<size_t>(i) * n + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < n) X[static_cast<size_t>(i) * n + c + e] = comp(v, e);
    }
  }
  if (rank == 0)
    for (int i = tid; i < n; i += kBandThreads) ipiv[mat * n + i] = s_ipiv[i];
}

template <int NP>
cudaError_t launch_lu_band(const float* a, float* inv, int* ipiv, float* ws,
                           int batch, int n, cudaStream_t s) {
  return cluster_launch(lu_band_kernel<NP>, LuBand<NP>::C, batch,
                        kBandThreads, LuBand<NP>::kSmem, s, a, inv, ipiv, ws,
                        n);
}

}  // namespace

// a, inv: (batch, n, n) fp32; ipiv: (batch, n) int32; ws: batch x NP x NP
// fp32 of scratch (NP = 160, 192, 224 or 256, the padded size that serves
// n); all contiguous on `device`, 129 <= n <= 256.  Returns the CUDA error
// of the launch (cudaErrorInvalidValue outside that range).
extern "C" int cmi_lu_inverse_band(const float* a, float* inv, int* ipiv,
                                   float* ws, int batch, int n, int device,
                                   void* stream) {
  if (n < kBandMinN || n > kLuBandMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lu_band_np(n)) {
    case 160: err = launch_lu_band<160>(a, inv, ipiv, ws, batch, n, s); break;
    case 192: err = launch_lu_band<192>(a, inv, ipiv, ws, batch, n, s); break;
    case 224: err = launch_lu_band<224>(a, inv, ipiv, ws, batch, n, s); break;
    default: err = launch_lu_band<256>(a, inv, ipiv, ws, batch, n, s);
  }
  return static_cast<int>(err);
}
