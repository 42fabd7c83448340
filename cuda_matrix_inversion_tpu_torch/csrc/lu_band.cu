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
// columns of Y, whole, rows by position, in one slab [W | Y] of shared
// memory.  Y starts as the identity, and every row swap and step of the
// factor applies to Y's columns too, so the factor also performs the
// forward substitution against P: the row that ends at position i starts
// as e_perm[i] and takes the terms of steps k = 0 .. i - 1 in that order,
// as the plain version's forward pass gives it.  A column's pivot search
// stays in the CTA that owns the column.
//
// The factor goes by panels of 4 columns, 8 a CTA.  The owner copies the
// panel's columns into a mirror in shared memory, rows by slot (their
// position at the panel's start), and its first NP threads factor it
// there as K2 does (lu_common.cuh::lu_panel_factor).  It then pushes the
// factored mirror and its pivot tables (4 NP + 16 floats) into the same
// slot of every peer with one cp.async.bulk each, completing on an
// mbarrier in the peer that the peer armed with the bytes it expects.
// Every CTA then applies the panel to its slab: the rows the panel's swaps
// move are staged and gathered (whole rows: L, U and Y), the owner takes
// the factored panel, the panel's rows take its earlier steps in order
// (U12), and the rows past it its 4 steps, on the W columns past the panel
// and on all of Y.  The mirror has 8 slots, one a panel of an owner: at
// each change of owner a cluster barrier proves that every CTA has applied
// the last owner's panels, so the new owner may overwrite their slots.
//
// The back pass needs U's columns in descending order, from every slab:
// each CTA stores its slab's U to a workspace in device memory (the
// wrapper's, batch x NP x NP floats, by blocks of 4 columns), a cluster
// barrier (the last DSMEM access of the kernel: no CTA exits while a push
// may still land), then each CTA solves U Z = Y for its 32 columns alone,
// by blocks of 4 rows descending (the block's triangle, each row's terms
// last first, then its quotient; then the block's 4 terms on the rows
// above, last first), with the blocks of U streamed through a ring in the
// slot area by cp.async, 8 blocks ahead.
//
// What bounds it on the card: not bytes (0.5 MB a matrix in and out at n
// = 256, 0.3 MB of workspace) and not operations (2 n^3, 0.5 us at the
// fp32 peak); the serial chain of 64 panels (at NP = 256), each a pivot
// search and step for 4 columns, a push and the owner's update of its
// slab, then 64 back-pass blocks.  The design keeps that chain inside one
// CTA for 8 panels at a time and off the card's memory; lookahead (the
// next panel's owner updating that panel first) is left for a later
// redesign.
//
// Shared memory a CTA: the slab (NP x 68 floats), the 8 slots (NP x 4 + 16
// floats each; the back pass's ring), 8 staged rows, two columns' warp
// keys, 8 mbarriers and the pivots: 106,176 bytes at NP = 256 (two CTAs an
// SM), 67,344 at NP = 160.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "cluster_common.cuh"
#include "lu_common.cuh"

namespace {

constexpr int kBandMinN = 129;   // lu.cu serves n <= 128
constexpr int kLuBandMaxN = 256;  // the JAX kernel's ceiling
constexpr int kBandThreads = 256;
constexpr int kSlabCols = 32;    // W columns (and Y columns) a CTA owns
constexpr int kPanels = kSlabCols / 4;  // panels a CTA owns, slots a CTA
constexpr int kLdS = 68;         // slab row: 8 W quads, 8 Y quads, padding
constexpr int kYOff = 32;        // Y's first float in a slab row

// NP for 129 <= n <= 256.
int lu_band_np(int n) {
  return n <= 160 ? 160 : n <= 192 ? 192 : n <= 224 ? 224 : 256;
}

template <int NP>
struct LuBand {
  static_assert(NP % kSlabCols == 0 && NP <= kLuBandMaxN, "NP = 32 C");
  static constexpr int C = NP / kSlabCols;  // CTAs a cluster
  static_assert(C <= 8, "a portable cluster");
  static constexpr int kBlocks = NP / 4;    // back-pass blocks of 4 rows
  // a slot: the panel by slot (NP float4), then ipv[4], psl[4], sjs[4] and
  // 4 ints of padding (bulk copies move multiples of 16 bytes)
  static constexpr int kSlotFloats = 4 * NP + 16;
  static constexpr uint32_t kSlotBytes = kSlotFloats * sizeof(float);
  static constexpr int kRing = kPanels;  // U blocks in flight (4 NP each)
  static_assert(kRing * 4 * NP <= kPanels * kSlotFloats, "the ring fits");
  static constexpr size_t kSmem =
      (NP * kLdS + kPanels * kSlotFloats + 8 * 64) * sizeof(float) +
      2 * (NP / 32) * sizeof(unsigned long long) +
      kPanels * sizeof(uint64_t) + NP * sizeof(int);
};

// v / d for each element: the compiler's fast path with d's reciprocal rd
// shared where it is exact, the division elsewhere.
__device__ __forceinline__ float quot(float v, float d, float rd) {
  return div_safe(v) && div_safe(d) ? div_fast(v, d, rd) : v / d;
}

__device__ __forceinline__ float4 quot4(float4 v, float d) {
  const float rd = div_rcp(d);
  return make_float4(quot(v.x, d, rd), quot(v.y, d, rd), quot(v.z, d, rd),
                     quot(v.w, d, rd));
}

// The slot of the row now at position i > k0 + 3 after a panel's swaps:
// the row that the last swap into i moved out of the panel's positions.
__device__ __forceinline__ int moved_from(int i, const int (&ipv)[4],
                                          const int (&sjs)[4]) {
  int src = i;
#pragma unroll
  for (int h = 0; h < 4; ++h)
    if (ipv[h] == i) src = sjs[h];
  return src;
}

template <int NP>
__global__ void __launch_bounds__(kBandThreads)
    lu_band_kernel(const float* __restrict__ a, float* __restrict__ inv,
                   int* __restrict__ ipiv, float* __restrict__ ws, int n) {
  using B = LuBand<NP>;
  constexpr int C = B::C;
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                          // NP x kLdS: [W | Y] by position
  float* slots = S + NP * kLdS;             // kPanels x kSlotFloats
  float* St = slots + kPanels * B::kSlotFloats;  // 8 x 64: rows that move
  unsigned long long* keys =  // 2 x NP / 32: a column's best key a warp
      reinterpret_cast<unsigned long long*>(St + 8 * 64);
  uint64_t* bars = reinterpret_cast<uint64_t*>(keys + 2 * (NP / 32));
  int* s_ipiv = reinterpret_cast<int*>(bars + kPanels);  // rank 0's record
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  const int col0 = kSlabCols * rank;
  const size_t mat = blockIdx.x / C;
  const float* A = a + mat * n * n;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(inv)) &
                                  15) == 0;

  if (tid == 0) {
    for (int j = 0; j < kPanels; ++j) mbar_init(bars + j);
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
  // every CTA's mbarriers initialised before any push (W10)
  cluster_sync();

  uint32_t parity = 0;  // the phase of this CTA's slot barriers
  for (int o = 0; o < C; ++o) {
    const bool own = o == rank;
    // every CTA has applied owner o - 1's panels: their slots are free
    if (o > 0) cluster_sync();
    if (!own && tid < kPanels) mbar_arm(bars + tid, B::kSlotBytes);
    for (int j = 0; j < kPanels; ++j) {
      const int g = kPanels * o + j, k0 = 4 * g;
      float* Pg = slots + j * B::kSlotFloats;
      int* tab = reinterpret_cast<int*>(Pg + 4 * NP);
      if (own) {
        if (tid < NP) {  // the panel threads: the mirror, then the factor
          st4(Pg + 4 * tid, ld4(S + tid * kLdS + 4 * j));
          lu_panel_factor<NP, NP>(Pg, k0, tid, keys, tab, tab + 4, tab + 8);
          fence_proxy_async();
        }
        __syncthreads();
        if (tid < C - 1) {
          const int peer = (rank + 1 + tid) % C;
          push_bulk(peer_addr(Pg, peer), Pg, B::kSlotBytes,
                    peer_addr(bars + j, peer));
        }
      } else {
        mbar_wait(bars + j, parity);
      }

      // the panel on the slab
      const int4 t0 = *reinterpret_cast<const int4*>(tab);
      const int4 t1 = *reinterpret_cast<const int4*>(tab + 4);
      const int4 t2 = *reinterpret_cast<const int4*>(tab + 8);
      const int ipv[4] = {t0.x, t0.y, t0.z, t0.w};
      const int psl[4] = {t1.x, t1.y, t1.z, t1.w};
      const int sjs[4] = {t2.x, t2.y, t2.z, t2.w};
      if (rank == 0 && tid < 4) s_ipiv[k0 + tid] = tab[tid];
      // the first quad the panel's steps update: W's quads past the
      // panel, then Y's; the owner's quad j takes the factored panel
      const int qa = min(max(g + 1 - kPanels * rank, 0), kPanels);
      const int pq = own ? j : -1;
      // the rows that move, as they stand: the pivot rows (by slot) into
      // St[h], the rows at the panel's positions into St[4 + r]
      if (tid < 128) {
        const int e = tid >> 4, q = tid & 15;
        const int row = e < 4 ? tab[4 + e] : k0 + e - 4;
        st4(St + e * 64 + 4 * q, ld4(S + row * kLdS + 4 * q));
      }
      __syncthreads();
      if (tid < 16) {
        // the panel's positions take the pivot rows; on the quads past
        // the panel row r takes the panel's earlier steps in order (U12)
        const int q = tid;
        if (q != pq) {
          float4 u[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) u[r] = ld4(St + r * 64 + 4 * q);
          if (q >= qa) {
            const float4 l1 = ld4(Pg + 4 * psl[1]);
            const float4 l2 = ld4(Pg + 4 * psl[2]);
            const float4 l3 = ld4(Pg + 4 * psl[3]);
            u[1] = step4(u[1], l1.x, u[0]);
            u[2] = step4(step4(u[2], l2.x, u[0]), l2.y, u[1]);
            u[3] = step4(step4(step4(u[3], l3.x, u[0]), l3.y, u[1]), l3.z,
                         u[2]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) st4(S + (k0 + r) * kLdS + 4 * q, u[r]);
        }
      } else if (tid < 80) {
        // a pivot position past the panel takes the row the last swap into
        // it moved out of the panel's positions
        const int h = (tid - 16) >> 4, q = tid & 15;
        const int p = tab[h];
        bool last = true;
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2)
          if (h2 > h && ipv[h2] == p) last = false;
        if (p > k0 + 3 && last && q != pq)
          st4(S + p * kLdS + 4 * q,
              ld4(St + (4 + tab[8 + h] - k0) * 64 + 4 * q));
      } else if (own && tid >= 128) {
        // the owner's panel columns: the factored panel by position
        for (int i = k0 + tid - 128; i < NP; i += 128) {
          const int src =
              i < k0 + 4 ? tab[4 + i - k0] : moved_from(i, ipv, sjs);
          st4(S + i * kLdS + 4 * j, ld4(Pg + 4 * src));
        }
      }
      __syncthreads();
      // the rows past the panel take its 4 steps, in order, on quads
      // qa .. 15; na quads a row, kBandThreads / na rows at once
      const int na = 16 - qa, per = kBandThreads / na;
      const int tq = tid % na, tr = tid / na;
      if (tr < per) {
        const int q = qa + tq;
        float4 u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = ld4(S + (k0 + r) * kLdS + 4 * q);
        for (int i = k0 + 4 + tr; i < NP; i += per) {
          const float4 l = ld4(Pg + 4 * moved_from(i, ipv, sjs));
          float4 v = ld4(S + i * kLdS + 4 * q);
          v = step4(v, l.x, u[0]);
          v = step4(v, l.y, u[1]);
          v = step4(v, l.z, u[2]);
          v = step4(v, l.w, u[3]);
          st4(S + i * kLdS + 4 * q, v);
        }
      }
      __syncthreads();
    }
    if (!own) parity ^= 1;
  }

  // U into the workspace by blocks of 4 columns: Wm[kb][i] holds U[i][4 kb
  // .. 4 kb + 3] for i <= 4 kb + 3
  float* Wm = ws + mat * NP * NP;
  for (int idx = tid; idx < 8 * NP; idx += kBandThreads) {
    const int q = idx / NP, i = idx % NP, kb = kPanels * rank + q;
    if (i <= 4 * kb + 3)
      st4(Wm + (static_cast<size_t>(kb) * NP + i) * 4,
          ld4(S + i * kLdS + 4 * q));
  }
  __threadfence();
  // every slab's U in the workspace, and every push landed: no CTA reads
  // or writes a peer's shared memory past this barrier
  cluster_sync();

  // Y = U^-1 Y on this CTA's columns, by blocks of 4 rows descending; U's
  // blocks stream through a ring of kRing in the slot area
  float* ring = slots;
  auto fetch = [&](int kb) {
    if (kb >= 0 && tid <= 4 * kb + 3)
      cp_async16(ring + (kb % B::kRing) * 4 * NP + 4 * tid,
                 Wm + (static_cast<size_t>(kb) * NP + tid) * 4);
    cp_async_commit();
  };
  for (int t = 0; t < B::kRing; ++t) fetch(B::kBlocks - 1 - t);
  const int yq = tid & 7;  // the Y quad of this thread's rows
  for (int kb = B::kBlocks - 1; kb >= 0; --kb) {
    cp_async_wait<B::kRing - 1>();
    __syncthreads();
    const float* Ub = ring + (kb % B::kRing) * 4 * NP;  // U[i][4 kb + c]
    const int r0 = 4 * kb;
    if (tid < 8) {
      // the block's triangle, rows last first: each row's terms, last
      // first, then its quotient
      float4 y[4], u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        y[r] = ld4(S + (r0 + r) * kLdS + kYOff + 4 * yq);
        u[r] = ld4(Ub + 4 * (r0 + r));
      }
      y[3] = quot4(y[3], u[3].w);
      y[2] = quot4(step4(y[2], u[2].w, y[3]), u[2].z);
      y[1] = quot4(step4(step4(y[1], u[1].w, y[3]), u[1].z, y[2]), u[1].y);
      y[0] = quot4(
          step4(step4(step4(y[0], u[0].w, y[3]), u[0].z, y[2]), u[0].y, y[1]),
          u[0].x);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st4(S + (r0 + r) * kLdS + kYOff + 4 * yq, y[r]);
    }
    __syncthreads();
    if (r0 > 0) {
      // the rows above take the block's 4 terms, last first
      float4 z[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        z[r] = ld4(S + (r0 + r) * kLdS + kYOff + 4 * yq);
      for (int i = tid >> 3; i < r0; i += kBandThreads / 8) {
        const float4 u = ld4(Ub + 4 * i);
        float4 v = ld4(S + i * kLdS + kYOff + 4 * yq);
        v = step4(v, u.w, z[3]);
        v = step4(v, u.z, z[2]);
        v = step4(v, u.y, z[1]);
        v = step4(v, u.x, z[0]);
        st4(S + i * kLdS + kYOff + 4 * yq, v);
      }
    }
    __syncthreads();
    fetch(kb - B::kRing);
  }

  // the inverse, rows by position, this CTA's columns
  float* X = inv + mat * n * n;
  for (int idx = tid; idx < NP * 8; idx += kBandThreads) {
    const int i = idx >> 3, q = idx & 7, c = col0 + 4 * q;
    if (i >= n || c >= n) continue;
    const float4 v = ld4(S + i * kLdS + kYOff + 4 * q);
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
