// K9: one pw-wide panel of a batched blocked LU with magnitude partial
// pivoting (LAPACK getrf's panel step: getf2 on the block column, then
// laswp on the rest of each row), plus the inverses of the panel's two
// pw x pw diagonal triangles, one thread block per matrix, for sm_90a.
//
// Replaces the TPU kernel cuda_matrix_inversion_tpu/ops/lu_bign.py::
// _panel_kernel (pallas_call in _call_panel, lu_bign.py:195).  The blocked
// LU ops/lu_bign.py::inverse_lu_big launches it once per panel and does the
// O(n^3) work between launches as batched fp32 products (U12 = L11^-1 A12,
// the trailing update, the getri substitutions, the polish).
//
// Semantics, for the panel at columns k0..k0+pw-1 of the (n, n) work
// matrix whose first k0 columns are already factored:
//   * per column j the pivot is the first maximum of |W[i][k0+j]| over
//     rows i >= k0+j (first in row order after the earlier swaps); the two
//     rows are swapped, the multipliers stored in place
//     (W[i][k0+j] /= pivot) and the rest of the panel takes the rank-1
//     update, all in fp32;
//   * the panel's swaps are applied to the columns left and right of the
//     panel too, so the work matrix holds PA (rows physically permuted, as
//     LAPACK's laswp leaves it), and to ``perm`` (row i of PA is row
//     perm[i] of A); ipiv gets the 0-based pivot rows;
//   * ldi = L11^-1 (unit lower) and udi = U11^-1 of the pw x pw diagonal
//     block.
// Each elementwise update is spelled __fmul_rn / __fsub_rn (no FMA
// contraction) and each quotient is IEEE division, so the kernel repeats the
// plain PyTorch version lu_panel_plain operation for operation, and every
// element of the triangles takes its terms in the plain order.  A zero
// pivot is never clamped: that member alone goes non-finite.
//
// What bounds it on the card: latency, not bytes or operations.  The
// launches of one call read and write each panel once (sum over panels of
// (n-k0) pw fp32 a matrix) plus the rows their swaps move, and do
// ~(n-k0) pw^2 flops a panel: 0.15 ms at 100x512 against the bytes.  The
// time goes to the serial chain of pw pivot steps and to dependent
// round trips.  The design:
//   * the panel is loaded with 16-byte cp.async copies, all in flight, at
//     a row stride of 4*odd floats (68 / 36 / 20 at pw = 64 / 32 / 16), so
//     every row is 16-byte aligned and float4 reads down 8 consecutive rows
//     hit distinct banks; pw is a template parameter for 16, 32 and 64 (no
//     run-time division, unrolled float4 updates), other widths run a
//     generic instance at an odd stride with 4-byte accesses;
//   * rows never move in shared memory: each slot keeps its row and its
//     current position in the stride's spare column, so a pivot swap is two
//     position updates.  A column costs one block barrier: the block's best
//     candidate (two 32-bit warp max reductions of a 64-bit key, one shared
//     atomic a warp, triple-buffered by column; the first-maximum tie-break
//     compares positions), then the pivot.  The update is blocked by 4
//     columns, which keeps every element's operations and their order:
//     the slot owners take column j's step on the rest of its block (one
//     float4 a row, one IEEE division), which also gives them column j+1's
//     candidates; at the block's end, one barrier more, its pivot rows take
//     the block's earlier steps past the block, and then every thread takes
//     the block's 4 steps, in order, on one fixed group of 4 columns over
//     many rows (one float4 read and write for 4 steps), the owners of the
//     next block's first column taking its candidates.  So 1.25 block
//     barriers a column, and the panel is read and written once a block
//     instead of once a column (widths other than 16, 32, 64: one thread a
//     row, the whole row each column, one barrier);
//   * the swaps compose into one row map: position i < pw holds the row of
//     slot piv_slot[i], and a slot s < pw whose position ended past the
//     block holds row s.  The rows outside the panel then move as one
//     gather, out[r] = in[sigma(r)] over at most 2 pw rows, by all threads
//     in column chunks staged in the free slots: every 16-byte cp.async of
//     a chunk in flight, one block barrier, then the stores (no chain of
//     dependent global accesses); perm and ipiv move by many threads;
//   * the triangles go by column with no barrier: thread c owns column c
//     of L11^-1 (or of U11^-1) and runs the plain order of each element's
//     terms (k ascending for L11^-1; kk descending, then the division, for
//     U11^-1) against the diagonal block, reloaded into the first pw slots;
//     it keeps its column as a free slot's row (float4 loads on distinct
//     banks), takes two elements at a time, and writes ldi and udi
//     straight to global memory.
// None of the TPU kernel's workarounds (rows factored in scattered
// positions, the destination vector, one-hot gathers on the MXU, the
// transposed panel) are needed.  Tensor cores do not apply: the rank-1
// updates are fp32 and keep their bits.
//
// Ceiling: the panel of the first launch must fit one block's shared
// memory: max(m, 3 pw) rows at the stride, plus 7 pw + 12 words, at most
// 232,448 bytes (pw = 64: n <= 847; 32: n <= 1607; 16: n <= 2899; 8, at
// stride 9: n <= 6449).

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

// Row stride: 4*odd floats for the templated widths (16-byte rows), else
// odd; always at least pw + 1 (the spare column holds the slot's position).
__host__ __device__ constexpr int panel_ld(int pw) {
  return (pw == 16 || pw == 32 || pw == 64)
             ? ((pw + 3) / 4 % 2 ? (pw + 3) / 4 : (pw + 3) / 4 + 1) * 4
             : (pw % 2 ? pw + 2 : pw + 1);
}

// Words besides the panel: three 64-bit candidates (and 16-byte
// alignment) before it; ipiv, piv_slot and slot_at (pw each), the gather's
// rows (2 pw destinations and sources) and its row count after it.
__host__ __device__ constexpr int panel_tail_words(int pw) {
  return 8 + 7 * pw + 4;
}

// Dynamic shared memory of one launch over m = n - k0 panel rows.
size_t panel_smem(int m, int pw) {
  const size_t rows = m > 3 * pw ? m : 3 * pw;
  return (rows * panel_ld(pw) + panel_tail_words(pw)) * sizeof(float);
}

// Four elements' step of one column: v - l * u, unfused.
__device__ __forceinline__ float4 step4(float4 v, float l, float4 u) {
  return make_float4(__fsub_rn(v.x, __fmul_rn(l, u.x)),
                     __fsub_rn(v.y, __fmul_rn(l, u.y)),
                     __fsub_rn(v.z, __fmul_rn(l, u.z)),
                     __fsub_rn(v.w, __fmul_rn(l, u.w)));
}

// v[0..8) = p[0..8), p 16-byte aligned.
__device__ __forceinline__ void ld8(float* v, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
  v[4] = y.x;
  v[5] = y.y;
  v[6] = y.z;
  v[7] = y.w;
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// A row's candidate for the pivot search as one 64-bit key, larger is
// better: the magnitude's bits (monotonic for non-negative floats), then
// the lower position, then the slot; 0 for a NaN magnitude, which never
// wins (no candidate at all leaves row j the pivot).
__device__ __forceinline__ unsigned long long cand_key(float x, int pos,
                                                       int slot) {
  const float v = fabsf(x);
  return v == v ? static_cast<unsigned long long>(__float_as_uint(v)) << 32 |
                      static_cast<unsigned>(0xffff - pos) << 16 |
                      static_cast<unsigned>(slot)
                : 0ull;
}

// Column c of L11^-1 (unit lower), kept in the row yc[0..pw): element i
// takes, k ascending, y_i -= d[i][k] y_k, the plain order.  The lanes of a
// warp run the same k from kmin (at most their smallest column, a multiple
// of 8) on: for k < c, y_k is +0 and the term leaves y_i as the plain
// version leaves it (+0, or 1 at i = c).  Two elements at a time (their
// chains interleave); for PW > 0 the loads are float4 (a quarter-warp's
// rows yc sit 4*odd floats apart: no bank conflict).
template <int PW>
__device__ __forceinline__ void lower_inverse_column(const float* D, float* yc,
                                                     float* out, int c,
                                                     int kmin, int pw,
                                                     int ld) {
  for (int i = 0; i < pw; i += 2) {
    const bool two = i + 1 < pw;
    float a0 = i == c ? 1.f : 0.f, a1 = i + 1 == c ? 1.f : 0.f;
    const float* d0 = D + i * ld;
    const float* d1 = d0 + (two ? ld : 0);
    int k = kmin;
    if constexpr (PW > 0) {
      for (; k + 8 <= i; k += 8) {
        float y[8], p[8], q[8];
        ld8(y, yc + k);
        ld8(p, d0 + k);
        ld8(q, d1 + k);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          a0 = __fsub_rn(a0, __fmul_rn(p[u], y[u]));
          a1 = __fsub_rn(a1, __fmul_rn(q[u], y[u]));
        }
      }
    }
    for (; k < i; ++k) {
      a0 = __fsub_rn(a0, __fmul_rn(d0[k], yc[k]));
      a1 = __fsub_rn(a1, __fmul_rn(d1[k], yc[k]));
    }
    yc[i] = a0;
    out[i * pw] = a0;
    if (two) {
      a1 = __fsub_rn(a1, __fmul_rn(d1[i], a0));
      yc[i + 1] = a1;
      out[(i + 1) * pw] = a1;
    }
  }
}

// Column c of U11^-1, kept in the row zc[0..pw): element i takes, kk
// descending, z_i -= d[i][kk] z_kk, then z_i /= d[i][i], the plain order.
// The lanes of a warp run the same kk from kmax (at least their largest
// column, 7 mod 8) down: for kk > c, z_kk is a zero and the term leaves z_i
// as the plain version leaves it.  Two elements at a time, as above.
template <int PW>
__device__ __forceinline__ void upper_inverse_column(const float* D, float* zc,
                                                     float* out, int c,
                                                     int kmax, int pw,
                                                     int ld) {
  for (int i = pw - 1; i >= 0; i -= 2) {
    const bool two = i >= 1;
    float a0 = i == c ? 1.f : 0.f, a1 = i - 1 == c ? 1.f : 0.f;
    const float* d0 = D + i * ld;
    const float* d1 = d0 - (two ? ld : 0);
    int kk = kmax;
    if constexpr (PW > 0) {
      for (; kk - 8 >= i; kk -= 8) {  // kk .. kk-7, from zc + kk - 7
        float z[8], p[8], q[8];
        ld8(z, zc + kk - 7);
        ld8(p, d0 + kk - 7);
        ld8(q, d1 + kk - 7);
#pragma unroll
        for (int u = 7; u >= 0; --u) {
          a0 = __fsub_rn(a0, __fmul_rn(p[u], z[u]));
          a1 = __fsub_rn(a1, __fmul_rn(q[u], z[u]));
        }
      }
    }
    for (; kk > i; --kk) {
      a0 = __fsub_rn(a0, __fmul_rn(d0[kk], zc[kk]));
      a1 = __fsub_rn(a1, __fmul_rn(d1[kk], zc[kk]));
    }
    a0 = a0 / d0[i];
    zc[i] = a0;
    out[i * pw] = a0;
    if (two) {
      a1 = __fsub_rn(a1, __fmul_rn(d1[i], a0));
      a1 = a1 / d1[i - 1];
      zc[i - 1] = a1;
      out[(i - 1) * pw] = a1;
    }
  }
}

// PW = 16, 32 or 64, or 0 for any other width (given as pw_arg).
template <int PW>
__global__ void __launch_bounds__(kThreads)
    lu_panel_kernel(float* __restrict__ work, int* __restrict__ perm,
                    int* __restrict__ ipiv, float* __restrict__ ldi,
                    float* __restrict__ udi, int n, int k0, int pw_arg) {
  extern __shared__ __align__(16) float smem[];
  const int pw = PW > 0 ? PW : pw_arg;
  const int ld = panel_ld(pw);
  const int m = n - k0;
  const int rows = m > 3 * pw ? m : 3 * pw;
  // three columns' best candidates (a column's, the next one's, and the
  // one after, reset while the first is read), then the panel
  unsigned long long* s_best = reinterpret_cast<unsigned long long*>(smem);
  float* P = smem + 8;  // slot s (local row s of the panel) at P[s * ld]
  int* s_ipiv = reinterpret_cast<int*>(P + rows * ld);  // pw: pivot rows
  int* s_piv_slot = s_ipiv + pw;     // pw: the slot at position j < pw
  int* s_slot_at = s_piv_slot + pw;  // pw: the slot now at position j
  int* s_tdst = s_slot_at + pw;      // 2 pw: the gather's destination rows
  int* s_tsrc = s_tdst + 2 * pw;     // 2 pw: and its source rows
  int* s_nt = s_tsrc + 2 * pw;       // the gather's row count
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float* A = work + static_cast<size_t>(blockIdx.x) * n * n;
  int* pm = perm + static_cast<size_t>(blockIdx.x) * n;
  // 16-byte global accesses: rows and panel columns on 16 bytes
  const bool vec = PW > 0 && n % 4 == 0 && k0 % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(work) & 15) == 0;
  const int q4 = pw / 4;

  // the panel, all copies in flight; each slot's position in its spare
  // column
  if (vec) {
    for (int e = tid; e < m * q4; e += kThreads) {
      const int i = e / q4, q = e - i * q4;
      cp_async16(P + i * ld + 4 * q,
                 A + static_cast<size_t>(k0 + i) * n + k0 + 4 * q);
    }
  } else {
    for (int e = tid; e < m * pw; e += kThreads) {
      const int i = e / pw, c = e - i * pw;
      cp_async4(P + i * ld + c, A + static_cast<size_t>(k0 + i) * n + k0 + c);
    }
  }
  for (int i = tid; i < m; i += kThreads) P[i * ld + pw] = __int_as_float(i);
  for (int i = tid; i < pw; i += kThreads) s_slot_at[i] = i;
  if (tid == 0) {
    *s_nt = 0;
    s_best[0] = s_best[1] = 0ull;
  }
  cp_async_wait_all();
  __syncthreads();

  // column 0's candidates from this thread's slots
  unsigned long long key = 0ull;
  for (int s = tid; s < m; s += kThreads) {
    key = max_key(key, cand_key(P[s * ld], s, s));
  }
  // the chain.  Each column j: the block's best candidate (two 32-bit
  // warp max reductions of a 64-bit key, one shared atomic a warp), one
  // barrier, the pivot; the two positions move.
  int sps[4];  // the pivot slots of the current block of 4 columns (PW > 0)
  for (int j = 0; j < pw; ++j) {
    const unsigned hi = __reduce_max_sync(0xffffffffu,
                                          static_cast<unsigned>(key >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu, static_cast<unsigned>(key >> 32) == hi
                         ? static_cast<unsigned>(key)
                         : 0u);
    if (lane == 0)
      atomicMax(s_best + j % 3,
                static_cast<unsigned long long>(hi) << 32 | lo);
    __syncthreads();
    key = s_best[j % 3];
    const int sj = s_slot_at[j];
    const bool found = key != 0ull;
    const int p = found ? 0xffff - static_cast<int>(key >> 16 & 0xffff) : j;
    const int sp = found ? static_cast<int>(key & 0xffff) : sj;
    if (tid == 0) {
      s_ipiv[j] = k0 + p;
      s_piv_slot[j] = sp;
      if (p != j && p < pw) s_slot_at[p] = sj;
      s_best[(j + 2) % 3] = 0ull;  // last read before this column's barrier
    }
    const float* prow = P + sp * ld;
    key = 0ull;
    if constexpr (PW > 0) {
      // blocked by 4 columns: the rows past j take column j's step on the
      // block's 4 columns now (one float4), and the columns past the block
      // take the block's 4 steps together at its end
      const int b4 = j & ~3, k = j & 3;
#pragma unroll
      for (int i = 0; i < 4; ++i)  // static indices: sps stays in registers
        if (i == k) sps[i] = sp;
      const float4 u = *reinterpret_cast<const float4*>(prow + b4);
      const float piv = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
      for (int s = tid; s < m; s += kThreads) {
        float* row = P + s * ld;
        int ps = __float_as_int(row[pw]);
        if (s == sp) {
          row[pw] = __int_as_float(j);
          continue;
        }
        if (s == sj && p != j) {
          ps = p;
          row[pw] = __int_as_float(p);
        }
        if (ps <= j) continue;
        float4 r = *reinterpret_cast<const float4*>(row + b4);
        if (k == 0) {
          const float l = r.x / piv;
          r.x = l;
          r.y = __fsub_rn(r.y, __fmul_rn(l, u.y));
          r.z = __fsub_rn(r.z, __fmul_rn(l, u.z));
          r.w = __fsub_rn(r.w, __fmul_rn(l, u.w));
          key = max_key(key, cand_key(r.y, ps, s));
        } else if (k == 1) {
          const float l = r.y / piv;
          r.y = l;
          r.z = __fsub_rn(r.z, __fmul_rn(l, u.z));
          r.w = __fsub_rn(r.w, __fmul_rn(l, u.w));
          key = max_key(key, cand_key(r.z, ps, s));
        } else if (k == 2) {
          const float l = r.z / piv;
          r.z = l;
          r.w = __fsub_rn(r.w, __fmul_rn(l, u.w));
          key = max_key(key, cand_key(r.w, ps, s));
        } else {
          r.w = r.w / piv;
        }
        *reinterpret_cast<float4*>(row + b4) = r;
      }
      if (k == 3 && b4 + 4 < PW) {
        // the block's pivot rows past the block, one thread a group of 4
        // columns: pivot row i takes the steps of the block's columns
        // before its own, in order (their rows are final)
        if (tid > b4 / 4 && tid < PW / 4) {
          float4 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = *reinterpret_cast<const float4*>(P + sps[i] * ld + 4 * tid);
#pragma unroll
          for (int i = 1; i < 4; ++i) {
#pragma unroll
            for (int h = 0; h < i; ++h)
              v[i] = step4(v[i], P[sps[i] * ld + b4 + h], v[h]);
            *reinterpret_cast<float4*>(P + sps[i] * ld + 4 * tid) = v[i];
          }
        }
        __syncthreads();
        // the other rows past the block: each thread one group of 4 of the
        // ga groups past the block, rows kThreads / ga apart, the block's 4
        // steps in order; the owners of the next column take its candidates
        const int ga = PW / 4 - b4 / 4 - 1;
        const int rstep = kThreads / ga;
        if (tid < rstep * ga) {
          const int g4 = b4 + 4 + 4 * (tid % ga);
          float4 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = *reinterpret_cast<const float4*>(P + sps[i] * ld + g4);
          for (int s = tid / ga; s < m; s += rstep) {
            float* row = P + s * ld;
            const int ps = __float_as_int(row[pw]);
            if (ps <= j) continue;
            const float4 l = *reinterpret_cast<const float4*>(row + b4);
            float4 r = *reinterpret_cast<const float4*>(row + g4);
            r = step4(r, l.x, v[0]);
            r = step4(r, l.y, v[1]);
            r = step4(r, l.z, v[2]);
            r = step4(r, l.w, v[3]);
            *reinterpret_cast<float4*>(row + g4) = r;
            if (g4 == b4 + 4) key = max_key(key, cand_key(r.x, ps, s));
          }
        }
      }
    } else {
      // any width: one thread a row, the whole row at once
      const float piv = prow[j];
      for (int s = tid; s < m; s += kThreads) {
        float* row = P + s * ld;
        int ps = __float_as_int(row[pw]);
        if (s == sp) {
          row[pw] = __int_as_float(j);
          continue;
        }
        if (s == sj && p != j) {
          ps = p;
          row[pw] = __int_as_float(p);
        }
        if (ps <= j) continue;
        const float l = row[j] / piv;
        for (int c = j + 1; c < pw; ++c)
          row[c] = __fsub_rn(row[c], __fmul_rn(l, prow[c]));
        row[j] = l;
        if (j + 1 < pw) key = max_key(key, cand_key(row[j + 1], ps, s));
      }
    }
  }
  __syncthreads();

  // write-back: slot s to row k0 + position(s)
  if (vec) {
    for (int e = tid; e < m * q4; e += kThreads) {
      const int i = e / q4, q = e - i * q4;
      const int r = __float_as_int(P[i * ld + pw]);
      *reinterpret_cast<float4*>(A + static_cast<size_t>(k0 + r) * n + k0 +
                                 4 * q) =
          *reinterpret_cast<const float4*>(P + i * ld + 4 * q);
    }
  } else {
    for (int e = tid; e < m * pw; e += kThreads) {
      const int i = e / pw, c = e - i * pw;
      const int r = __float_as_int(P[i * ld + pw]);
      A[static_cast<size_t>(k0 + r) * n + k0 + c] = P[i * ld + c];
    }
  }
  // the composed row map: position e < pw holds slot piv_slot[e]; a slot
  // s < pw whose position ended at pw or past holds row s there
  for (int e = tid; e < 2 * pw; e += kThreads) {
    int dst = e, src = e;
    if (e < pw) {
      src = s_piv_slot[e];
    } else {
      src = e - pw;
      dst = __float_as_int(P[src * ld + pw]);
      if (dst < pw) dst = src;
    }
    if (dst != src) {
      const int t = atomicAdd(s_nt, 1);
      s_tdst[t] = k0 + dst;
      s_tsrc[t] = k0 + src;
    }
  }
  for (int s = tid; s < pw; s += kThreads)
    ipiv[static_cast<size_t>(blockIdx.x) * pw + s] = s_ipiv[s];
  __syncthreads();

  // the factored diagonal block back into slots 0..pw-1, in position order;
  // perm's moved entries into registers (nt <= 2 pw <= 2 kThreads)
  if (vec) {
    for (int e = tid; e < pw * q4; e += kThreads) {
      const int i = e / q4, q = e - i * q4;
      cp_async16(P + i * ld + 4 * q,
                 A + static_cast<size_t>(k0 + i) * n + k0 + 4 * q);
    }
  } else {
    for (int e = tid; e < pw * pw; e += kThreads) {
      const int i = e / pw, c = e - i * pw;
      cp_async4(P + i * ld + c, A + static_cast<size_t>(k0 + i) * n + k0 + c);
    }
  }
  const int nt = *s_nt;
  int pv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = tid + u * kThreads;
    if (t < nt) pv[u] = pm[s_tsrc[t]];
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = tid + u * kThreads;
    if (t < nt) pm[s_tdst[t]] = pv[u];
  }

  // the gather out[r] = in[sigma(r)] on the columns outside the panel,
  // staged in the free slots pw.. (everything but the diagonal block) in
  // chunks of columns: every copy of a chunk in flight, one barrier, its
  // stores, one barrier
  if (nt > 0) {
    const int width = vec ? 4 : 1;
    float* stage = P + pw * ld;
    const int cap = (rows - pw) * ld / width;  // items the stage holds
    const int ng = (n - pw) / width;
    const int gc = min(ng, cap / nt);  // >= 1: nt <= 2 pw, cap >= 2 pw
    for (int g0 = 0; g0 < ng; g0 += gc) {
      const int cw = min(gc, ng - g0);
      const int items = nt * cw;
      for (int q = tid; q < items; q += kThreads) {
        const int t = q / cw;
        const int c = width * (g0 + q - t * cw);
        const float* src = A + static_cast<size_t>(s_tsrc[t]) * n +
                           (c < k0 ? c : c + pw);
        if (vec)
          cp_async16(stage + 4 * q, src);
        else
          cp_async4(stage + q, src);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int q = tid; q < items; q += kThreads) {
        const int t = q / cw;
        const int c = width * (g0 + q - t * cw);
        float* dst = A + static_cast<size_t>(s_tdst[t]) * n +
                     (c < k0 ? c : c + pw);
        if (vec)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(stage + 4 * q);
        else
          *dst = stage[q];
      }
      __syncthreads();
    }
  }

  // the triangles by column, against the diagonal block in slots 0..pw-1;
  // column c of L11^-1 kept in slot pw + c, of U11^-1 in slot 2 pw + c
  const size_t tri = static_cast<size_t>(blockIdx.x) * pw * pw;
  for (int job = tid; job < 2 * pw; job += kThreads) {
    if (job < pw) {
      const int kmin = __reduce_min_sync(__activemask(), job) & ~7;
      lower_inverse_column<PW>(P, P + (pw + job) * ld, ldi + tri + job, job,
                               kmin, pw, ld);
    } else {
      const int c = job - pw;
      const int kmax = min(__reduce_max_sync(__activemask(), c) | 7, pw - 1);
      upper_inverse_column<PW>(P, P + (2 * pw + c) * ld, udi + tri + c, c,
                               kmax, pw, ld);
    }
  }
}

const void* panel_kernel_for(int pw) {
  switch (pw) {
    case 16:
      return reinterpret_cast<const void*>(lu_panel_kernel<16>);
    case 32:
      return reinterpret_cast<const void*>(lu_panel_kernel<32>);
    case 64:
      return reinterpret_cast<const void*>(lu_panel_kernel<64>);
    default:
      return reinterpret_cast<const void*>(lu_panel_kernel<0>);
  }
}

}  // namespace

// work: (batch, n, n) fp32, updated in place (the panel factored, its swaps
// applied to the other columns); perm: (batch, n) int32, updated in place;
// ipiv: (batch, pw) int32; ldi, udi: (batch, pw, pw) fp32; all contiguous
// on `device`.  Returns the CUDA error of the launch.
extern "C" int cmi_lu_panel(float* work, int* perm, int* ipiv, float* ldi,
                            float* udi, int batch, int n, int k0, int pw,
                            int device, void* stream) {
  if (batch < 0 || pw < 1 || k0 < 0 || k0 + pw > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = panel_smem(n - k0, pw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const void* fn = panel_kernel_for(pw);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&work, &perm, &ipiv, &ldi, &udi, &n, &k0, &pw};
  err = cudaLaunchKernel(fn, dim3(batch), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
