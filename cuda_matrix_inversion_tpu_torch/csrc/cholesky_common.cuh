// Device code shared by K3, K4 (cholesky.cu) and K5, K10 (gp.cu): one
// panel-blocked Cholesky factorization of a matrix held in shared memory,
// and the inverse W = L^-1 of the factor (K3 and K10's emit_w variant).
// The matrix is held square (CholSquare, n <= 128) or, past 128 up to 256,
// as its packed lower triangle (CholPacked: the square would not fit one
// block), where K10's W replaces L in place (chol_tri_inverse_in_place).
//
// Arithmetic, per element, in this order (the JAX kernel's
// _cholesky_factor_body and the plain versions in ops/cuda_cholesky.py):
//   A[i][j] -= L[i][k] * L[j][k]   k = 0, 1, ..., j-1      (i >= j)
//   inv_j = 1 / sqrtf(A[j][j])     IEEE sqrt and reciprocal, never rsqrtf
//                                  (the TPU kernel avoids its approximate
//                                  rsqrt for the same reason)
//   L[i][j] = A[i][j] * inv_j      (i > j),  L[j][j] = A[j][j] * inv_j
// and for W, from W = I:
//   W[i][j] -= L[i][k] * W[k][j]   k = 0, 1, ..., i-1 (zero for k < j)
//   W[i][j] /= L[i][i]             a true division
// Every update is spelled __fmul_rn / __fsub_rn (no FMA contraction).  A
// schedule that gives each element exactly this sequence gives the same
// bits whatever its tiling, panel width or thread mapping, so both
// functions repeat the plain versions bit for bit (the unit test
// tests/test_torch_cholesky.py::test_panel_schedule_is_bitwise_the_plain_order
// replays both schedules in plain PyTorch).  A member that is not positive
// definite gives NaN (or inf) from its failing column on; other blocks are
// untouched, and no barrier depends on the data.
//
// What bounds them: the two chains inside one block, n pivots (an IEEE
// sqrt and reciprocal each, ~134 clocks a step) for the factor and n
// divisions for W's first column, and the shared-memory traffic of the
// trailing updates around them; and, beside the chain, the issue slots the
// other warps take from it (a pivot step 139 clocks alone, 260 beside 7
// tile warps and 484 beside 15: bench/chol_band_probe.py latency).  The
// design: panels of kCholPanel columns (rows for W).  One warp factors
// each diagonal block in registers while the other warps apply the
// previous panel to the trailing triangle from 64 x 8 register tiles, and
// one thread a column solves W's panel rows while the warps that own no
// column apply the previous panel below them; on the square layout two
// barriers a panel for the factor and one for W.  Past 128, where one
// 512-thread block holds an SM, K4 and K5 run chol_factor_band: the panel
// warp runs a panel ahead of the tile warps, which take the next panel's
// column first (with its strip rows), and two named-barrier hand-offs a
// panel replace the block's barriers; K5's right-hand sides ride through
// it as two bordered rows.  Where two blocks share an SM the two-barrier
// factor measured faster and stays (chol_band_plan).
// Every element goes through shared memory once a panel, and every hot
// read is a float4 on a row stride (chol_ld) that keeps it free of bank
// conflicts.  On the packed layout W is built right-looking in place
// (chol_tri_inverse_in_place).

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// Columns a panel (factor) and rows a panel (L^-1), a multiple of 8.  Any
// value gives the same bits; at 16 warp 0's register copy of the diagonal
// block spills.
constexpr int kCholPanel = 8;
// A trailing-update tile: 64 rows (two per lane) by 8 columns.
constexpr int kTileRows = 64;
constexpr int kTileCols = 8;

// Row stride of an n x n matrix in shared memory: a multiple of 4 floats
// whose quarter is odd, at least n rounded up to 8.  Every row then starts
// on 16 bytes, so a lane reads 4 consecutive elements of a row as one
// float4, and 8 lanes reading float4s at one column of 8 consecutive rows
// hit 8 distinct groups of 4 banks (no conflict).  A lane reading single
// floats down a column would conflict 4 ways: no hot loop does.
__host__ __device__ __forceinline__ int chol_ld(int n) {
  return (n + 7) / 8 * 8 + 4;
}

// Where row i of the matrix starts in shared memory, in floats.  The
// functions below take the layout as a template argument.
//
// CholSquare: n rows of stride ld = chol_ld(n), the n <= 128 instances.
struct CholSquare {
  int ld;
  static constexpr bool kPacked = false;
  static constexpr int kRowTiles = 2;  // 64-row tiles at n <= 128
  __host__ __device__ __forceinline__ int row(int i) const { return i * ld; }
};

// CholPacked: the lower triangle only, the band instances (129 <= n <=
// 256), whose n x chol_ld(n) square would not fit one block's shared
// memory past n ~ 232.  Rows go in groups of 8: group g (rows 8g .. 8g+7,
// at most 8g + 8 elements a row) has the odd stride of 2g + 3 float4s
// (8g + 12 floats), so
//   row(8g + r) = 32 g (g + 2) + 4 r (2g + 3).
// Every row starts on 16 bytes, and the 8 rows of a group start in 8
// distinct groups of 4 banks (r (2g + 3) mod 8 is distinct for r < 8): 8
// lanes reading float4s at one column of 8 rows of a group never conflict,
// the property chol_ld gives the square layout.  The hot loops' rows start
// at multiples of 8 (panels, tiles and strips begin at k0 + 8).  A row
// holds its elements j <= i; a float4 may run past the diagonal into the
// row's padding (j <= i implies j + 3 < 8g + 12), never into the next row.
// A read of columns past a row's padding (a tile's columns above its first
// rows) lands in later rows or their padding and is never stored.
struct CholPacked {
  static constexpr bool kPacked = true;
  static constexpr int kRowTiles = 4;  // 64-row tiles at n <= 256
  __host__ __device__ __forceinline__ int row(int i) const {
    const int g = i >> 3, r = i & 7;
    return 32 * g * (g + 2) + 4 * r * (2 * g + 3);
  }
  // row(i + 1) - row(i) within i's group of 8
  __host__ __device__ __forceinline__ int stride(int i) const {
    return 8 * (i >> 3) + 12;
  }
};

// Floats of the packed lower triangle of an n x n matrix (34,816 at n =
// 256: 136 KB).
__host__ __device__ __forceinline__ int chol_packed_floats(int n) {
  const int g = (n + 7) / 8;
  return 32 * g * (g + 2);
}

// Threads a block of a packed instance that asks for smem bytes of shared
// memory: 256 where two such blocks fit an SM (228 KB, 1 KB reserved a
// block), else 512, one block an SM with 16 warps (at most 128 registers a
// thread either way).  From the A/B of bench/chol_band_probe.py ab.
inline int chol_band_threads(size_t smem) {
  return 2 * (smem + 1024) <= 233472 ? 256 : 512;
}

// Streaming multiprocessors of `device`, read once a device.
inline int chol_sm_count(int device) {
  static std::atomic<int> sms[64];
  if (device < 0 || device >= 64) return 0;
  int v = sms[device].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    sms[device].store(v, std::memory_order_relaxed);
  }
  return v;
}

__device__ __forceinline__ void chol_st4(float* p, float x, float y, float z,
                                         float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// v[0..4) = p[0..4), p 16-byte aligned.
__device__ __forceinline__ void chol_get4(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// One warp's tile of a trailing update: for the rows i = i0 + lane + 32a
// (a < A, i < n) and the columns j = j0 + c (c < 8, j0 % 8 == 0),
//   C[i][j] -= X[i][k] * Y(k, j)   for k = k0, ..., k0 + NB - 1 in order,
// stored where keep(i, j) (keep(i, j + 3) must imply keep(i, j)).
// Y(k, j) = Y[j][k] when YT (the factor: both operands are rows of the
// strip) and Y[k][j] otherwise (W).  Every load is a float4: C's and X's
// rows along the lanes, Y's by broadcast.  Row indices past n are clamped
// to n - 1, so they compute garbage that is not stored.
template <int NB, int A, bool YT, typename Keep, typename Lay>
__device__ __forceinline__ void chol_tile(float* C, const float* X,
                                          const float* Y, Keep keep, int i0,
                                          int j0, int k0, int n, Lay lay) {
  const int lane = threadIdx.x & 31;
  int ri[A];
  float acc[A][kTileCols];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    ri[a] = min(i0 + lane + 32 * a, n - 1);
    // a packed row above the tile's columns (all garbage, none stored)
    // reads its own first columns instead of other rows' elements
    const int jc = Lay::kPacked && ri[a] < j0 ? 0 : j0;
#pragma unroll
    for (int h = 0; h < kTileCols; h += 4)
      chol_get4(&acc[a][h], C + lay.row(ri[a]) + jc + h);
  }
#pragma unroll
  for (int kh = 0; kh < NB; kh += 4) {
    float xv[A][4], yv[kTileCols][4];  // yv[c][q] = Y(k0 + kh + q, j0 + c)
#pragma unroll
    for (int a = 0; a < A; ++a) chol_get4(xv[a], X + lay.row(ri[a]) + k0 + kh);
    if (YT) {
#pragma unroll
      for (int c = 0; c < kTileCols; ++c)
        chol_get4(yv[c], Y + lay.row(min(j0 + c, n - 1)) + k0 + kh);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < kTileCols; h += 4) {
          float t[4];
          chol_get4(t, Y + lay.row(k0 + kh + q) + j0 + h);
#pragma unroll
          for (int u = 0; u < 4; ++u) yv[h + u][q] = t[u];
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c)
          acc[a][c] = __fsub_rn(acc[a][c], __fmul_rn(xv[a][q], yv[c][q]));
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int i = i0 + lane + 32 * a;
#pragma unroll
    for (int h = 0; h < kTileCols; h += 4) {
      float* d = C + lay.row(ri[a]) + j0 + h;
      if (keep(i, j0 + h + 3)) {
        chol_st4(d, acc[a][h], acc[a][h + 1], acc[a][h + 2], acc[a][h + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (keep(i, j0 + h + u)) d[u] = acc[a][h + u];
      }
    }
  }
}

// chol_tile with two row slices where the second holds a row below n, else
// one.
template <int NB, bool YT, typename Keep, typename Lay>
__device__ __forceinline__ void chol_tile_rows(float* C, const float* X,
                                               const float* Y, Keep keep,
                                               int i0, int j0, int k0, int n,
                                               Lay lay) {
  if (i0 + 32 < n)
    chol_tile<NB, 2, YT>(C, X, Y, keep, i0, j0, k0, n, lay);
  else
    chol_tile<NB, 1, YT>(C, X, Y, keep, i0, j0, k0, n, lay);
}

// Copy the n x n matrix at src (device memory, rows of n) into dst (shared
// memory, layout lay) as dst[i][j] = f(i, j, src[i][j]); the packed layout
// reads and stores only j <= i (by float4s of 4 columns, the last of a row
// running past the diagonal into the row's padding).  Each thread keeps
// kLoadDepth float4 loads (or 4 kLoadDepth float loads) in flight, so the
// copy waits on the latency of device memory a few times instead of once
// per element.  The caller adds the barrier.
constexpr int kLoadDepth = 4;

template <typename Lay, typename F>
__device__ __forceinline__ void chol_load(const float* __restrict__ src,
                                          float* dst, int n, Lay lay, F f) {
  const int nn = n * n;
  const int step = kLoadDepth * blockDim.x;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int q0 = threadIdx.x; q0 < nn / 4; q0 += step) {
      float v[kLoadDepth][4];
#pragma unroll
      for (int u = 0; u < kLoadDepth; ++u) {
        const int q = q0 + u * blockDim.x;
        const int i = 4 * q / n, j = 4 * q - i * n;
        if (q < nn / 4 && (!Lay::kPacked || j <= i))
          chol_get4(v[u], src + 4 * q);
      }
#pragma unroll
      for (int u = 0; u < kLoadDepth; ++u) {
        const int q = q0 + u * blockDim.x;
        const int i = 4 * q / n, j = 4 * q - i * n;
        if (q < nn / 4 && (!Lay::kPacked || j <= i))
          chol_st4(dst + lay.row(i) + j, f(i, j, v[u][0]),
                   f(i, j + 1, v[u][1]), f(i, j + 2, v[u][2]),
                   f(i, j + 3, v[u][3]));
      }
    }
    return;
  }
  for (int e0 = threadIdx.x; e0 < nn; e0 += 4 * step) {
    float v[4 * kLoadDepth];
#pragma unroll
    for (int u = 0; u < 4 * kLoadDepth; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < nn && (!Lay::kPacked || e % n <= e / n) ? src[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4 * kLoadDepth; ++u) {
      const int e = e0 + u * blockDim.x;
      const int i = e / n, j = e - i * n;
      if (e < nn && (!Lay::kPacked || j <= i))
        dst[lay.row(i) + j] = f(i, j, v[u]);
    }
  }
}

// The factor of one diagonal block in registers: b[i][j] (j <= i) holds the
// block, updated by every earlier column; on return b[i][j] = L[i][j]
// (b[i][i] = L[i][i]) and inv[c] = 1 / sqrtf of the pivot, both IEEE.
template <int NB>
__device__ __forceinline__ void chol_block_factor(float (&b)[NB][NB],
                                                  float (&inv)[NB]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    inv[c] = __frcp_rn(__fsqrt_rn(b[c][c]));  // 1 / sqrtf, both IEEE
#pragma unroll
    for (int i = c; i < NB; ++i) b[i][c] = __fmul_rn(b[i][c], inv[c]);
#pragma unroll
    for (int j = c + 1; j < NB; ++j)
#pragma unroll
      for (int i = j; i < NB; ++i)
        b[i][j] = __fsub_rn(b[i][j], __fmul_rn(b[i][c], b[j][c]));
  }
}

// Warp 0's part of the factor: the diagonal block of rows and columns
// [k0, k0 + w), first updated by the previous panel's columns [kp, k0)
// when kp < k0 (their L is final in K): lane e takes element e of the
// block's lower triangle.  Then every lane holds and factors the whole
// block in registers, so the chain of pivots waits on no shuffle.  Lane 0
// stores the block's L below the diagonal and, on the diagonal, L[k][k]
// when `last` (no strip follows) or else inv_k, where the strip reads it.
// Returns L[k0+lane][k0+lane] to lane < w.
template <int NB, typename Lay>
__device__ __forceinline__ float chol_diag_block(float* K, int k0, int w,
                                                 int kp, bool last, Lay lay) {
  const int lane = threadIdx.x & 31;
  if (kp < k0) {
    for (int e = lane; e < NB * (NB + 1) / 2; e += 32) {
      int i = 0;
#pragma unroll
      for (int r = 1; r < NB; ++r)
        if (e >= r * (r + 1) / 2) i = r;
      const int j = e - i * (i + 1) / 2;
      if (i < w) {
        float x[NB], y[NB];
#pragma unroll
        for (int h = 0; h < NB; h += 4) {
          chol_get4(x + h, K + lay.row(k0 + i) + kp + h);
          chol_get4(y + h, K + lay.row(k0 + j) + kp + h);
        }
        float acc = K[lay.row(k0 + i) + k0 + j];
#pragma unroll
        for (int kk = 0; kk < NB; ++kk)
          acc = __fsub_rn(acc, __fmul_rn(x[kk], y[kk]));
        K[lay.row(k0 + i) + k0 + j] = acc;
      }
    }
    __syncwarp();
  }
  // b[i][j] (j <= i) holds the block's row k0 + i; rows past w are zeros
  // whose results are not stored.
  float b[NB][NB], inv[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      b[i][j] = i < w ? K[lay.row(k0 + i) + k0 + j] : 0.f;
  chol_block_factor<NB>(b, inv);
  __syncwarp();  // every lane has read the block before lane 0 stores
  float lrr = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (lane == 0 && i < w) {
      float* row = K + lay.row(k0 + i) + k0;
#pragma unroll
      for (int j = 0; j < i; ++j) row[j] = b[i][j];
      row[i] = last ? b[i][i] : inv[i];
    }
    if (lane == i) lrr = b[i][i];
  }
  return lrr;
}

// Factor the symmetric matrix in K (the square layout, n <= 128; the band
// instances run chol_factor_band; only the lower triangle is read) in
// place: on return the lower triangle holds L, the strict upper
// triangle is untouched.  The caller has passed a barrier since K was
// written; the function ends with one.  Panels of kCholPanel columns; with
// panel [k0, k1) factored on its diagonal block, two barriers a panel:
//   1. the strip: thread t solves row k1 + t of columns [k0, k1) from the
//      block's L and its inv_k (in element order: each L[i][k] after its
//      updates from the panel's earlier columns).
//   2. warp 0 puts the block's diagonal L[k][k] in place, then updates the
//      next diagonal block [k1, k2) with the panel and factors it
//      (chol_diag_block); meanwhile the other warps apply the panel to
//      their 64 x 8 tiles of the rest of the trailing triangle, rows
//      [k2, n), columns [k1, n).  So the chain of pivots runs beside the
//      trailing update instead of between its barriers.
// Every element of the trailing triangle takes the panel's columns in
// increasing order, after the earlier panels', whichever warp applies them.
// The trailing update walks the row tiles of 64 (Lay::kRowTiles at most,
// two), each with its column tiles up to its last row.  The walk is unrolled over them: as a plain loop it held more
// registers across a tile, and the square instances (80 registers) spilled.
template <typename Lay>
__device__ __forceinline__ void chol_factor(float* K, int n, Lay lay) {
  constexpr int NB = kCholPanel;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float lrr = 0.f;  // warp 0, lane r: L[k0+r][k0+r] of the current panel
  if (warp == 0) lrr = chol_diag_block<NB>(K, 0, min(NB, n), 0, n <= NB, lay);
  __syncthreads();
  for (int k0 = 0; k0 + NB < n; k0 += NB) {
    const int k1 = k0 + NB;
    const int k2 = min(k1 + NB, n);

    // 1. The strip below the panel's diagonal block.
    for (int i = k1 + tid; i < n; i += blockDim.x) {
      float* row = K + lay.row(i) + k0;
      float a[NB];
#pragma unroll
      for (int h = 0; h < NB; h += 4) chol_get4(a + h, row + h);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float* lc = K + lay.row(k0 + c) + k0;  // row k0+c of the block
        a[c] = __fmul_rn(a[c], lc[c]);                // * inv_{k0+c}
#pragma unroll
        for (int r = c + 1; r < NB; ++r)
          a[r] = __fsub_rn(a[r],
                           __fmul_rn(a[c], K[lay.row(k0 + r) + k0 + c]));
      }
#pragma unroll
      for (int h = 0; h < NB; h += 4)
        chol_st4(row + h, a[h], a[h + 1], a[h + 2], a[h + 3]);
    }
    __syncthreads();

    // 2. The next diagonal block on warp 0, the rest of the trailing
    // update on the others.
    if (warp == 0) {
      if (lane < NB) K[lay.row(k0 + lane) + k0 + lane] = lrr;
      lrr = chol_diag_block<NB>(K, k1, k2 - k1, k0, k2 == n, lay);
    } else {
      // tile t of the flat order over the row tiles [i0, i0 + 64), each
      // with its column tiles j0 = k1, k1 + 8, ... up to its last row
      int t = warp - 1;
#pragma unroll
      for (int r = 0; r < Lay::kRowTiles; ++r) {
        const int i0 = k2 + kTileRows * r;
        if (i0 >= n) break;
        const int cols = (min(i0 + kTileRows, n) - 1 - k1) / kTileCols + 1;
        for (; t < cols; t += nwarps - 1)
          chol_tile_rows<NB, true>(
              K, K, K, [=](int i, int j) { return i < n && j <= i; }, i0,
              k1 + kTileCols * t, k0, n, lay);
        t -= cols;
      }
    }
    __syncthreads();
  }
}

// The band instances' layout (129 <= n <= 256): the packed triangle
// (CholPacked) and, with kBorder (K5), two rows bordered below it, rows n
// and n + 1 of n columns each (the right-hand sides d^T and a^T), on the
// stride chol_ld(n) after the triangle: K5's shared memory is the
// triangle plus two rows (109,344 B at n = 224, 116,960 at 225 and 232,
// 141,344 at 256; before, the triangle plus 2n floats), which keeps every
// n on its side of chol_band_threads' boundary.  The packed formula's rows
// n and n + 1 would fall inside the triangle's last group at n = 225 ..
// 230 and move those n to two blocks of 256 an SM.
template <bool kBorder>
struct CholBand {
  static constexpr bool kPacked = true;
  int n;
  __host__ __device__ __forceinline__ int row(int i) const {
    if (kBorder && i >= n)
      return chol_packed_floats(n) + (i - n) * chol_ld(n);
    return CholPacked{}.row(i);
  }
};

// Floats of a band instance's factor: the triangle, and the border.
__host__ __device__ __forceinline__ int chol_band_floats(int n,
                                                         bool border) {
  return chol_packed_floats(n) + (border ? 2 * chol_ld(n) : 0);
}

// Which factor a band instance of K4 (border false) or K5 (border true)
// runs, on how many threads, with how much shared memory.  The band factor
// (chol_factor_band, 512 threads, one block an SM) where the batch leaves
// no SM more than one block or two 256-thread blocks of the two-barrier
// factor do not fit an SM (chol_band_threads); else the two-barrier factor
// (chol_factor, 256 threads, two blocks an SM), which measured faster
// there (bench/chol_band_probe.py ab).  K5's two-barrier instance keeps d
// and a after the triangle (2n floats) and substitutes after the factor;
// its band instance borders them (CholBand<true>).
struct CholBandPlan {
  bool band;
  int threads;
  size_t smem;
};

__host__ __device__ constexpr int chol_plan_threads(bool band) {
  return band ? 512 : 256;
}

inline CholBandPlan chol_band_plan(int n, int batch, bool border,
                                   int device) {
  const size_t two_barrier =
      (static_cast<size_t>(chol_packed_floats(n)) + (border ? 2ull * n : 0)) *
      sizeof(float);
  if (batch > chol_sm_count(device) &&
      chol_band_threads(two_barrier) == chol_plan_threads(false))
    return {false, chol_plan_threads(false), two_barrier};
  return {true, chol_plan_threads(true),
          static_cast<size_t>(chol_band_floats(n, border)) * sizeof(float)};
}

// The band factor's hand-offs, named barriers (barrier 0 is
// __syncthreads): the panel warp arrives on kPanelReady when a panel's
// diagonal block and the first rows of its strip are final, the tile warps
// on kColumnTaken when the next panel's column has taken it (each side
// waits on the other's, every thread of the block counted), and the tile
// warps alone sync on kStripDone before the rest of a panel.
constexpr int kPanelReady = 1, kColumnTaken = 2, kStripDone = 3;

__device__ __forceinline__ void chol_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void chol_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(blockDim.x) : "memory");
}

// One strip row of the panel [k0, k0 + 8) (band factor), in registers: a[c]
// = the row's element at column k0 + c after every earlier panel.  A row
// of the factor takes L[i][k] = A[i][k] * inv_k, a border row (the
// forward substitution) y_k = A[i][k] / L[k][k]; either, then, is
// eliminated from the row's later columns of the panel.
template <bool kDivide>
__device__ __forceinline__ void chol_strip_row(float (&a)[kCholPanel],
                                               const float (&b)[kCholPanel]
                                                               [kCholPanel],
                                               const float (&inv)[kCholPanel]) {
#pragma unroll
  for (int c = 0; c < kCholPanel; ++c) {
    a[c] = kDivide ? __fdiv_rn(a[c], b[c][c]) : __fmul_rn(a[c], inv[c]);
#pragma unroll
    for (int r = c + 1; r < kCholPanel; ++r)
      a[r] = __fsub_rn(a[r], __fmul_rn(a[c], b[r][c]));
  }
}

// Strip row i (i < n: L's, else a border row's) of the panel at k0, in
// place, from the panel's block b (L) and inv.
template <bool kBorder>
__device__ __forceinline__ void chol_solve_row(float* K, int i, int k0,
                                               int n,
                                               const float (&b)[kCholPanel]
                                                               [kCholPanel],
                                               const float (&inv)[kCholPanel],
                                               CholBand<kBorder> lay) {
  float* d = K + lay.row(i) + k0;
  float a[kCholPanel];
  chol_get4(a, d);
  chol_get4(a + 4, d + 4);
  if (kBorder && i >= n) {
    chol_strip_row<true>(a, b, inv);
  } else {
    chol_strip_row<false>(a, b, inv);
  }
  chol_st4(d, a[0], a[1], a[2], a[3]);
  chol_st4(d + 4, a[4], a[5], a[6], a[7]);
}

// The panel warp's step of the band factor on the panel [k0, k0 + w):
// every lane loads the diagonal block (updated by every earlier panel) as
// rows of two float4s and factors it in registers (chol_block_factor);
// lane r < w stores row k0 + r of its L (L[k][k] on the diagonal, zeros
// past it up to the panel's last column, the row's padding) and lane 0
// inv to pinv; then lanes 0..7 solve the first 8 rows of the strip, rows
// [k0 + w, k0 + w + 8) below nr: the next panel's block rows, the operand
// every tile of the next column reads (after the last block, the border
// rows: the last strip step).
template <bool kBorder>
__device__ __forceinline__ void chol_panel_step(float* K, float* pinv,
                                                int k0, int w, int n, int nr,
                                                CholBand<kBorder> lay) {
  constexpr int NB = kCholPanel;
  const int lane = threadIdx.x & 31;
  float b[NB][NB], inv[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float r8[NB];
    const float* src = K + lay.row(k0 + min(i, w - 1)) + k0;
    chol_get4(r8, src);
    chol_get4(r8 + 4, src + 4);
#pragma unroll
    for (int j = 0; j <= i; ++j) b[i][j] = i < w ? r8[j] : 0.f;
  }
  chol_block_factor<NB>(b, inv);
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (lane == i && i < w) {
      float* dst = K + lay.row(k0 + i) + k0;
      float v[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = j <= i ? b[i][j] : 0.f;
      chol_st4(dst, v[0], v[1], v[2], v[3]);
      chol_st4(dst + 4, v[4], v[5], v[6], v[7]);
    }
  if (lane == 0) {
    chol_st4(pinv, inv[0], inv[1], inv[2], inv[3]);
    chol_st4(pinv + 4, inv[4], inv[5], inv[6], inv[7]);
  }
  const int i = k0 + w + lane;
  if (lane < NB && i < nr) chol_solve_row<kBorder>(K, i, k0, n, b, inv, lay);
}

// The band factor (K4 and K5 at 129 <= n <= 256 where one 512-thread block
// holds an SM, chol_band_plan): the symmetric matrix
// in the packed lower triangle of K factored in place, L[k][k] on the
// diagonal; with kBorder, rows n and n + 1 (right-hand sides) come out as
// L^-1 of what they held, the forward substitution's bits.  The caller has
// passed a barrier since K was written; the function ends with one.
// Warp 0 (the panel warp) factors each panel's diagonal block in registers
// and solves the strip's first 8 rows (chol_panel_step); then the other
// warps (the tile warps) take the panel's column in 32-row pieces, piece q
// on tile warp q mod (tile warps): its rows of the strip (the block and
// inv from shared memory), then the panel applied to its rows of the next
// panel's column [k1, k2), the next diagonal block included (chol_tile);
// arrive on kColumnTaken; and after kStripDone (every strip row solved)
// the rest of the panel, rows [k2, nr) of columns [k2, n), in 64 x 8
// tiles.  Once every tile warp has taken the column, the panel warp
// factors the next panel while the tile warps finish this one; they start
// the next when it is ready (kPanelReady, which also waits for every tile
// warp to finish this one).  So at most two panels are in flight, one
// hand-off a panel each way, and each element still takes the panels in
// increasing order, the columns of a panel in increasing order within it,
// before its own panel's strip or block: the bits of the square
// instances' order (and, for the border rows, of
// forward_substitution_plain).
template <bool kBorder>
__device__ __forceinline__ void chol_factor_band(float* K, int n) {
  constexpr int NB = kCholPanel;
  __shared__ __align__(16) float pinv[2][NB];  // inv of panels p, p + 1
  const CholBand<kBorder> lay{n};
  const int nr = kBorder ? n + 2 : n;  // rows, the border included
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    for (int k0 = 0; k0 < n; k0 += NB) {
      if (k0 > 0) chol_bar_sync(kColumnTaken, blockDim.x);
      chol_panel_step<kBorder>(K, pinv[(k0 / NB) & 1], k0, min(NB, n - k0),
                               n, nr, lay);
      if (k0 + NB < n) chol_bar_arrive(kPanelReady);
    }
  } else {
    const int tw = warp - 1, ntw = (blockDim.x >> 5) - 1;
    const auto keep = [=](int i, int j) {
      return i < nr && j <= min(i, n - 1);
    };
    for (int k0 = 0; k0 + NB < n; k0 += NB) {
      const int k1 = k0 + NB;
      const int k2 = min(k1 + NB, n);
      chol_bar_sync(kPanelReady, blockDim.x);
      // the column's 32-row pieces: rows [k1, nr), at most 8
      const int pieces = (nr - k1 + 31) / 32;
      if (tw < pieces) {
        float b[NB][NB], inv[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          float r8[NB];
          chol_get4(r8, K + lay.row(k0 + i) + k0);
          chol_get4(r8 + 4, K + lay.row(k0 + i) + k0 + 4);
#pragma unroll
          for (int j = 0; j <= i; ++j) b[i][j] = r8[j];
        }
        chol_get4(inv, pinv[(k0 / NB) & 1]);
        chol_get4(inv + 4, pinv[(k0 / NB) & 1] + 4);
        for (int q = tw; q < pieces; q += ntw) {
          const int i = k1 + 32 * q + lane;  // the panel warp solved k1..k2
          if (i >= k1 + NB && i < nr)
            chol_solve_row<kBorder>(K, i, k0, n, b, inv, lay);
        }
        __syncwarp();
        for (int q = tw; q < pieces; q += ntw)
          chol_tile<NB, 1, true>(K, K, K, keep, k1 + 32 * q, k1, k0, nr,
                                 lay);
      }
      chol_bar_arrive(kColumnTaken);
      chol_bar_sync(kStripDone, blockDim.x - 32);
      // the rest: row tiles [i0, i0 + 64) from k2, each with its column
      // tiles j0 = k2, k2 + 8, ... up to min(its last row, n - 1), in the
      // flat order
      int t = tw;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = k2 + kTileRows * r;
        if (i0 >= nr || k2 >= n) break;
        const int cols = (min(i0 + kTileRows, n) - 1 - k2) / kTileCols + 1;
        for (; t < cols; t += ntw)
          chol_tile_rows<NB, true>(K, K, K, keep, i0, k2 + kTileCols * t, k0,
                                   nr, lay);
        t -= cols;
      }
    }
  }
  __syncthreads();
}

// W = L^-1 for the factor in the lower triangle of L (row stride ld), into
// W (row stride ld), zeros above the diagonal; L and W are distinct
// buffers, and the block has more threads than n.  By row panels of
// kCholPanel rows, one barrier a panel: thread j < n owns column j of the
// panel's rows.  Row by row it applies the previous panel's rows (still in
// its registers), then the panel's rows above, then divides by L[k][k] (the
// plain version's order), with no barrier inside.  Meanwhile the warps that
// own no column apply the previous panel's rows to their 64 x 8 tiles of
// the rows below this panel.  So each W[i][j] takes the rows k in
// increasing order, and the chain of divisions runs beside the trailing
// update.  The owners skip the updates with the known zeros above W's
// diagonal, which change no bit of a positive definite member.  The caller
// has passed a barrier since L was written and adds one before W is read by
// other threads.
__device__ __forceinline__ void chol_tri_inverse(const float* __restrict__ L,
                                                 float* __restrict__ W,
                                                 int n, int ld) {
  constexpr int NB = kCholPanel;
  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int owner_warps = (n + 31) / 32;
  const int tile_warps = (blockDim.x >> 5) - owner_warps;
  // thread j fills column j, which it alone reads in the first panel
  if (j < n)
    for (int i = 0; i < n; ++i) W[i * ld + j] = i == j ? 1.f : 0.f;
  float prev[NB];  // the owner's rows of the previous panel, column j
#pragma unroll
  for (int c = 0; c < NB; ++c) prev[c] = 0.f;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int k1 = min(k0 + NB, n);
    const int kp = k0 - NB;  // the previous panel [kp, k0), when k0 > 0
    if (j < k1) {
      // the panel's rows of column j, the previous panel's applied first
      // (independent rows), then the chain of the panel's own rows
      float w[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int k = min(k0 + r, n - 1);  // rows past n: garbage, unstored
        w[r] = W[k * ld + j];
        if (j < k0) {
          float lp[NB];
#pragma unroll
          for (int h = 0; h < NB; h += 4)
            chol_get4(lp + h, L + k * ld + kp + h);
#pragma unroll
          for (int kk = 0; kk < NB; ++kk)
            if (kp + kk >= j)
              w[r] = __fsub_rn(w[r], __fmul_rn(lp[kk], prev[kk]));
        }
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int k = min(k0 + r, n - 1);
        float lc[NB];
#pragma unroll
        for (int h = 0; h < NB; h += 4) chol_get4(lc + h, L + k * ld + k0 + h);
#pragma unroll
        for (int c = 0; c < r; ++c)
          if (k0 + c >= j) w[r] = __fsub_rn(w[r], __fmul_rn(lc[c], w[c]));
        if (k0 + r >= j) w[r] = w[r] / lc[r];
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        if (k0 + r < k1 && k0 + r >= j) W[(k0 + r) * ld + j] = w[r];
        prev[r] = w[r];
      }
    }
    // the previous panel applied to rows [k1, n), columns [0, k0)
    const int m = n - k1;
    if (k0 > 0 && m > 0 && warp >= owner_warps) {
      const int row_tiles = (m - 1) / kTileRows + 1;
      const int col_tiles = k0 / kTileCols;
      for (int t = warp - owner_warps; t < row_tiles * col_tiles;
           t += tile_warps) {
        const int i0 = k1 + kTileRows * (t / col_tiles);
        const int j0 = kTileCols * (t % col_tiles);
        chol_tile_rows<NB, false>(W, L, W, [=](int i, int) { return i < n; },
                                  i0, j0, kp, n, CholSquare{ld});
      }
    }
    if (k1 < n) __syncthreads();
  }
}

// Floats of chol_tri_inverse_in_place's scratch: half of the strip of L's
// panel columns (WStrip), one float4 column of n rounded up to 8 rows, then
// two diagonal blocks of kCholPanel x kCholPanel, then two tile counters
// (4.5 KB at n = 256).
__host__ __device__ __forceinline__ int chol_w_scratch_floats(int n) {
  return 4 * ((n + 7) / 8 * 8) + 2 * kCholPanel * kCholPanel + 4;
}

// Where the in-place W keeps the strip of L's panel columns: half h (the
// panel's columns 4h .. 4h + 3) of row i, half 0 in the scratch and half 1
// in row i's last float4 of K, which no element reaches (row i holds j <= i
// < 8 (i >> 3) + 8 of its stride 8 (i >> 3) + 12).
struct WStrip {
  float4* s;
  float* K;
  __device__ __forceinline__ float4* at(int h, int i, CholPacked lay) const {
    return h ? reinterpret_cast<float4*>(K + lay.row(i) + 8 * (i >> 3) + 8)
             : s + i;
  }
};

// One warp's tile of W's trailing update (chol_tri_inverse_in_place): for
// the rows i = i0 + lane + 32a (a < A, i < n) and the columns j = j0 + c
// (c < 8) of the packed K,
//   W[i][j] -= L[i][k] * W[k][j]   for k = kp, ..., kp + 7 in order,
// with L[i][kp..kp+8) from the strip and W[k][j] from the panel's
// rows in K (zeros above the diagonal; row kp + r starts at yb + r ys, one
// group of 8).  The tile at j0 = kp starts from zero (W's value before any
// update there; K still holds L, which the strip has saved).  Rows past n
// are clamped to n - 1 and not stored.
template <int A>
__device__ __forceinline__ void chol_w_tile(float* K, WStrip strip, int i0,
                                            int j0, int kp, int yb, int ys,
                                            int n, CholPacked lay) {
  const int lane = threadIdx.x & 31;
  int ri[A];
  float acc[A][kTileCols];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    ri[a] = min(i0 + lane + 32 * a, n - 1);
#pragma unroll
    for (int h = 0; h < kTileCols; h += 4) {
      if (j0 == kp) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[a][h + u] = 0.f;
      } else {
        chol_get4(&acc[a][h], K + lay.row(ri[a]) + j0 + h);
      }
    }
  }
#pragma unroll
  for (int kh = 0; kh < kCholPanel; kh += 4) {
    float xv[A][4], yv[kTileCols][4];  // yv[c][q] = W[kp + kh + q][j0 + c]
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float4 t = *strip.at(kh / 4, ri[a], lay);
      xv[a][0] = t.x;
      xv[a][1] = t.y;
      xv[a][2] = t.z;
      xv[a][3] = t.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* yr = K + yb + (kh + q) * ys + j0;
#pragma unroll
      for (int h = 0; h < kTileCols; h += 4) {
        float t[4];
        chol_get4(t, yr + h);
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[h + u][q] = t[u];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c)
          acc[a][c] = __fsub_rn(acc[a][c], __fmul_rn(xv[a][q], yv[c][q]));
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (i0 + lane + 32 * a < n) {
      float* d = K + lay.row(ri[a]) + j0;
#pragma unroll
      for (int h = 0; h < kTileCols; h += 4)
        chol_st4(d + h, acc[a][h], acc[a][h + 1], acc[a][h + 2],
                 acc[a][h + 3]);
    }
  }
}

// W = L^-1 in place over the factor in the packed lower triangle of K: on
// return row i holds W[i][0..i] where it held L[i][0..i] (and zeros past
// the diagonal up to its panel's last column).  The caller keeps L's
// diagonal elsewhere if it needs it, has passed a barrier since L was
// written, and gives `scratch`, chol_w_scratch_floats(n) floats on
// 16 bytes; the function ends with a barrier.  Each W[i][j] takes the plain
// version's sequence,
//   W[i][j] = delta_ij,  W[i][j] -= L[i][k] W[k][j] for k = j, ..., i - 1,
//   W[i][j] /= L[i][i],
// right-looking by row panels of kCholPanel rows, two barriers a panel.
// In the step of panel p = [k0, k1), with panel p - 1 = [kp, k0):
//   1. thread j < k1 finishes column j of the panel's rows: it applies
//      panel p - 1 to them (W's rows kp..k0 in K, L's columns from strip
//      p - 1), then the panel's own rows (L's diagonal block from its copy)
//      and the divisions, and stores the column, zeros above the diagonal.
//   2. it saves the next diagonal block, which later steps overwrite with
//      W;
//   3. every warp applies panel p - 1 to rows [k1, n), columns [0, k0),
//      from 64 x 8 register tiles (chol_w_tile) that store over K: their
//      L operand comes from the strip, so no tile reads an L value another
//      one has replaced.  A warp takes the next tile from a counter in
//      shared memory, so the warps that finished no chain take more;
//   4. after a barrier (no thread reads strip p - 1 any more), strip p,
//      L[k1..n)[k0..k1), which later steps overwrite with W, replaces it.
// One strip keeps the scratch small, so two blocks share an SM up to n =
// 224.  So each
// W[i][j] takes the panels in increasing order (its own row's panel last,
// with the division), and the chain of divisions (8 a panel, one thread a
// column) runs beside the trailing tiles.  An update by a
// zero of W above the diagonal (k < j in j's own panel) comes before any
// nonzero term and leaves +0 unchanged, so it changes no bit of a
// positive definite member.
__device__ __forceinline__ void chol_tri_inverse_in_place(float* K,
                                                          float* scratch,
                                                          int n,
                                                          CholPacked lay) {
  constexpr int NB = kCholPanel;
  const int tid = threadIdx.x;
  const int n8 = (n + 7) / 8 * 8;
  const WStrip strip{reinterpret_cast<float4*>(scratch), K};
  float* blocks = scratch + 4 * n8;                      // [2][NB][NB]
  int* next_tile = reinterpret_cast<int*>(blocks + 2 * NB * NB);  // [2]
  // the diagonal block of rows [k1, k1 + NB) into blocks[slot]
  auto save_block = [&](int k1, int slot) {
    const int r = tid >> 1, h = 4 * (tid & 1);
    if (tid < 2 * NB && k1 + r < n)
      *reinterpret_cast<float4*>(blocks + slot * NB * NB + r * NB + h) =
          *reinterpret_cast<const float4*>(K + lay.row(k1 + r) + k1 + h);
  };
  save_block(0, 0);
  __syncthreads();
  for (int k0 = 0, p = 0; k0 < n; k0 += NB, ++p) {
    const int k1 = min(k0 + NB, n);
    const int kp = k0 - NB;
    const float* lb = blocks + (p & 1) * NB * NB;
    if (tid == 0) next_tile[p & 1] = 0;  // the next step's counter
    // 1. the panel's rows (a panel's rows are one group of 8: row k0 + r
    // starts at rb + r rs, row kp + kk at yb + kk ys)
    const int rb = lay.row(k0), rs = lay.stride(k0);
    for (int j = tid; j < k1; j += blockDim.x) {
      float w[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r)  // rows past n: garbage, unstored
        w[r] = j < kp ? K[rb + min(r, n - 1 - k0) * rs + j]
                      : (k0 + r == j ? 1.f : 0.f);
      if (j < k0) {
        const int yb = lay.row(kp), ys = rs - 8;
        float wk[NB];  // W[kp + kk][j], zero where kp + kk < j
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) wk[kk] = K[yb + kk * ys + j];
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const float4 l0 = *strip.at(0, k0 + r, lay),
                       l1 = *strip.at(1, k0 + r, lay);
          const float l8[NB] = {l0.x, l0.y, l0.z, l0.w,
                                l1.x, l1.y, l1.z, l1.w};
#pragma unroll
          for (int kk = 0; kk < NB; ++kk)
            w[r] = __fsub_rn(w[r], __fmul_rn(l8[kk], wk[kk]));
        }
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float lc[NB];
        chol_get4(lc, lb + r * NB);
        chol_get4(lc + 4, lb + r * NB + 4);
#pragma unroll
        for (int c = 0; c < r; ++c)
          w[r] = __fsub_rn(w[r], __fmul_rn(lc[c], w[c]));
        w[r] = w[r] / lc[r];
      }
#pragma unroll
      for (int r = 0; r < NB; ++r)
        if (k0 + r < n) K[rb + r * rs + j] = w[r];
    }
    if (k1 < n) {
      // 2. the next diagonal block
      save_block(k1, (p + 1) & 1);
      // 3. panel p - 1 applied to rows [k1, n), columns [0, k0), a tile
      // at a time from this step's counter
      if (k0 > 0) {
        const int cols = k0 / kTileCols;
        const int tiles = (n - k1 + kTileRows - 1) / kTileRows * cols;
        const int yb = lay.row(kp), ys = lay.stride(kp);
        int* counter = next_tile + ((p + 1) & 1);
        int t = 0;
        if ((tid & 31) == 0) t = atomicAdd(counter, 1);
        t = __shfl_sync(0xffffffffu, t, 0);
        while (t < tiles) {
          int next = 0;  // the warp's next tile, fetched beside this one
          if ((tid & 31) == 0) next = atomicAdd(counter, 1);
          const int i0 = k1 + kTileRows * (t / cols);
          const int j0 = kTileCols * (t % cols);
          if (i0 + 32 < n)
            chol_w_tile<2>(K, strip, i0, j0, kp, yb, ys, n, lay);
          else
            chol_w_tile<1>(K, strip, i0, j0, kp, yb, ys, n, lay);
          t = __shfl_sync(0xffffffffu, next, 0);
        }
      }
    }
    __syncthreads();
    if (k1 < n) {
      // 4. strip p
      for (int i = k1 + tid; i < n; i += blockDim.x) {
        const float* src = K + lay.row(i) + k0;
        *strip.at(0, i, lay) = *reinterpret_cast<const float4*>(src);
        *strip.at(1, i, lay) = *reinterpret_cast<const float4*>(src + 4);
      }
      __syncthreads();
    }
  }
}

}  // namespace
