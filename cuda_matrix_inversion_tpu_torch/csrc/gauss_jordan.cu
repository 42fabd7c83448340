// K7: batched Gauss-Jordan inverse with partial pivoting, one thread block
// per matrix, for sm_90a.
//
// Replaces the TPU kernel cuda_matrix_inversion_tpu/ops/pallas_gauss_jordan.py::
// _gauss_jordan_kernel (pallas_call in inverse_gauss_jordan).  The TPU kernel
// keeps [A | I] transposed (2 n^2 fp32) and never moves a row, because Mosaic
// cannot index lanes dynamically: it pivots among the unused rows, records
// the pivot rows and applies the permutation at the end as a one-hot matmul.
// This kernel computes the classical in-place Gauss-Jordan with partial
// pivoting of the plain version (ops/cuda_gauss_jordan.py), step k:
//   p       the first maximum of |W[i][k]| over the positions i >= k
//           (exactly the TPU kernel's unused rows)
//   swap    the rows at positions k and p
//   pivot   row k := (row k with W[k][k] := 1) * r, r = 1 / pivot (IEEE)
//   update  W[i][j] = (j == k ? 0 : W[i][j]) - f[i] * W[k][j] for i != k,
//           f[i] = W[i][k] before the step
// and at the end the column swaps (k, p_k) are undone in reverse order.
// Every element takes the plain version's operations in the plain order
// (__fmul_rn / __fsub_rn, no FMA contraction), so the output equals the
// plain version's bit for bit on every finite member.  A zero pivot gives
// inf / NaN in that matrix alone.  The wrapper adds the JAX wrapper's fp32
// Newton polish (two cuBLAS products) after the kernel.
//
// What bounds it on the card: not bytes (one read and one write of n^2 fp32
// per matrix, 13 MB at 100 x 128 x 128, ~4 us of HBM time).  The n steps run
// in series inside one block and every step updates all n^2 elements (the
// eliminated columns hold the inverse's columns), so the limit is the chain
// of pivot steps and the n^3 unfused multiply-subtract pairs on CUDA cores.
// The design:
//   * the matrix is padded to NP = 16, 32, 64, 128 or 192 (a template
//     parameter) with the identity and run by RG row groups x NP/4 column
//     quads of tile threads.  Each holds the same NP/RG rows x 4 columns in
//     registers for the whole kernel.  Rows never move: a row map takes the
//     place of the swaps (each row's multiplier at step k is its own
//     column-k value, whatever position it holds), and a padding row never
//     pivots, so the padding changes no bit of the n x n result;
//   * the steps go by panels of 4 columns.  NP panel threads (one a row,
//     whole warps) take a panel's steps on its columns with a barrier of
//     their own: each keeps its row's position; a column's best candidate
//     is one 64-bit key (magnitude, then the lower position, then the row:
//     the first maximum by position), and each warp's best stores its key
//     and its row already scaled by its own reciprocal, so after the barrier
//     every row reads the pivot row and takes its step (panel_steps);
//   * at the panel's end the owners stage the 4 pivot rows as they stood at
//     the panel's start, one row group forms them across all columns (row
//     h takes the panel's earlier steps, in order, then its scaling), and
//     every tile thread takes the panel's 4 steps on its tile (float4 reads
//     of the multipliers and the formed rows; a pivot row takes its formed
//     values from its own step on);
//   * at NP = 128 the panel threads are warps of their own and run one
//     panel ahead (gj_look_kernel): while the tile
//     threads take panel g's steps, the panel threads take panel g + 1's.
//     The tile threads keep a mirror of their tiles in shared memory; from
//     it the panel threads form each panel's pivot rows (a column a thread)
//     and bring their own rows' next columns up to date, so the tile
//     threads only take the steps.  Two named barriers hand the panels
//     over, and the tables the two sides share alternate by panel;
//   * the column swaps compose into one permutation: with rows fixed, the
//     row at output position i is the pivot of step i and W's column c goes
//     to output column (the pivot row of step c), so each thread writes its
//     tile once, each warp into one output row.
// Tensor cores do not apply: the updates are fp32 and keep their bits.
//
// Shared memory: two panels' columns and multipliers, the staged and the
// formed pivot rows, two columns' candidate rows and keys, and small
// tables: 13 KB at NP = 128, and 66 KB more for the lookahead's mirror.
// The registers set the occupancy: one block of 640 threads an SM at
// NP = 128; at 192, one of 384 threads, 24 rows a thread.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 192;

// The layout for the padded size NP: RG row groups x NP/4 column quads of
// tile threads; each holds kRows rows (kNQ blocks of kRB consecutive rows,
// RG kRB apart) x 4 columns.
template <int NP, int RG>
struct Shape {
  static constexpr int kThreads = RG * NP / 4;
  static constexpr int kQuads = NP / 4;
  static constexpr int kRows = NP / RG;
  static constexpr int kRB = kRows < 4 ? kRows : 4;
  static constexpr int kNQ = kRows / kRB;
};

// The panel threads for NP (one a row; whole warps) and their warps.
template <int NP>
struct Panel {
  static constexpr int kPT = NP >= 32 ? NP : 32;
  static constexpr int kPW = kPT / 32;
};

// Shared memory: floats, then the 64-bit keys, then ints; the lookahead
// adds a mirror of the tiles.  Tables that the lookahead's panel threads
// write while its tile threads read the last panel's come in two, by the
// panel's parity.
template <int NP>
struct Smem {
  static constexpr int kPW = Panel<NP>::kPW;
  static constexpr int kLd = NP + 4;  // the mirror's row stride
  static constexpr size_t kBytes =
      (24 * NP + 8 * kPW + 8) * sizeof(float) +
      2 * kPW * sizeof(unsigned long long) + (8 + 2 * NP) * sizeof(int);
  static constexpr size_t kLookBytes = kBytes + NP * kLd * sizeof(float);
  float* Pf;    // 2 x NP x 4: a panel's columns by row (its input, its result)
  float* St;    // 4 x NP: the panel's pivot rows as they stood at its start
  float* U;     // 4 x NP: the panel's pivot rows, formed
  float* L;     // 2 x NP x 4: each row's multipliers, by step
  float* cand;  // 2 x kPW x 4: a warp's best row, scaled
  float* r;     // 2 x 4: the panel's reciprocals of the pivots
  unsigned long long* keys;  // 2 x kPW: a column's best key a warp
  int* sp;      // 2 x 4: the panel's pivot rows (-1 past n)
  int* pos;     // NP: each row's final position
  int* row;     // NP: the row at each final position
  float* W;     // NP x kLd: the lookahead's mirror of the tiles
  __device__ explicit Smem(float* base) {
    Pf = base;
    St = Pf + 8 * NP;
    U = St + 4 * NP;
    L = U + 4 * NP;
    cand = L + 8 * NP;
    r = cand + 8 * kPW;
    keys = reinterpret_cast<unsigned long long*>(r + 8);
    sp = reinterpret_cast<int*>(keys + 2 * kPW);
    pos = sp + 8;
    row = pos + NP;
    W = reinterpret_cast<float*>(row + NP);
  }
};

// A step of one column: v - l * u, unfused (one element, or four).
__device__ __forceinline__ float step(float v, float l, float u) {
  return __fsub_rn(v, __fmul_rn(l, u));
}

__device__ __forceinline__ float4 step(float4 v, float l, float4 u) {
  return make_float4(__fsub_rn(v.x, __fmul_rn(l, u.x)),
                     __fsub_rn(v.y, __fmul_rn(l, u.y)),
                     __fsub_rn(v.z, __fmul_rn(l, u.z)),
                     __fsub_rn(v.w, __fmul_rn(l, u.w)));
}

__device__ __forceinline__ float scale(float v, float r) {
  return __fmul_rn(v, r);
}

__device__ __forceinline__ float4 scale(float4 v, float r) {
  return make_float4(__fmul_rn(v.x, r), __fmul_rn(v.y, r), __fmul_rn(v.z, r),
                     __fmul_rn(v.w, r));
}

__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Columns c0 .. c0 + 3 of row s of the n x n matrix A, padded with the
// identity (16-byte loads where `vec`).
__device__ __forceinline__ float4 load_quad(const float* A, int n, bool vec,
                                            int s, int c0) {
  if (vec && s < n && c0 < n) return ld4(A + static_cast<size_t>(s) * n + c0);
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = s < n && c0 + c < n ? A[static_cast<size_t>(s) * n + c0 + c]
                               : (s == c0 + c ? 1.f : 0.f);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A row's 4 steps of a panel at 4 columns, in order: v - l.h * u[h]; the
// pivot row of step `piv` takes u[piv] at its step.
__device__ __forceinline__ float4 row_steps(float4 v, float4 l,
                                            const float4 (&u)[4], int piv) {
#pragma unroll
  for (int h = 0; h < 4; ++h) v = h == piv ? u[h] : step(v, comp(l, h), u[h]);
  return v;
}

// The panel's 4 pivot rows at one column or four, formed: row h (x[h], as
// it stood at the panel's start) takes the panel's earlier steps, in order,
// with its multipliers lp[h], then its scaling by rr's h-th; a step past n
// (h >= nh) gives zeros, and its multipliers are zeros, so that it changes
// no bit.
template <class V>
__device__ __forceinline__ void form_rows(V (&u)[4], const V (&x)[4],
                                          const float4 (&lp)[4], float4 rr,
                                          int nh) {
  const V zero{};
  u[0] = scale(x[0], rr.x);
  u[1] = nh > 1 ? scale(step(x[1], lp[1].x, u[0]), rr.y) : zero;
  u[2] = nh > 2 ? scale(step(step(x[2], lp[2].x, u[0]), lp[2].y, u[1]),
                         rr.z)
                : zero;
  u[3] = nh > 3 ? scale(step(step(step(x[3], lp[3].x, u[0]), lp[3].y,
                                     u[1]),
                               lp[3].z, u[2]),
                         rr.w)
                : zero;
}

// A row's candidate for the pivot search as one 64-bit key, larger is
// better: the magnitude's bits (monotonic for non-negative floats), then
// the lower position, then the row; 0 for a NaN magnitude, which never
// wins (no candidate at all leaves the row at position k the pivot).
__device__ __forceinline__ unsigned long long cand_key(float x, int pos,
                                                       int row) {
  const float v = fabsf(x);
  return v == v ? static_cast<unsigned long long>(__float_as_uint(v)) << 32 |
                      static_cast<unsigned>(0xffff - pos) << 16 |
                      static_cast<unsigned>(row)
                : 0ull;
}

// Named barriers: ID of N threads (N a multiple of 32).  1: the panel
// threads; 2 and 3: the lookahead's hand-overs; 4: its tile threads.
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(N) : "memory");
}

template <int ID, int N>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(ID), "n"(N) : "memory");
}

// The panel threads take a panel's nh steps on its 4 columns (k0 ..): panel
// thread s holds row s's columns (v) and its position (pos), and returns
// its multiplier of each step (f; 0 past nh).  A column: each row's
// candidate key and its row scaled by its own reciprocal; each warp's best
// stores both; after the barrier the best key names the pivot row, which
// takes its candidate (and writes the step's pivot row and reciprocal to sp
// and r), and every other row takes its step.
template <int NP>
__device__ __forceinline__ void panel_steps(float4& v, float (&f)[4], int& pos,
                                            int s, int n, int k0, int nh,
                                            const Smem<NP>& sm, int* sp,
                                            float* r) {
  constexpr int kPT = Panel<NP>::kPT, kPW = Panel<NP>::kPW;
  const bool real = s < n;  // a padding row never pivots
  const int lane = s & 31;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[h] = 0.f;
    if (h >= nh) continue;
    const int k = k0 + h;
    const float x = comp(v, h);
    const float rx = 1.f / x;
    const float4 cand = make_float4(__fmul_rn(h == 0 ? 1.f : v.x, rx),
                                    __fmul_rn(h == 1 ? 1.f : v.y, rx),
                                    __fmul_rn(h == 2 ? 1.f : v.z, rx),
                                    __fmul_rn(h == 3 ? 1.f : v.w, rx));
    const unsigned long long key =
        real && pos >= k ? cand_key(x, pos, s) : 0ull;
    const unsigned hi =
        __reduce_max_sync(0xffffffffu, static_cast<unsigned>(key >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu,
        static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key)
                                               : 0u);
    const unsigned long long wkey =
        static_cast<unsigned long long>(hi) << 32 | lo;
    unsigned long long* keys = sm.keys + (h & 1) * kPW;
    float* cands = sm.cand + (h & 1) * 4 * kPW;
    if (lane == 0) keys[s >> 5] = wkey;
    if (key != 0ull && key == wkey) st4(cands + 4 * (s >> 5), cand);
    bar_sync<1, kPT>();
    unsigned long long best = keys[0];
    int bw = 0;
#pragma unroll
    for (int w2 = 1; w2 < kPW; ++w2) {
      const unsigned long long kw = keys[w2];
      bw = kw > best ? w2 : bw;
      best = kw > best ? kw : best;
    }
    // no candidate (a column of NaN): the row at position k pivots, and the
    // matrix is lost either way
    const bool found = best != 0ull;
    const int p = found ? 0xffff - static_cast<int>(best >> 16 & 0xffff) : k;
    const bool piv = found ? s == static_cast<int>(best & 0xffff) : pos == k;
    const float nan = __uint_as_float(0x7fffffffu);
    const float4 prow =
        found ? ld4(cands + 4 * bw) : make_float4(nan, nan, nan, nan);
    f[h] = x;
    if (piv) {
      v = prow;
      sp[h] = s;
      r[h] = rx;
    } else {
      v = make_float4(__fsub_rn(h == 0 ? 0.f : v.x, __fmul_rn(x, prow.x)),
                      __fsub_rn(h == 1 ? 0.f : v.y, __fmul_rn(x, prow.y)),
                      __fsub_rn(h == 2 ? 0.f : v.z, __fmul_rn(x, prow.z)),
                      __fsub_rn(h == 3 ? 0.f : v.w, __fmul_rn(x, prow.w)));
    }
    pos = piv ? k : pos == k ? p : pos;
  }
  if (s == 0)
    for (int h = nh; h < 4; ++h) sp[h] = -1;
}

// A tile thread's rows x 4 columns, by row group rg and column quad cq.
template <int NP, int RG>
struct Tile {
  using S = Shape<NP, RG>;
  static constexpr int kRB = S::kRB, kNQ = S::kNQ;
  float4 w[kNQ][kRB];
  int rg, cq, c0;

  __device__ explicit Tile(int t) {
    rg = t / S::kQuads;
    cq = t % S::kQuads;
    c0 = 4 * cq;
  }
  // the row of tile entry (q, r)
  __device__ __forceinline__ int row_of(int q, int r) const {
    return kRB * rg + RG * kRB * q + r;
  }
  __device__ __forceinline__ void load(const float* A, int n, bool vec) {
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        w[q][r] = load_quad(A, n, vec, row_of(q, r), c0);
  }
  // my real rows' columns into the mirror W (row stride ld)
  __device__ __forceinline__ void mirror(float* W, int ld, int n) const {
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        if (row_of(q, r) < n) st4(W + row_of(q, r) * ld + c0, w[q][r]);
  }
  // every row's columns into dst (rows by row)
  __device__ __forceinline__ void publish(float* dst) const {
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) st4(dst + 4 * row_of(q, r), w[q][r]);
  }
  __device__ __forceinline__ void reload(const float* src) {
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) w[q][r] = ld4(src + 4 * row_of(q, r));
  }
  // a bit for each of my rows that pivots in the panel: q * kRB + r
  __device__ __forceinline__ unsigned mine(const int (&sp)[4]) const {
    unsigned m = 0u;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (sp[h] >= 0 && sp[h] / kRB % RG == rg)
        m |= 1u << (sp[h] / (RG * kRB) * kRB + sp[h] % kRB);
    return m;
  }
  // the owners put the panel's pivot rows, as they stand, into St
  __device__ __forceinline__ void stage(unsigned m, const int (&sp)[4],
                                        float* St) const {
    if (m == 0u) return;
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        if (!(m >> (q * kRB + r) & 1u)) continue;
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (sp[h] == row_of(q, r)) st4(St + h * NP + c0, w[q][r]);
      }
  }
  // the panel's pivot rows at my columns, formed from St into U
  __device__ __forceinline__ void form(const float* St, const float* L,
                                       const float* rr, const int (&sp)[4],
                                       int nh, float* U) const {
    float4 x[4], lp[4], u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      x[h] = ld4(St + h * NP + c0);
      lp[h] = h > 0 && h < nh ? ld4(L + 4 * sp[h])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    form_rows(u, x, lp, ld4(rr), nh);
#pragma unroll
    for (int h = 0; h < 4; ++h) st4(U + h * NP + c0, u[h]);
  }
  // the panel's 4 steps on my tile, in order, from the formed pivot rows
  // U and the multipliers L (a padding row is read by no one)
  __device__ __forceinline__ void steps(unsigned m, const int (&sp)[4],
                                        const float* U, const float* L,
                                        int n) {
    float4 u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) u[h] = ld4(U + h * NP + c0);
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int row = row_of(q, r);
        if (row >= n) continue;
        const float4 l = ld4(L + 4 * row);
        float4 v = w[q][r];
        if (m >> (q * kRB + r) & 1u) {
          const int piv = sp[0] == row   ? 0
                          : sp[1] == row ? 1
                          : sp[2] == row ? 2
                                         : 3;
          v = row_steps(v, l, u, piv);
        } else {
          v = step(step(step(step(v, l.x, u[0]), l.y, u[1]), l.z, u[2]),
                    l.w, u[3]);
        }
        w[q][r] = v;
      }
  }
  // W's row s goes to output row pos[s], its column c to output column
  // row[c]: each warp writes into one output row
  __device__ __forceinline__ void write(float* X, int n, const int* pos,
                                        const int* row) const {
    const int4 cols = *reinterpret_cast<const int4*>(row + c0);
    const int col[4] = {cols.x, cols.y, cols.z, cols.w};
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int s = row_of(q, r);
        if (s >= n) continue;
        float* Xi = X + static_cast<size_t>(pos[s]) * n;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < n) Xi[col[c]] = comp(w[q][r], c);
      }
  }
};

__device__ __forceinline__ void read_sp(const int* p, int (&sp)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  sp[0] = v.x;
  sp[1] = v.y;
  sp[2] = v.z;
  sp[3] = v.w;
}

// The panels in turn: the first kPT threads take a panel's steps, then every
// thread takes them on its tile.
template <int NP, int RG>
__global__ void __launch_bounds__(Shape<NP, RG>::kThreads, 1)
    gj_kernel(const float* __restrict__ a, float* __restrict__ inv, int n) {
  extern __shared__ __align__(16) float smem[];
  const Smem<NP> sm(smem);
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                    reinterpret_cast<uintptr_t>(inv)) &
                                   15) == 0;
  Tile<NP, RG> t(tid);
  t.load(a + base, n, vec);
  if (t.cq == 0) t.publish(sm.Pf);

  // a panel thread keeps its row's position across the panels
  int pos = tid;
  const int panels = (n + 3) / 4;
  for (int g = 0; g < panels; ++g) {
    const int k0 = 4 * g;
    const int nh = n - k0 < 4 ? n - k0 : 4;  // the panel's steps
    float* Pg = sm.Pf + (g & 1) * 4 * NP;
    __syncthreads();
    if (tid < Panel<NP>::kPT) {
      const int s = tid;
      float4 v = s < NP ? ld4(Pg + 4 * s) : make_float4(0.f, 0.f, 0.f, 0.f);
      float f[4];
      panel_steps<NP>(v, f, pos, s, n, k0, nh, sm, sm.sp, sm.r);
      if (s < NP) {
        st4(Pg + 4 * s, v);
        st4(sm.L + 4 * s, make_float4(f[0], f[1], f[2], f[3]));
      }
    }
    __syncthreads();
    // the panel's end: the owners stage its pivot rows, row group 0 forms
    // them, and every other quad takes the 4 steps (quad g: the panel's
    // result; quad g + 1 publishes the next panel)
    int sp[4];
    read_sp(sm.sp, sp);
    const unsigned m = t.mine(sp);
    if (t.cq != g) t.stage(m, sp, sm.St);
    __syncthreads();
    if (t.rg == 0 && t.cq != g) t.form(sm.St, sm.L, sm.r, sp, nh, sm.U);
    __syncthreads();
    if (t.cq == g) {
      t.reload(Pg);
    } else {
      t.steps(m, sp, sm.U, sm.L, n);
      if (t.cq == g + 1) t.publish(sm.Pf + ((g + 1) & 1) * 4 * NP);
    }
  }

  if (tid < NP) {
    sm.pos[tid] = pos;
    sm.row[pos] = tid;
  }
  __syncthreads();
  t.write(inv + base, n, sm.pos, sm.row);
}

// The panels with a lookahead: kT tile threads and, after them, kPT = NP
// panel threads of their own.  The panel threads take panel g + 1's steps
// while the tile threads take panel g's.  At the end of panel g the panel
// threads form its pivot rows, one column each, from the tile threads'
// mirror of their tiles (as they stood after panel g - 1), hand them over,
// and bring their own rows' next columns up to date with them.  Barrier 2
// hands a panel's result to the tile threads, barrier 3 the mirror to the
// panel threads; each side arrives at one only after syncing at the other,
// so that neither barrier is arrived at twice before it completes.
template <int NP, int RG>
__global__ void __launch_bounds__(Shape<NP, RG>::kThreads + Panel<NP>::kPT, 1)
    gj_look_kernel(const float* __restrict__ a, float* __restrict__ inv,
                   int n) {
  static_assert(Panel<NP>::kPT == NP, "a panel thread for each row");
  constexpr int kT = Shape<NP, RG>::kThreads;
  constexpr int kAll = kT + NP;
  constexpr int kLd = Smem<NP>::kLd;
  extern __shared__ __align__(16) float smem[];
  const Smem<NP> sm(smem);
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                    reinterpret_cast<uintptr_t>(inv)) &
                                   15) == 0;
  const int panels = (n + 3) / 4;
  if (tid >= kT) {
    // a panel thread: row s (its position, the current panel's columns)
    // and column s of the formed pivot rows
    const int s = tid - kT;
    int pos = s;
    float4 v = load_quad(a + base, n, vec, s, 0);
    for (int g = 0; g < panels; ++g) {
      const int k0 = 4 * g;
      const int nh = n - k0 < 4 ? n - k0 : 4;
      const int b = g & 1;
      float f[4];
      panel_steps<NP>(v, f, pos, s, n, k0, nh, sm, sm.sp + 4 * b,
                      sm.r + 4 * b);
      const float4 lf = make_float4(f[0], f[1], f[2], f[3]);
      st4(sm.Pf + b * 4 * NP + 4 * s, v);
      st4(sm.L + b * 4 * NP + 4 * s, lf);
      bar_sync<3, kAll>();
      int sp[4];
      read_sp(sm.sp + 4 * b, sp);
      float x[4], u[4];
      float4 lp[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const bool step_h = h < nh;
        x[h] = step_h ? sm.W[sp[h] * kLd + s] : 0.f;
        lp[h] = step_h ? ld4(sm.L + b * 4 * NP + 4 * sp[h])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      form_rows(u, x, lp, ld4(sm.r + 4 * b), nh);
#pragma unroll
      for (int h = 0; h < 4; ++h) sm.U[h * NP + s] = u[h];
      const bool next = g + 1 < panels;
      // my row's next columns, read before the tile threads may write them
      const float4 nx = next ? ld4(sm.W + s * kLd + k0 + 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      bar_arrive<2, kAll>();
      if (!next) break;
      bar_sync<1, NP>();
      float4 un[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) un[h] = ld4(sm.U + h * NP + k0 + 4);
      const int piv = sp[0] == s   ? 0
                      : sp[1] == s ? 1
                      : sp[2] == s ? 2
                      : sp[3] == s ? 3
                                   : -1;
      v = row_steps(nx, lf, un, piv);
    }
    sm.pos[s] = pos;
    sm.row[pos] = s;
    __syncthreads();
    return;
  }
  Tile<NP, RG> t(tid);
  t.load(a + base, n, vec);
  t.mirror(sm.W, kLd, n);
  bar_arrive<3, kAll>();
  for (int g = 0; g < panels; ++g) {
    const int b = g & 1;
    bar_sync<2, kAll>();
    int sp[4];
    read_sp(sm.sp + 4 * b, sp);
    if (t.cq == g)
      t.reload(sm.Pf + b * 4 * NP);
    else
      t.steps(t.mine(sp), sp, sm.U, sm.L + b * 4 * NP, n);
    if (g + 1 < panels) {
      t.mirror(sm.W, kLd, n);
      bar_arrive<3, kAll>();
    }
  }
  __syncthreads();
  t.write(inv + base, n, sm.pos, sm.row);
}

// The padded size that serves n.
int gj_np(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : n <= 128 ? 128 : 192;
}

// The instance for n: at NP = 128 the lookahead (16 row groups of tile
// threads and 128 panel threads, 640 in all), else 8 row groups (at
// NP = 192, 384 threads).
const void* gj_kernel_for(int n) {
  switch (gj_np(n)) {
    case 16:
      return reinterpret_cast<const void*>(gj_kernel<16, 8>);
    case 32:
      return reinterpret_cast<const void*>(gj_kernel<32, 8>);
    case 64:
      return reinterpret_cast<const void*>(gj_kernel<64, 8>);
    case 128:
      return reinterpret_cast<const void*>(gj_look_kernel<128, 16>);
    default:
      return reinterpret_cast<const void*>(gj_kernel<192, 8>);
  }
}

size_t gj_smem(int n) {
  switch (gj_np(n)) {
    case 16:
      return Smem<16>::kBytes;
    case 32:
      return Smem<32>::kBytes;
    case 64:
      return Smem<64>::kBytes;
    case 128:
      return Smem<128>::kLookBytes;
    default:
      return Smem<192>::kBytes;
  }
}

int gj_threads(int n) {
  const int np = gj_np(n);
  return np == 128 ? 16 * np / 4 + Panel<128>::kPT : 8 * np / 4;
}

}  // namespace

// a, inv: (batch, n, n) fp32, contiguous, on `device`; 1 <= n <= 192.
// Returns the CUDA error of the launch.
extern "C" int cmi_gauss_jordan(const float* a, float* inv, int batch, int n,
                                int device, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const void* fn = gj_kernel_for(n);
  const size_t smem = gj_smem(n);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a, &inv, &n};
  err = cudaLaunchKernel(fn, dim3(batch), dim3(gj_threads(n)), args, smem,
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
