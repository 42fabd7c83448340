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
//     rows i >= k0+j; the two rows are swapped in the panel, the
//     multipliers stored in place (W[i][k0+j] /= pivot) and the rest of the
//     panel takes the rank-1 update, all in fp32;
//   * the panel's swaps are then applied, in order, to the columns left and
//     right of the panel in global memory, so the work matrix holds PA
//     (rows physically permuted, as LAPACK leaves it), and to ``perm`` (row
//     i of PA is row perm[i] of A); ipiv gets the 0-based pivot rows;
//   * ldi = L11^-1 (unit lower) by forward substitution and udi = U11^-1 by
//     back substitution of the pw x pw diagonal block.
// Each elementwise update is spelled __fmul_rn / __fsub_rn (no FMA
// contraction) and each quotient is IEEE division, so the kernel repeats the
// plain PyTorch version lu_panel_plain operation for operation.  A zero
// pivot is never clamped: that member alone goes non-finite.
//
// What bounds it on the card: not bytes and not operations.  The launches of
// one call read and write each panel once (Σ (n-k0) pw fp32 a matrix) plus
// the rows their swaps move, and do ~(n-k0) pw^2 flops a panel; the limit is
// the serial chain of n pivot steps, each a block-wide reduction and a
// rank-1 update separated by three block barriers, then 2 pw substitution
// steps a launch, with one block (8 warps) per SM at these panel sizes.
// What the design does about it: the panel stays in shared memory for its
// whole chain (m x (pw+1) fp32, odd stride so column reads hit distinct
// banks), the pivot is found with warp shuffles and one pass over the eight
// warp results that every thread does itself (no second barrier), each row
// of the update belongs to one thread (its multiplier needs no barrier, its
// pw - j - 1 updates are independent), and the swaps outside the panel run
// after the chain, one thread per column walking the pw swaps in order,
// coalesced and with no barrier.  None of the TPU kernel's workarounds (rows
// factored in scattered positions, the destination vector, one-hot gathers
// on the MXU, the transposed panel) are needed.  Tensor cores, several
// matrices per block and fewer barriers per column are later work.
//
// Ceiling: the panel of the first launch must fit one block's shared
// memory: (n (pw+1) + 2 pw (pw+1)) fp32 for even pw, plus the pivot rows
// and the reduction slots, at most 232,448 bytes (pw = 32: n <= 1695).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int panel_ld(int pw) {
  return pw % 2 == 0 ? pw + 1 : pw;
}

// Dynamic shared memory of one launch over m = n - k0 panel rows.
size_t panel_smem(int m, int pw) {
  const size_t ld = panel_ld(pw);
  return (static_cast<size_t>(m) * ld + 2 * pw * ld + kWarps) * sizeof(float) +
         (kWarps + pw) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    lu_panel_kernel(float* __restrict__ work, int* __restrict__ perm,
                    int* __restrict__ ipiv, float* __restrict__ ldi,
                    float* __restrict__ udi, int n, int k0, int pw) {
  extern __shared__ float smem[];
  const int ld = panel_ld(pw);
  const int m = n - k0;
  float* P = smem;                // m x ld: rows k0..n-1, the panel's columns
  float* Y = P + m * ld;          // pw x ld: L11^-1
  float* Z = Y + pw * ld;         // pw x ld: U11^-1
  float* s_best = Z + pw * ld;    // kWarps: per-warp maxima
  int* s_bi = reinterpret_cast<int*>(s_best + kWarps);  // kWarps: their rows
  int* s_ipiv = s_bi + kWarps;    // pw: global pivot rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* A = work + static_cast<size_t>(blockIdx.x) * n * n;

  for (int e = tid; e < m * pw; e += kThreads) {
    const int i = e / pw, j = e % pw;
    P[i * ld + j] = A[static_cast<size_t>(k0 + i) * n + k0 + j];
  }
  __syncthreads();

  for (int j = 0; j < pw; ++j) {
    // first maximum of |P[i][j]| over local rows i >= j
    float best = -1.f;
    int bi = m;
    for (int i = j + tid; i < m; i += kThreads) {
      const float v = fabsf(P[i * ld + j]);
      if (v > best) {
        best = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_best[warp] = best;
      s_bi[warp] = bi;
    }
    __syncthreads();
    best = s_best[0];
    bi = s_bi[0];
    for (int w = 1; w < kWarps; ++w) {
      const float ov = s_best[w];
      const int oi = s_bi[w];
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    const int p = bi < m ? bi : j;
    if (p != j) {
      for (int c = tid; c < pw; c += kThreads) {
        const float t = P[j * ld + c];
        P[j * ld + c] = P[p * ld + c];
        P[p * ld + c] = t;
      }
    }
    if (tid == 0) s_ipiv[j] = k0 + p;
    __syncthreads();
    // multipliers and the rank-1 update, one thread per row (the pivot
    // row's reads are broadcasts, the rows' reads hit distinct banks)
    const float piv = P[j * ld + j];
    for (int i = j + 1 + tid; i < m; i += kThreads) {
      float* row = P + i * ld;
      const float l = row[j] / piv;
      for (int c = j + 1; c < pw; ++c)
        row[c] = __fsub_rn(row[c], __fmul_rn(l, P[j * ld + c]));
      row[j] = l;
    }
    __syncthreads();
  }

  for (int e = tid; e < m * pw; e += kThreads) {
    const int i = e / pw, j = e % pw;
    A[static_cast<size_t>(k0 + i) * n + k0 + j] = P[i * ld + j];
  }
  // laswp: the panel's swaps, in order, on every column outside the panel
  for (int c = tid; c < n - pw; c += kThreads) {
    const int col = c < k0 ? c : c + pw;
    for (int s = 0; s < pw; ++s) {
      const int r = k0 + s, p = s_ipiv[s];
      if (p != r) {
        const float t = A[static_cast<size_t>(r) * n + col];
        A[static_cast<size_t>(r) * n + col] = A[static_cast<size_t>(p) * n + col];
        A[static_cast<size_t>(p) * n + col] = t;
      }
    }
  }
  if (tid == 0) {
    int* pm = perm + static_cast<size_t>(blockIdx.x) * n;
    for (int s = 0; s < pw; ++s) {
      const int r = k0 + s, p = s_ipiv[s];
      const int t = pm[r];
      pm[r] = pm[p];
      pm[p] = t;
      ipiv[static_cast<size_t>(blockIdx.x) * pw + s] = p;
    }
  }

  // L11^-1 (forward) and U11^-1 (back) of the diagonal block P[0:pw][0:pw]
  for (int e = tid; e < pw * pw; e += kThreads) {
    const int i = e / pw, c = e % pw;
    Y[i * ld + c] = Z[i * ld + c] = i == c ? 1.f : 0.f;
  }
  __syncthreads();
  for (int k = 0; k < pw; ++k) {
    const int kk = pw - 1 - k;
    const float u = P[kk * ld + kk];
    for (int c = tid; c < pw; c += kThreads) Z[kk * ld + c] = Z[kk * ld + c] / u;
    __syncthreads();
    for (int e = tid; e < (pw - k - 1) * pw; e += kThreads) {
      const int i = k + 1 + e / pw, c = e % pw;
      Y[i * ld + c] =
          __fsub_rn(Y[i * ld + c], __fmul_rn(P[i * ld + k], Y[k * ld + c]));
    }
    for (int e = tid; e < kk * pw; e += kThreads) {
      const int i = e / pw, c = e % pw;
      Z[i * ld + c] =
          __fsub_rn(Z[i * ld + c], __fmul_rn(P[i * ld + kk], Z[kk * ld + c]));
    }
    __syncthreads();
  }
  const size_t tri = static_cast<size_t>(blockIdx.x) * pw * pw;
  for (int e = tid; e < pw * pw; e += kThreads) {
    const int i = e / pw, c = e % pw;
    ldi[tri + e] = Y[i * ld + c];
    udi[tri + e] = Z[i * ld + c];
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
  err = cudaFuncSetAttribute(lu_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lu_panel_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      work, perm, ipiv, ldi, udi, n, k0, pw);
  return static_cast<int>(cudaGetLastError());
}
