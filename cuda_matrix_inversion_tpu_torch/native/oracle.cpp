// Native CPU oracle: batched LU / Cholesky inversion via LAPACK + OpenMP.
//
// TPU-native equivalent of the reference's C oracle (src/inverse.c):
//   inverse_lu_blas / inverse_lu_blas_omp     (inverse.c:55-86)
//   inverse_chol_blas / inverse_chol_blas_omp (inverse.c:89-107)
// Same structure: per-matrix LAPACK calls fanned out with an OpenMP
// dynamic-schedule parallel-for and per-thread workspace.
//
// Layout note: buffers arrive row-major (C order). LAPACK is
// column-major, so it sees Aᵀ; since inv(Aᵀ) = inv(A)ᵀ, the LU path
// needs no transposes at all. The Cholesky path works on symmetric
// input (Aᵀ = A) with uplo='L' and mirrors the triangle afterwards.
//
// Exposed as a C ABI consumed via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {
// LAPACK Fortran symbols (liblapack.so.3)
void sgetrf_(const int *m, const int *n, float *a, const int *lda, int *ipiv, int *info);
void sgetri_(const int *n, float *a, const int *lda, const int *ipiv, float *work,
             const int *lwork, int *info);
void spotrf_(const char *uplo, const int *n, float *a, const int *lda, int *info);
void spotri_(const char *uplo, const int *n, float *a, const int *lda, int *info);
void dgetrf_(const int *m, const int *n, double *a, const int *lda, int *ipiv, int *info);
void dgetri_(const int *n, double *a, const int *lda, const int *ipiv, double *work,
             const int *lwork, int *info);
void dpotrf_(const char *uplo, const int *n, double *a, const int *lda, int *info);
void dpotri_(const char *uplo, const int *n, double *a, const int *lda, int *info);
void spotrs_(const char *uplo, const int *n, const int *nrhs, const float *a,
             const int *lda, float *b, const int *ldb, int *info);
void dpotrs_(const char *uplo, const int *n, const int *nrhs, const double *a,
             const int *lda, double *b, const int *ldb, int *info);
}

namespace {

template <typename T>
struct Lapack;

template <>
struct Lapack<float> {
  static void getrf(const int *m, const int *n, float *a, const int *lda, int *ipiv,
                    int *info) { sgetrf_(m, n, a, lda, ipiv, info); }
  static void getri(const int *n, float *a, const int *lda, const int *ipiv,
                    float *work, const int *lwork, int *info) {
    sgetri_(n, a, lda, ipiv, work, lwork, info);
  }
  static void potrf(const char *u, const int *n, float *a, const int *lda, int *info) {
    spotrf_(u, n, a, lda, info);
  }
  static void potri(const char *u, const int *n, float *a, const int *lda, int *info) {
    spotri_(u, n, a, lda, info);
  }
  static void potrs(const char *u, const int *n, const int *nrhs, const float *a,
                    const int *lda, float *b, const int *ldb, int *info) {
    spotrs_(u, n, nrhs, a, lda, b, ldb, info);
  }
};

template <>
struct Lapack<double> {
  static void getrf(const int *m, const int *n, double *a, const int *lda, int *ipiv,
                    int *info) { dgetrf_(m, n, a, lda, ipiv, info); }
  static void getri(const int *n, double *a, const int *lda, const int *ipiv,
                    double *work, const int *lwork, int *info) {
    dgetri_(n, a, lda, ipiv, work, lwork, info);
  }
  static void potrf(const char *u, const int *n, double *a, const int *lda, int *info) {
    dpotrf_(u, n, a, lda, info);
  }
  static void potri(const char *u, const int *n, double *a, const int *lda, int *info) {
    dpotri_(u, n, a, lda, info);
  }
  static void potrs(const char *u, const int *n, const int *nrhs, const double *a,
                    const int *lda, double *b, const int *ldb, int *info) {
    dpotrs_(u, n, nrhs, a, lda, b, ldb, info);
  }
};

// Batched in-place LU inversion (ref inverse_lu_blas_omp, inverse.c:71-86).
template <typename T>
int64_t inverse_lu(T *a, int64_t batch, int64_t n) {
  const int ni = static_cast<int>(n);
  const int lwork = ni * 64;
  int64_t first_bad = 0;  // 1-based batch index of first failure; 0 = ok
#pragma omp parallel
  {
    std::vector<int> ipiv(ni);
    std::vector<T> work(lwork);
#pragma omp for schedule(dynamic, 8)
    for (int64_t k = 0; k < batch; ++k) {
      T *m = a + k * n * n;
      int info = 0;
      Lapack<T>::getrf(&ni, &ni, m, &ni, ipiv.data(), &info);
      if (info == 0) {
        Lapack<T>::getri(&ni, m, &ni, ipiv.data(), work.data(), &lwork, &info);
      }
      if (info != 0) {
#pragma omp critical
        if (first_bad == 0 || k + 1 < first_bad) first_bad = k + 1;
      }
    }
  }
  return first_bad;
}

// Batched in-place SPD inversion (ref inverse_chol_blas_omp, inverse.c:100-107),
// plus the triangle mirror the reference omits (SURVEY §2.4: it leaves the
// other triangle stale).
template <typename T>
int64_t inverse_chol(T *a, int64_t batch, int64_t n) {
  const int ni = static_cast<int>(n);
  const char lo = 'L';
  int64_t first_bad = 0;
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t k = 0; k < batch; ++k) {
    T *m = a + k * n * n;
    int info = 0;
    Lapack<T>::potrf(&lo, &ni, m, &ni, &info);
    if (info == 0) Lapack<T>::potri(&lo, &ni, m, &ni, &info);
    if (info != 0) {
#pragma omp critical
      if (first_bad == 0 || k + 1 < first_bad) first_bad = k + 1;
      continue;
    }
    // potri filled col-major-'L' = row-major upper; mirror it down.
    for (int64_t i = 1; i < n; ++i)
      for (int64_t j = 0; j < i; ++j) m[i * n + j] = m[j * n + i];
  }
  return first_bad;
}

// Batched GP mean/variance pipeline (ref calcluateMean[Solve]CPU /
// calcluateVariance[Solve]CPU, src/gauss_cpu.c:23-277), with the variance
// sign fixed to the documented formula var = e − aᵀK⁻¹a (the reference's
// CPU path adds the quadratic term — SURVEY §2.4.1).  K = B + diag(c) is
// symmetric, so its row-major block equals its column-major transpose and
// LAPACK needs no layout shims.  use_solve=1 is the -DGAUSS_SOLVE potrs
// variant; 0 inverts explicitly with potri (reference parity for both).
// want: 0 = both outputs in one factorization with a 2-column RHS;
//       1 = mean only (nrhs=1, rhs=d) — the calcluateMeanCPU workload;
//       2 = variance only (nrhs=1, rhs=a) — calcluateVarianceCPU.
// The single-output modes exist so the bench CLI's means_cpu /
// variances_cpu rows time the SAME per-row work as the reference's two
// distinct pipelines (factorize + ONE solve each), not a duplicated dual
// pipeline.
template <typename T>
int64_t gp_pipeline(const T *a, const T *b, const T *c, const T *d, const T *e,
                    T *mean_out, T *var_out, int64_t batch, int64_t n,
                    int use_solve, int want) {
  const int ni = static_cast<int>(n);
  const char lo = 'L';
  const int nrhs = (want == 0) ? 2 : 1;
  int64_t first_bad = 0;
#pragma omp parallel
  {
    std::vector<T> k(n * n);
    std::vector<T> rhs(2 * n);  // col-major (n, nrhs): [d | a], [d], or [a]
#pragma omp for schedule(dynamic, 8)
    for (int64_t kk = 0; kk < batch; ++kk) {
      const T *av = a + kk * n, *dv = d + kk * n, *cv = c + kk * n;
      std::memcpy(k.data(), b + kk * n * n, sizeof(T) * n * n);
      for (int64_t i = 0; i < n; ++i) k[i * n + i] += cv[i];
      int info = 0;
      Lapack<T>::potrf(&lo, &ni, k.data(), &ni, &info);
      if (info == 0) {
        if (want != 2) std::memcpy(rhs.data(), dv, sizeof(T) * n);
        if (want == 0) std::memcpy(rhs.data() + n, av, sizeof(T) * n);
        if (want == 2) std::memcpy(rhs.data(), av, sizeof(T) * n);
        if (use_solve) {
          Lapack<T>::potrs(&lo, &ni, &nrhs, k.data(), &ni, rhs.data(), &ni, &info);
        } else {
          Lapack<T>::potri(&lo, &ni, k.data(), &ni, &info);
          if (info == 0) {
            // y = K⁻¹ rhs; potri's col-major-'L' is the upper triangle of
            // the row-major view — read k[min]*n+[max] for the full matrix
            std::vector<T> y(2 * n, T(0));
            for (int64_t i = 0; i < n; ++i) {
              for (int col = 0; col < nrhs; ++col) {
                T acc = 0;
                for (int64_t j = 0; j < n; ++j) {
                  const T kij = (j >= i) ? k[i * n + j] : k[j * n + i];
                  acc += kij * rhs[col * n + j];
                }
                y[col * n + i] = acc;
              }
            }
            std::memcpy(rhs.data(), y.data(), sizeof(T) * nrhs * n);
          }
        }
      }
      if (info != 0) {
#pragma omp critical
        if (first_bad == 0 || kk + 1 < first_bad) first_bad = kk + 1;
        continue;
      }
      T dot0 = 0, dot1 = 0;
      for (int64_t i = 0; i < n; ++i) {
        dot0 += av[i] * rhs[i];
        if (want == 0) dot1 += av[i] * rhs[n + i];
      }
      // documented sign var = e − aᵀK⁻¹a, not the ref's CPU bug
      if (want == 0) {
        mean_out[kk] = dot0;
        var_out[kk] = e[kk] - dot1;
      } else if (want == 1) {
        mean_out[kk] = dot0;
      } else {
        var_out[kk] = e[kk] - dot0;
      }
    }
  }
  return first_bad;
}

}  // namespace

extern "C" {

int64_t oracle_inverse_lu_f32(float *a, int64_t batch, int64_t n) {
  return inverse_lu<float>(a, batch, n);
}
int64_t oracle_inverse_lu_f64(double *a, int64_t batch, int64_t n) {
  return inverse_lu<double>(a, batch, n);
}
int64_t oracle_inverse_chol_f32(float *a, int64_t batch, int64_t n) {
  return inverse_chol<float>(a, batch, n);
}
int64_t oracle_inverse_chol_f64(double *a, int64_t batch, int64_t n) {
  return inverse_chol<double>(a, batch, n);
}

int64_t oracle_gp_f32(const float *a, const float *b, const float *c,
                      const float *d, const float *e, float *mean_out,
                      float *var_out, int64_t batch, int64_t n, int use_solve,
                      int want) {
  return gp_pipeline<float>(a, b, c, d, e, mean_out, var_out, batch, n,
                            use_solve, want);
}
int64_t oracle_gp_f64(const double *a, const double *b, const double *c,
                      const double *d, const double *e, double *mean_out,
                      double *var_out, int64_t batch, int64_t n, int use_solve,
                      int want) {
  return gp_pipeline<double>(a, b, c, d, e, mean_out, var_out, batch, n,
                             use_solve, want);
}

int oracle_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
