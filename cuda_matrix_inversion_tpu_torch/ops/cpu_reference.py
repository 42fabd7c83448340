"""CPU LAPACK oracle — the correctness reference for every device path.

A copy of ``cuda_matrix_inversion_tpu/ops/cpu_reference.py`` (NumPy and
SciPy only): the port keeps its own, since importing the JAX package
imports JAX.  ``tests/test_torch_cpu_reference.py`` pins it to the
original.  Registered as the host lanes ``lu_cpu``, ``cholesky_cpu`` and
``gauss_cpu``.

Reference counterparts:

* ``inverse_lu_blas`` / ``inverse_lu_blas_omp`` (``src/inverse.c:55-86``) —
  ``sgetrf_``+``sgetri_`` per matrix → here scipy's ``getrf``/``getri``.
* ``inverse_chol_blas`` / ``_omp`` (``src/inverse.c:89-107``) —
  ``spotrf_``+``spotri_`` → scipy ``potrf``/``potri`` with symmetrization.
* ``calcluateMean[Solve]CPU`` / ``calcluateVariance[Solve]CPU``
  (``src/gauss_cpu.c:23-277``) — the four GP pipelines.  NOTE: the
  reference CPU variance adds the quadratic term (``gauss_cpu.c:198,266``),
  contradicting its own documented formula ``Var = E − aᵀ(B+C)⁻¹a``
  (``gauss_cpu.h:34``).  We implement the documented formula (SURVEY §2.4.1)
  so results match the MATLAB fixtures.

The reference threads batches with OpenMP ``parallel for``; here batch
parallelism comes from BLAS threading plus the vectorized batch formulation.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import lapack as _lapack


def _lapack_fns(dtype):
    if np.dtype(dtype) == np.float64:
        return (_lapack.dgetrf, _lapack.dgetri, _lapack.dpotrf, _lapack.dpotri,
                _lapack.dpotrs)
    return (_lapack.sgetrf, _lapack.sgetri, _lapack.spotrf, _lapack.spotri,
            _lapack.spotrs)


def inverse_lu(a: np.ndarray) -> np.ndarray:
    """Batched LU inversion via getrf+getri (ref ``inverse_lu_blas``,
    ``src/inverse.c:55-69``)."""
    a = np.asarray(a)
    getrf, getri, *_ = _lapack_fns(a.dtype)
    out = np.empty_like(a)
    for k in range(a.shape[0]):
        lu, piv, info = getrf(a[k])
        if info != 0:
            raise np.linalg.LinAlgError(f"getrf failed on matrix {k}: info={info}")
        inv, info = getri(lu, piv)
        if info != 0:
            raise np.linalg.LinAlgError(f"getri failed on matrix {k}: info={info}")
        out[k] = inv
    return out


def inverse_cholesky(a: np.ndarray) -> np.ndarray:
    """Batched SPD inversion via potrf+potri (ref ``inverse_chol_blas``,
    ``src/inverse.c:89-98``).

    potri fills only the chosen triangle; like the LAPACK docs (and unlike
    the reference, which leaves the other triangle stale in-place), we
    symmetrize the result.
    """
    a = np.asarray(a)
    _, _, potrf, potri, _ = _lapack_fns(a.dtype)
    out = np.empty_like(a)
    for k in range(a.shape[0]):
        c, info = potrf(a[k], lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potrf failed on matrix {k}: info={info}")
        inv, info = potri(c, lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potri failed on matrix {k}: info={info}")
        out[k] = np.tril(inv) + np.tril(inv, -1).T
    return out


def inverse_gauss_jordan(a: np.ndarray) -> np.ndarray:
    """Batched Gauss-Jordan with partial (max-|·|) pivoting — pure NumPy.

    Reference counterpart: the custom kernel family in
    ``src/gauss/batched_invert.cu:17-95``, whose pivoting only fires when
    the diagonal is exactly zero (``batched_invert.cu:19-35``).  Per
    SURVEY §2.4.3 / BASELINE.json we implement proper row pivoting.  This is
    the step-for-step oracle for the Gauss-Jordan kernel.
    """
    a = np.asarray(a)
    batch, n, n2 = a.shape
    assert n == n2, f"square matrices required, got {a.shape}"
    # Augmented [A | I], vectorized over the batch.
    aug = np.concatenate([a.astype(a.dtype, copy=True),
                          np.broadcast_to(np.eye(n, dtype=a.dtype), a.shape).copy()], axis=2)
    for k in range(n):
        col = np.abs(aug[:, :, k])
        col[:, :k] = -1.0  # rows above k are finalized
        piv = np.argmax(col, axis=1)  # (batch,)
        bidx = np.arange(batch)
        # swap rows k and piv (batched)
        tmp = aug[bidx, piv].copy()
        aug[bidx, piv] = aug[:, k]
        aug[:, k] = tmp
        pivot = aug[:, k, k][:, None]
        aug[:, k, :] = aug[:, k, :] / pivot
        factor = aug[:, :, k].copy()
        factor[:, k] = 0.0
        aug -= factor[:, :, None] * aug[:, k, :][:, None, :]
    return np.ascontiguousarray(aug[:, :, n:])


# ---------------------------------------------------------------------------
# GP pipelines (ref src/gauss_cpu.c) — documented formulas, vectorized.
# ---------------------------------------------------------------------------

def _assemble_k(b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """K = B + diag(c) (ref diagonal add, ``gauss_cpu.c:47-49``)."""
    n = b.shape[1]
    return b + np.eye(n, dtype=b.dtype) * c[:, :, 0][:, None, :]


def calculate_mean_cpu(a, b, c, d) -> np.ndarray:
    """``mean = aᵀ (B+diag c)⁻¹ d`` via explicit Cholesky inversion
    (ref ``calcluateMeanCPU``, ``src/gauss_cpu.c:23-77``)."""
    k = _assemble_k(np.asarray(b), np.asarray(c))
    k_inv = inverse_cholesky(k)
    return np.transpose(a, (0, 2, 1)) @ (k_inv @ d)


def calculate_mean_solve_cpu(a, b, c, d) -> np.ndarray:
    """Same mean via potrf+potrs, skipping the explicit inverse
    (ref ``calcluateMeanSolveCPU``, ``src/gauss_cpu.c:87-144``,
    the ``-DGAUSS_SOLVE`` build)."""
    a, b, c, d = map(np.asarray, (a, b, c, d))
    k = _assemble_k(b, c)
    _, _, potrf, _, potrs = _lapack_fns(k.dtype)
    out = np.empty((k.shape[0], 1, 1), dtype=k.dtype)
    for i in range(k.shape[0]):
        cf, info = potrf(k[i], lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potrf failed on matrix {i}: info={info}")
        x, info = potrs(cf, d[i], lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potrs failed on matrix {i}: info={info}")
        out[i, 0, 0] = a[i, :, 0] @ x[:, 0]
    return out


def calculate_variance_cpu(a, b, c, e) -> np.ndarray:
    """``var = e − aᵀ (B+diag c)⁻¹ a`` (documented formula,
    ``gauss_cpu.h:34`` — the reference CPU impl's sign bug at
    ``gauss_cpu.c:198,266`` is deliberately NOT reproduced)."""
    k = _assemble_k(np.asarray(b), np.asarray(c))
    k_inv = inverse_cholesky(k)
    quad = np.transpose(a, (0, 2, 1)) @ (k_inv @ a)
    return np.asarray(e) - quad


def calculate_variance_solve_cpu(a, b, c, e) -> np.ndarray:
    """Variance via potrf+potrs (ref ``calcluateVarianceSolveCPU``,
    ``src/gauss_cpu.c:221-277``), documented sign."""
    a, b, c, e = map(np.asarray, (a, b, c, e))
    k = _assemble_k(b, c)
    _, _, potrf, _, potrs = _lapack_fns(k.dtype)
    out = np.empty((k.shape[0], 1, 1), dtype=k.dtype)
    for i in range(k.shape[0]):
        cf, info = potrf(k[i], lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potrf failed on matrix {i}: info={info}")
        x, info = potrs(cf, a[i], lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"potrs failed on matrix {i}: info={info}")
        out[i, 0, 0] = e[i, 0, 0] - a[i, :, 0] @ x[:, 0]
    return out
