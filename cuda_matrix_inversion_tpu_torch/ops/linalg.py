"""Vendor-library batched ops on ``torch.linalg`` — counterpart of
``cuda_matrix_inversion_tpu/ops/xla.py``.

These are the library baseline the hand-written kernels are timed against
(cuSOLVER/cuBLAS on the GPU, LAPACK on the CPU), the ``lu`` and
``cholesky`` lanes, and the fp64 route of the kernel lanes.  Like XLA's
built-ins they return non-finite values for a singular (or, for Cholesky,
non-positive-definite) member instead of raising: the member's ``info``
from the ``*_ex`` call marks it, and it is filled with NaN.

Every fp32 product here is full fp32: :func:`matmul` refuses to run on a
GPU whose PyTorch has TF32 matmuls switched on, since TF32 keeps ~10
mantissa bits and would break the 1e-4 gate's polish.
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched fp32/fp64 product at full precision (XLA ``HIGHEST``)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: the inversion "
            "routines need full-fp32 products (set it to False)")
    return torch.matmul(a, b)


def residual_f64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The residual I − AX of a batched inverse with its product and
    subtraction in float64 (cuBLAS DGEMM on the card), rounded to fp32.

    A polish X ← X + X·R is only as good as R: with R in fp32 the rounding
    of its n-term sums leaves the κ = 500 class over the 1e-4 gate from
    n ≈ 256 on the card (PERF.md §6), where the TPU's HIGHEST residual held
    it.  The routes past the one-block kernels polish with this one."""
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    r = eye - matmul(a.to(torch.float64), x.to(torch.float64))
    return r.to(torch.float32)


def add_diagonal(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Batched ``B + diag(c)``; ``c`` is ``(batch, n)`` or ``(batch, n, 1)``."""
    if c.ndim == 3:
        c = c[..., 0]
    eye = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
    return b + eye * c[:, None, :]


def _nan_where(info: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    bad = (info != 0).reshape(info.shape + (1,) * (x.ndim - info.ndim))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def inverse_lu(a: torch.Tensor) -> torch.Tensor:
    """Batched general inverse by the library's LU, then (below fp64) one
    Newton residual polish X ← X + X(I − AX), as ``xla.inverse_lu``."""
    x, info = torch.linalg.inv_ex(a)
    x = _nan_where(info, x)
    if a.dtype != torch.float64:
        eye = torch.eye(a.shape[-1], dtype=x.dtype, device=x.device)
        x = x + matmul(x, eye - matmul(a, x))
    return x


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor (NaN where A is not positive definite)."""
    l, info = torch.linalg.cholesky_ex(a)
    return _nan_where(info, l)


def triangular_inverse_lower(l: torch.Tensor) -> torch.Tensor:
    """W = L⁻¹ for a batched lower-triangular L."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device).expand_as(l)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def inverse_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse A⁻¹ = WᵀW with W = L⁻¹."""
    w = triangular_inverse_lower(cholesky(a))
    return matmul(w.mT, w)


def spd_logdet(a: torch.Tensor) -> torch.Tensor:
    """Batched log|A| of SPD matrices, 2·Σ log Lᵢᵢ: ``(batch,)`` (NaN for
    a member that is not positive definite)."""
    diag = torch.diagonal(cholesky(a), dim1=-2, dim2=-1)
    return 2.0 * torch.log(diag).sum(dim=-1)


def lu_logdet(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``(sign, log|A|)`` of general matrices by pivoted LU, as
    ``numpy.linalg.slogdet``."""
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


def lu_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched general solve AX = RHS by LU, without an explicit inverse."""
    x, info = torch.linalg.solve_ex(a, rhs)
    return _nan_where(info, x)


def spd_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve AX = RHS by Cholesky, without an explicit inverse."""
    l = cholesky(a)
    y = torch.linalg.solve_triangular(l, rhs, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def batched_inverse(a: torch.Tensor, algorithm: str = "lu") -> torch.Tensor:
    """Dispatching batched inverse (ref ``batchedInverse``,
    ``src/gauss_bench.cu:63-85``): the registry's ``algorithm`` on ``a``."""
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )

    return get_inverse_algorithm(algorithm)(a)
