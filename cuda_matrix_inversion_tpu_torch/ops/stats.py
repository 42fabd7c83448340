"""Batch statistics helpers: column mean, centering, covariance.

Counterpart of ``cuda_matrix_inversion_tpu/ops/stats.py`` and of the
reference's ``mean`` / ``sub_each`` / ``covariance`` (``src/inverse.c:26-48``,
CBLAS ``ssyrk``-based; never called by any of its harnesses), in plain
PyTorch on any device.
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops import linalg


def column_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of each column: (m, n) → (n,) (ref ``mean``, ``inverse.c:26-31``)."""
    return torch.mean(x, dim=-2)


def subtract_column_mean(x: torch.Tensor) -> torch.Tensor:
    """Center columns (ref ``sub_each``, ``inverse.c:33-38``)."""
    return x - column_mean(x)[..., None, :]


def covariance(x: torch.Tensor, ddof: int = 0) -> torch.Tensor:
    """Column covariance (m, n) → (n, n) as XᶜᵀXᶜ at full fp32
    (ref ``covariance`` over ``cblas_ssyrk``, ``inverse.c:40-48``).
    Batched inputs (..., m, n) are supported."""
    xc = subtract_column_mean(x)
    m = x.shape[-2]
    gram = linalg.matmul(xc.mT, xc)
    return gram / max(m - ddof, 1)
