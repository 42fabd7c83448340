"""Strassen matrix multiplication.

Counterpart of ``cuda_matrix_inversion_tpu/ops/strassen.py`` and of the
reference prototype ``Multiplication/multi.cu``: a recursive Strassen
product with a size cutoff below which one ordinary product runs, odd
dimensions zero-padded at each level as the reference pads its recursion.
Plain PyTorch on any device; single matrices and leading batch dims.  At
the default cutoff (512) one ``torch.matmul`` is the fast path for every
size this package inverts: Strassen pays off only for very large operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_matrix_inversion_tpu_torch.ops import linalg


def _pad_even(x: torch.Tensor, dim: int) -> torch.Tensor:
    if x.shape[dim] % 2 == 0:
        return x
    # F.pad lists (before, after) pairs from the last dim backwards
    pad = [0, 0] * (-dim)
    pad[-1] = 1
    return F.pad(x, pad)


def _strassen(a: torch.Tensor, b: torch.Tensor, cutoff: int) -> torch.Tensor:
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    if min(m, k, n) <= cutoff:
        return linalg.matmul(a, b)

    a = _pad_even(_pad_even(a, -1), -2)
    b = _pad_even(_pad_even(b, -1), -2)
    m2, k2, n2 = a.shape[-2] // 2, a.shape[-1] // 2, b.shape[-1] // 2

    a11 = a[..., :m2, :k2]
    a12 = a[..., :m2, k2:]
    a21 = a[..., m2:, :k2]
    a22 = a[..., m2:, k2:]
    b11 = b[..., :k2, :n2]
    b12 = b[..., :k2, n2:]
    b21 = b[..., k2:, :n2]
    b22 = b[..., k2:, n2:]

    # the classic seven products (multi.cu strassen_multiply)
    p1 = _strassen(a11 + a22, b11 + b22, cutoff)
    p2 = _strassen(a21 + a22, b11, cutoff)
    p3 = _strassen(a11, b12 - b22, cutoff)
    p4 = _strassen(a22, b21 - b11, cutoff)
    p5 = _strassen(a11 + a12, b22, cutoff)
    p6 = _strassen(a21 - a11, b11 + b12, cutoff)
    p7 = _strassen(a12 - a22, b21 + b22, cutoff)

    c11 = p1 + p4 - p5 + p7
    c12 = p3 + p5
    c21 = p2 + p4
    c22 = p1 - p2 + p3 + p6

    c = torch.cat([torch.cat([c11, c12], dim=-1),
                   torch.cat([c21, c22], dim=-1)], dim=-2)
    return c[..., :m, :n]


def strassen_matmul(a: torch.Tensor, b: torch.Tensor,
                    cutoff: int = 512) -> torch.Tensor:
    """Strassen product C = A @ B (ref ``strassen_multiply``,
    ``Multiplication/multi.cu``).  ``cutoff``: recursion stops at or below
    this size and runs one full-fp32 product."""
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return _strassen(a, b, cutoff)
