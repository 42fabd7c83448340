"""SPD inversion past the kernels' ceiling by Schur-complement recursion.

Counterpart of ``cuda_matrix_inversion_tpu/ops/schur.py``, plain PyTorch.
The matrix is split into a 2×2 block form and inverted through the Schur
complement:

    A = [[A11, A12], [A12ᵀ, A22]],   S = A22 − A12ᵀ A11⁻¹ A12
    A⁻¹ = [[X11 + Y S⁻¹ Yᵀ,  −Y S⁻¹],
           [−S⁻¹ Yᵀ,          S⁻¹ ]],   X11 = A11⁻¹,  Y = X11 A12

The half-size inversions recurse until they fit the base (a batched SPD
inversion serving n ≤ ``max_base_n``); the stitching is four batched fp32
products.  For SPD A both A11 and S have κ ≤ κ(A), so the base's κ domain
carries through.  SPD only, caller-asserted.  ``_pad_even`` and
``_split_point`` are the JAX package's, so results compare split for
split.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from cuda_matrix_inversion_tpu_torch.ops.linalg import matmul


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _pad_even(a: torch.Tensor, multiple: int = 16):
    """Pad n to a multiple of 16 with an identity block:
    ``blockdiag(A, I)⁻¹ = blockdiag(A⁻¹, I)``, an exact un-slice."""
    n = a.shape[-1]
    target = -(-n // multiple) * multiple
    if target == n:
        return a, n
    out = torch.zeros((a.shape[0], target, target), dtype=a.dtype,
                      device=a.device)
    out[:, :n, :n] = a
    out[:, n:, n:] = torch.eye(target - n, dtype=a.dtype, device=a.device)
    return out, n


def _split_point(n: int) -> int:
    """Split near n/2: a multiple of 128 from n = 256 on, else half of the
    16-padded n (a multiple of 8)."""
    if n >= 256:
        m = max(128, round(n / 2 / 128) * 128)
    else:
        m = -(-n // 16) * 8
    return min(m, n - 8)


def _halves(a: torch.Tensor, base: Callable, max_base_n: int):
    """(padded A, n_orig, m, X11, Y, S⁻¹) of one recursion level."""
    a, n_orig = _pad_even(a)
    m = _split_point(a.shape[-1])
    a12 = a[:, :m, m:]
    x11 = spd_blocked_inverse(a[:, :m, :m], base, max_base_n)
    y = matmul(x11, a12)                            # X11 A12
    s = a[:, m:, m:] - matmul(_t(a12), y)           # Schur complement
    si = spd_blocked_inverse(s, base, max_base_n)
    return a, n_orig, m, x11, y, si


def spd_blocked_inverse(a: torch.Tensor, base: Callable,
                        max_base_n: int = 256) -> torch.Tensor:
    """Invert a batch of SPD matrices of any n: Schur recursion down to
    ``base``, depth ⌈log2(n/max_base_n)⌉."""
    if a.shape[-1] <= max_base_n:
        return base(a)
    a, n_orig, m, x11, y, si = _halves(a, base, max_base_n)
    b12 = -matmul(y, si)                            # −Y S⁻¹
    b11 = x11 - matmul(b12, _t(y))                  # X11 + Y S⁻¹ Yᵀ
    out = torch.cat([torch.cat([b11, b12], dim=-1),
                     torch.cat([_t(b12), si], dim=-1)], dim=-2)
    return out[:, :n_orig, :n_orig]


def spd_schur_solve(a: torch.Tensor, rhs: torch.Tensor, base: Callable,
                    max_base_n: int = 256) -> torch.Tensor:
    """A⁻¹·rhs for SPD A without forming the whole inverse:

        x_top = X11 r1 + Y S⁻¹ (Yᵀ r1 − r2),   x_bot = −S⁻¹ (Yᵀ r1 − r2)
    """
    n = a.shape[-1]
    if n <= max_base_n:
        return matmul(base(a), rhs)
    a, n_orig, m, x11, y, si = _halves(a, base, max_base_n)
    rhs = F.pad(rhs, (0, 0, 0, a.shape[-1] - n))
    r1, r2 = rhs[:, :m, :], rhs[:, m:, :]
    w = matmul(si, matmul(_t(y), r1) - r2)          # S⁻¹ (Yᵀ r1 − r2)
    x_top = matmul(x11, r1) + matmul(y, w)
    return torch.cat([x_top, -w], dim=-2)[:, :n_orig, :]
