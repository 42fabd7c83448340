"""Autodiff support for the inversion lanes.

Counterpart of ``cuda_matrix_inversion_tpu/ops/autodiff.py``.  The
hand-written kernels have no backward of their own, and the adaptive
Newton-Schulz loop is not meant to be differentiated through.  The
analytic rule closes both gaps exactly:

    X = A⁻¹  ⇒  dX = −X · dA · X      (so  Ā = −Xᵀ · X̄ · Xᵀ)

so the backward is two batched products against the forward's OUTPUT —
no re-factorization — and it is the derivative of the exact inverse,
whichever lane produced X.  The products are full fp32
(:func:`.linalg.matmul` refuses TF32).
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda_matrix_inversion_tpu_torch.ops import linalg


class _Inverse(torch.autograd.Function):
    """``fn(a)`` forward, saving X; −Xᵀ Ḡ Xᵀ backward."""

    @staticmethod
    def forward(ctx, a, fn):
        x = fn(a)
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xt = x.mT
        return -linalg.matmul(linalg.matmul(xt, g), xt), None


def with_inverse_vjp(fn: Callable, name: str | None = None) -> Callable:
    """Wrap a batched-inverse function with the analytic inverse
    backward."""

    def inv(a: torch.Tensor) -> torch.Tensor:
        return _Inverse.apply(a, fn)

    if name:
        inv.__name__ = name
    inv.__doc__ = (fn.__doc__ or "") + "\n\n    Differentiable: dX = -X dA X."
    return inv


def differentiable(algorithm: str) -> Callable:
    """An autograd-compatible batched inverse for any registry lane
    (``"lu_pallas"``: K2 forward on a CUDA tensor)."""
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )

    return with_inverse_vjp(get_inverse_algorithm(algorithm),
                            name=f"inverse_{algorithm}_diff")
