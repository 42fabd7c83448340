"""fp64-class batched inversion: an fp32 seed refined in native fp64.

Counterpart of ``cuda_matrix_inversion_tpu/ops/double_single.py`` (lane
``lu_hiacc``); the name is kept so that a reader finds it.  The JAX module
builds its residuals from exact bf16 digit products and double-single
(two-fp32) sums because the TPU has no usable fp64; the card has one, so
here the residual R = I − AX and the update X ← X + X·R are plain float64
products (cuBLAS DGEMM on the card, LAPACK's BLAS on the CPU).  The
refinement contracts quadratically (R_{k+1} = R_k²) while κ·ε₃₂ ≲ 1 and
stops at the fp64 floor ~κ·2⁻⁵³, below the JAX tier's ~κ·2⁻⁴⁸.

The adaptive stop is taken for each matrix separately: a member stops once
its residual fails to improve 4× or is not finite, and the others go on.
The JAX module stops the whole batch on one rule, so there one singular
member freezes every other after a single round (ROADMAP Queue 3, W4).
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops.linalg import matmul


def refine_f64(a: torch.Tensor, x0: torch.Tensor, iters: int | None = None,
               max_iters: int = 8) -> torch.Tensor:
    """Refine a batched inverse ``x0`` of ``a`` in float64: X ← X + X(I − AX)
    with the residual and the update in fp64.  Returns float64.

    A float64 ``a`` is used as given; a float32 one is promoted (exactly,
    as the JAX package's double-single pair of a float32 A has a zero low
    part).  ``iters`` fixes the number of rounds; ``None`` is adaptive: each
    member runs rounds while its residual (max |I − AX|) improves at least
    4× on the previous round's, up to ``max_iters``, and stops on a
    non-finite residual."""
    a64 = a.to(torch.float64)
    x = x0.to(torch.float64)
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    if iters is not None:
        for _ in range(iters):
            x = x + matmul(x, eye - matmul(a64, x))
        return x
    batch = a.shape[0]
    # sentinels let the first two rounds run, as the JAX loop's do
    res = torch.full((batch,), 1e30, dtype=torch.float64, device=a.device)
    prev = torch.full_like(res, 1e38)
    active = torch.ones(batch, dtype=torch.bool, device=a.device)
    for _ in range(max_iters):
        active = active & (res < 0.25 * prev)
        if not bool(active.any()):
            break
        r = eye - matmul(a64, x)
        prev = res
        res = torch.where(active, r.abs().amax(dim=(-2, -1)), res)
        x = torch.where(active[:, None, None], x + matmul(x, r), x)
    return x


def inverse_hiacc(a: torch.Tensor, algorithm: str = "lu_pallas",
                  iters: int | None = None, **kw) -> torch.Tensor:
    """fp64-class batched inverse (lane ``lu_hiacc``): the registry lane
    ``algorithm`` inverts the fp32 copy of ``a`` with the keywords ``kw``
    (say ``lo_iters`` for a Newton-Schulz seed, ``pw`` for
    ``lu_bign_pallas``, ``polish`` for ``gauss_pallas``), as the JAX
    package's ``inverse_hiacc`` forwards them, then :func:`refine_f64`
    refines against ``a`` itself.  Returns ``a``'s dtype: float64 input
    keeps the ~1e-12 accuracy, float32 input rounds it to fp32."""
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )

    x0 = get_inverse_algorithm(algorithm)(a.to(torch.float32), **kw)
    return refine_f64(a, x0, iters=iters).to(a.dtype)
