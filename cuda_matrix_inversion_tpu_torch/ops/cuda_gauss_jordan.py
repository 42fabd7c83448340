"""Batched Gauss-Jordan inversion with partial pivoting: kernel K7.

Counterpart of ``cuda_matrix_inversion_tpu/ops/pallas_gauss_jordan.py::
inverse_gauss_jordan`` (lane ``gauss_pallas``).  :func:`inverse_gauss_jordan`
runs the hand-written kernel ``csrc/gauss_jordan.cu``
(:func:`gauss_jordan_cuda`) on a CUDA tensor and its plain PyTorch version
:func:`gauss_jordan_plain`, which performs the same operations in the same
order, on a CPU tensor; then it adds the fp32 Newton polish that the JAX
wrapper runs outside its kernel.

The TPU kernel pivots among the unused rows without moving any and applies
the permutation at the end; this one swaps rows in place, which pivots on
the same candidate rows.  Its ``steps``/``chunk`` knobs block the TPU's VMEM
sweep and have no counterpart here.
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, linalg

# K7 keeps one n×n fp32 buffer in shared memory (148 KB at 192): the JAX
# kernel's own ceiling, past which both packages take the library LU route.
GAUSS_JORDAN_MAX_N = 192


def gauss_jordan_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: in-place Gauss-Jordan with magnitude
    partial pivoting on an fp32 ``(batch, n, n)`` batch, no polish.

    Step k: p = the first maximum of |W[i, k]| over i ≥ k; the multipliers
    f = column k after the swap; rows k and p swap; row k with W[k, k] := 1
    is scaled by 1/pivot; every other row i gets
    (j == k ? 0 : W[i, j]) − f[i]·W[k, j].  The column swaps are undone in
    reverse order at the end.  A zero pivot gives inf/NaN in that member
    only."""
    w = a.clone()
    batch, n, _ = w.shape
    rows = torch.arange(batch, device=w.device)
    piv = torch.empty((batch, n), dtype=torch.long, device=w.device)
    for k in range(n):
        p = k + torch.argmax(w[:, k:, k].abs(), dim=1)
        piv[:, k] = p
        f = w[:, :, k].clone()
        f[rows, p] = w[:, k, k]
        pivot_row = w[rows, p].clone()
        r = 1.0 / pivot_row[:, k]
        w[rows, p] = w[:, k].clone()
        pivot_row[:, k] = 1.0
        pivot_row = pivot_row * r[:, None]
        w[:, :, k] = 0.0
        w -= f[:, :, None] * pivot_row[:, None, :]
        w[:, k] = pivot_row
    src = torch.arange(n, device=w.device).repeat(batch, 1)
    for k in range(n - 1, -1, -1):
        pk = piv[:, k]
        s_k, s_p = src[:, k].clone(), src[rows, pk].clone()
        src[:, k] = s_p
        src[rows, pk] = s_k
    return torch.gather(w, 2, src[:, None, :].expand(batch, n, n))


def gauss_jordan_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch K7 (``csrc/gauss_jordan.cu``) on a CUDA fp32 batch, no
    polish.  ``gauss_jordan_cuda.launches`` counts the launches."""
    cuda_build.check_kernel_input(a, "gauss_jordan kernel",
                                  max_n=GAUSS_JORDAN_MAX_N)
    cuda_build.check_cuda_f32("gauss_jordan kernel", a)
    a = a.contiguous()
    inv = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)
    err = cuda_build.library().cmi_gauss_jordan(
        a.data_ptr(), inv.data_ptr(), a.shape[0], a.shape[-1], device, stream)
    cuda_build.check(err, "gauss_jordan kernel")
    gauss_jordan_cuda.launches += 1
    return inv


gauss_jordan_cuda.launches = 0


def inverse_gauss_jordan(a: torch.Tensor, polish: int = 1) -> torch.Tensor:
    """Batched general-matrix inverse with partial pivoting (lane
    ``gauss_pallas``): one K7 launch, then ``polish`` fp32 Newton steps
    X ← X + X(I − AX).

    Any nonsingular batch with 1 ≤ n ≤ 192; a singular member comes out
    non-finite and the others are unaffected.  Gauss-Jordan's forward error
    grows with κ(A) where LU's substitutions are backward stable, so the
    default polish is what holds the 1e-4 gate on κ ≈ 4n draws.  float64 and
    n > 192 take the JAX package's own route past its kernel,
    :func:`linalg.inverse_lu`, which has its fixed polish: any other
    ``polish`` there raises ``ValueError``.
    """
    if a.dtype == torch.float64 or a.shape[-1] > GAUSS_JORDAN_MAX_N:
        if polish != 1:
            route = ("the float64 library route" if a.dtype == torch.float64
                     else f"n > {GAUSS_JORDAN_MAX_N} (library route)")
            raise ValueError(f"polish is a kernel knob and cannot be honored "
                             f"on {route}; call with the default there")
        return linalg.inverse_lu(a)
    cuda_build.check_kernel_input(a, "gauss_jordan kernel",
                                  max_n=GAUSS_JORDAN_MAX_N)
    a32 = a.to(torch.float32)
    x = cuda_build.on_device(a32, "gauss_jordan", gauss_jordan_cuda,
                             gauss_jordan_plain, a32)
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    for _ in range(polish):
        x = x + linalg.matmul(x, eye - linalg.matmul(a32, x))
    return x.to(a.dtype)
