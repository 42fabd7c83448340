"""Batched LU inversion with partial pivoting: kernel K2.

Counterpart of ``cuda_matrix_inversion_tpu/ops/pallas_lu.py::inverse_lu``
(lane ``lu_pallas``), the analog of cuBLAS ``getrfBatched`` +
``getriBatched``.  :func:`inverse_lu` runs the hand-written kernel
``csrc/lu.cu`` (:func:`lu_inverse_cuda`) on a CUDA tensor and its plain
PyTorch version :func:`lu_inverse_plain`, which performs the same
operations in the same order, on a CPU tensor; then it adds the one fp32
Newton polish that the JAX wrapper runs outside its kernel.
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, linalg, lu_bign


def lu_factor_plain(a: torch.Tensor):
    """getrf with magnitude partial pivoting, plain PyTorch.

    Returns ``(lu, ipiv, perm)``: the compact factors (unit L below the
    diagonal, U on and above), LAPACK's 0-based pivot rows (step k swapped
    rows k and ``ipiv[:, k]``), and the row permutation (row i of PA is
    row ``perm[:, i]`` of A).  A zero pivot is not clamped: it yields
    inf/NaN in that member only.
    """
    w = a.clone()
    batch, n, _ = w.shape
    rows = torch.arange(batch, device=w.device)
    perm = torch.arange(n, device=w.device).repeat(batch, 1)
    ipiv = torch.empty((batch, n), dtype=torch.int32, device=w.device)
    for k in range(n):
        p = k + torch.argmax(w[:, k:, k].abs(), dim=1)  # first maximum
        ipiv[:, k] = p.to(torch.int32)
        row_k, row_p = w[rows, k].clone(), w[rows, p].clone()
        w[rows, k], w[rows, p] = row_p, row_k
        perm_k, perm_p = perm[rows, k].clone(), perm[rows, p].clone()
        perm[rows, k], perm[rows, p] = perm_p, perm_k
        w[:, k + 1:, k] = w[:, k + 1:, k] / w[:, k, k:k + 1]
        w[:, k + 1:, k + 1:] -= w[:, k + 1:, k:k + 1] * w[:, k:k + 1, k + 1:]
    return w, ipiv, perm


def lu_inverse_plain(a: torch.Tensor):
    """Plain PyTorch version of K2: ``(A⁻¹, ipiv)`` with A⁻¹ = U⁻¹L⁻¹P by
    forward substitution against P and back substitution against U."""
    w, ipiv, perm = lu_factor_plain(a)
    n = w.shape[-1]
    cols = torch.arange(n, device=w.device)
    y = (perm[:, :, None] == cols).to(w.dtype)  # Y = P
    for k in range(n - 1):
        y[:, k + 1:, :] -= w[:, k + 1:, k:k + 1] * y[:, k:k + 1, :]
    for k in range(n - 1, -1, -1):
        y[:, k, :] = y[:, k, :] / w[:, k, k:k + 1]
        y[:, :k, :] -= w[:, :k, k:k + 1] * y[:, k:k + 1, :]
    return y, ipiv


def lu_inverse_cuda(a: torch.Tensor):
    """Launch K2 (``csrc/lu.cu``) on a CUDA fp32 batch: ``(A⁻¹, ipiv)``.

    ``lu_inverse_cuda.launches`` counts the launches."""
    cuda_build.check_kernel_input(a, "lu kernel")
    cuda_build.check_cuda_f32("lu kernel", a)
    a = a.contiguous()
    inv = torch.empty_like(a)
    ipiv = torch.empty(a.shape[:2], dtype=torch.int32, device=a.device)
    device, stream = cuda_build.launch_args(a)
    err = cuda_build.library().cmi_lu_inverse(
        a.data_ptr(), inv.data_ptr(), ipiv.data_ptr(), a.shape[0],
        a.shape[-1], device, stream)
    cuda_build.check(err, "lu kernel")
    lu_inverse_cuda.launches += 1
    return inv, ipiv


lu_inverse_cuda.launches = 0


def inverse_lu(a: torch.Tensor) -> torch.Tensor:
    """Batched general-matrix inverse with partial pivoting (lane
    ``lu_pallas``): one K2 launch, then one fp32 Newton polish
    X ← X + X(I − AX).

    Any nonsingular batch; a singular member comes out non-finite and the
    others are unaffected.  float64 takes the library route
    (:func:`linalg.inverse_lu`).  n > 128, past K2's shared memory, takes
    the blocked route on K9 (:func:`lu_bign.inverse_lu_big`); the JAX
    package takes its own from n = 257, its one-launch kernel serving
    129..256.
    """
    if a.dtype == torch.float64:
        return linalg.inverse_lu(a)
    if a.ndim == 3 and a.shape[-1] > cuda_build.MAX_N:
        return lu_bign.inverse_lu_big(a)
    cuda_build.check_kernel_input(a, "lu kernel")
    a32 = a.to(torch.float32)
    x, _ = cuda_build.on_device(a32, "lu", lu_inverse_cuda, lu_inverse_plain,
                                a32)
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    x = x + linalg.matmul(x, eye - linalg.matmul(a32, x))
    return x.to(a.dtype)
