"""Batched LU inversion with partial pivoting: kernel K2.

Counterpart of ``cuda_matrix_inversion_tpu/ops/pallas_lu.py::inverse_lu``
(lane ``lu_pallas``), the analog of cuBLAS ``getrfBatched`` +
``getriBatched``.  :func:`inverse_lu` runs the hand-written kernel
(:func:`lu_inverse_cuda`: ``csrc/lu.cu``, one thread block a matrix, up to
n = 128; ``csrc/lu_band.cu``, one thread-block cluster a matrix, at
129 ≤ n ≤ 256) on a CUDA tensor and its plain PyTorch version
:func:`lu_inverse_plain`, which performs the same operations in the same
order, on a CPU tensor; then it adds the one Newton polish that the JAX
wrapper runs outside its kernel (past n = 128 with an fp64 residual).
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


def band_np(n: int) -> int:
    """The padded size that serves 129 ≤ n ≤ 256 on the cluster
    (``csrc/lu_band.cu::lu_band_np``): 32 columns a CTA."""
    return 160 if n <= 160 else 192 if n <= 192 else 224 if n <= 224 else 256


def lu_inverse_cuda(a: torch.Tensor):
    """Launch K2 on a CUDA fp32 batch, n ≤ :data:`cuda_build.LU_MAX_N`:
    ``(A⁻¹, ipiv)``.  One thread block a matrix up to n = 128
    (``csrc/lu.cu``), one thread-block cluster of NP / 32 CTAs past it
    (``csrc/lu_band.cu``, with a workspace of batch × NP × NP floats for
    the back pass's U).

    ``lu_inverse_cuda.launches`` counts the launches and
    ``lu_inverse_cuda.band_launches`` those of the cluster instance."""
    cuda_build.check_kernel_input(a, "lu kernel", max_n=cuda_build.LU_MAX_N)
    cuda_build.check_cuda_f32("lu kernel", a)
    a = a.contiguous()
    batch, n = a.shape[0], a.shape[-1]
    inv = torch.empty_like(a)
    ipiv = torch.empty((batch, n), dtype=torch.int32, device=a.device)
    device, stream = cuda_build.launch_args(a)
    lib = cuda_build.library()
    band = n > cuda_build.MAX_N
    if band:
        ws = torch.empty((batch, band_np(n) ** 2), dtype=torch.float32,
                         device=a.device)
        err = lib.cmi_lu_inverse_band(a.data_ptr(), inv.data_ptr(),
                                      ipiv.data_ptr(), ws.data_ptr(), batch,
                                      n, device, stream)
    else:
        err = lib.cmi_lu_inverse(a.data_ptr(), inv.data_ptr(),
                                 ipiv.data_ptr(), batch, n, device, stream)
    cuda_build.check(err, "lu kernel")
    lu_inverse_cuda.launches += 1
    if band:
        lu_inverse_cuda.band_launches += 1
    return inv, ipiv


lu_inverse_cuda.launches = 0
lu_inverse_cuda.band_launches = 0


def inverse_lu(a: torch.Tensor) -> torch.Tensor:
    """Batched general-matrix inverse with partial pivoting (lane
    ``lu_pallas``): one K2 launch, then one Newton polish
    X ← X + X(I − AX).

    Any nonsingular batch; a singular member comes out non-finite and the
    others are unaffected.  float64 takes the library route
    (:func:`linalg.inverse_lu`).  Up to n = 128 the polish residual is
    fp32, as the JAX wrapper's; at 129 ≤ n ≤ 256 K2 runs on a thread-block
    cluster, as the JAX kernel serves that band in one launch, and the
    residual is fp64 (:func:`linalg.residual_f64`: an fp32 one leaves the
    κ = 500 class over the gate near n = 256 on the card).  Past 256 the
    blocked route on K9 (:func:`lu_bign.inverse_lu_big`), as the JAX
    package takes its own there.
    """
    if a.dtype == torch.float64:
        return linalg.inverse_lu(a)
    if a.ndim == 3 and a.shape[-1] > cuda_build.LU_MAX_N:
        return lu_bign.inverse_lu_big(a)
    cuda_build.check_kernel_input(a, "lu kernel", max_n=cuda_build.LU_MAX_N)
    a32 = a.to(torch.float32)
    x, _ = cuda_build.on_device(a32, "lu", lu_inverse_cuda, lu_inverse_plain,
                                a32)
    if a.shape[-1] > cuda_build.MAX_N:
        x = x + linalg.matmul(x, linalg.residual_f64(a32, x))
    else:
        eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
        x = x + linalg.matmul(x, eye - linalg.matmul(a32, x))
    return x.to(a.dtype)
