"""Batched Cholesky: kernels K4 (the factor) and K3 (the SPD inverse).

Counterpart of ``cuda_matrix_inversion_tpu/ops/pallas_cholesky.py``
(``cholesky`` and ``inverse_cholesky``, lane ``cholesky_pallas``).  On a
CUDA tensor :func:`cholesky` runs K4 and :func:`inverse_cholesky` runs K3,
both hand-written in ``csrc/cholesky.cu``; on a CPU tensor they run the
plain PyTorch versions :func:`cholesky_plain` and
:func:`inverse_cholesky_plain`, which perform the kernels' operations in
the same order (WᵀW's summation order aside).  A member that is not
positive definite comes out non-finite; the others are unaffected.  K4
takes n ≤ 256 (:data:`cuda_build.CHOL_MAX_N`, the JAX kernel's ceiling;
past 128 on the packed lower triangle), K3 n ≤ 128.
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, linalg, schur

# inverse_cholesky sends n above this through the Schur recursion onto its
# kernel: the JAX package's _SCHUR_MIN_N, and the kernels' ceiling here.
SCHUR_MIN_N = cuda_build.MAX_N


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: right-looking Cholesky of an fp32
    ``(batch, n, n)`` batch, lower factor with zeros above the diagonal.

    Column k: inv = 1/sqrt(Aₖₖ) (a true division, not rsqrt), the column
    below the diagonal scaled by inv, Lₖₖ = Aₖₖ·inv, then the rank-1
    trailing update."""
    w = a.clone()
    n = w.shape[-1]
    for k in range(n):
        akk = w[:, k, k].clone()
        inv = torch.reciprocal(torch.sqrt(akk))
        w[:, k + 1:, k] = w[:, k + 1:, k] * inv[:, None]
        w[:, k, k] = akk * inv
        col = w[:, k + 1:, k]
        w[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
    return torch.tril(w)


def forward_substitution_plain(l: torch.Tensor,
                               rhs: torch.Tensor) -> torch.Tensor:
    """Y = L⁻¹·RHS for lower-triangular ``l`` (batch, n, n) and ``rhs``
    (batch, n, k), in the kernels' order: row k divided by Lₖₖ, then
    eliminated from the rows below."""
    y = rhs.clone(memory_format=torch.contiguous_format)
    for k in range(l.shape[-1]):
        y[:, k, :] = y[:, k, :] / l[:, k, k:k + 1]
        y[:, k + 1:, :] -= l[:, k + 1:, k:k + 1] * y[:, k:k + 1, :]
    return y


def inverse_cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: A⁻¹ = WᵀW with W = L⁻¹, all fp32."""
    l = cholesky_plain(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    w = forward_substitution_plain(l, eye.expand_as(a))
    return linalg.matmul(w.mT, w)


def _launch(name: str, a: torch.Tensor,
            max_n: int = cuda_build.MAX_N) -> torch.Tensor:
    cuda_build.check_kernel_input(a, "cholesky kernel", max_n=max_n)
    cuda_build.check_cuda_f32("cholesky kernel", a)
    a = a.contiguous()
    out = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)
    err = getattr(cuda_build.library(), name)(
        a.data_ptr(), out.data_ptr(), a.shape[0], a.shape[-1], device, stream)
    cuda_build.check(err, f"cholesky kernel {name}")
    return out


def cholesky_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch K4 on a CUDA fp32 batch, n ≤ :data:`cuda_build.CHOL_MAX_N`;
    ``cholesky_cuda.launches`` counts the launches and
    ``cholesky_cuda.band_launches`` those of the packed instance (n >
    128)."""
    out = _launch("cmi_chol_factor", a, max_n=cuda_build.CHOL_MAX_N)
    cholesky_cuda.launches += 1
    if a.shape[-1] > cuda_build.MAX_N:
        cholesky_cuda.band_launches += 1
    return out


def inverse_cholesky_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a CUDA fp32 batch; ``inverse_cholesky_cuda.launches``
    counts the launches."""
    out = _launch("cmi_chol_inverse", a)
    inverse_cholesky_cuda.launches += 1
    return out


cholesky_cuda.launches = 0
cholesky_cuda.band_launches = 0
inverse_cholesky_cuda.launches = 0


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor of an SPD batch (K4).

    float64, and n > 256 past the kernel's shared memory, take the library
    route (:func:`linalg.cholesky`), as the JAX package takes XLA's factor
    past its kernel.
    """
    if a.dtype == torch.float64 or (
            a.ndim == 3 and a.shape[-1] > cuda_build.CHOL_MAX_N):
        return linalg.cholesky(a)
    cuda_build.check_kernel_input(a, "cholesky kernel",
                                  max_n=cuda_build.CHOL_MAX_N)
    a32 = a.to(torch.float32)
    l = cuda_build.on_device(a32, "cholesky", cholesky_cuda, cholesky_plain,
                             a32)
    return l.to(a.dtype)


def inverse_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse (lane ``cholesky_pallas``, K3).

    float64 takes the library route (:func:`linalg.inverse_cholesky`); n
    above :data:`SCHUR_MIN_N` goes through the Schur recursion
    (:func:`schur.spd_blocked_inverse`) with this function as its base, as
    the JAX package routes it.
    """
    if a.dtype == torch.float64:
        return linalg.inverse_cholesky(a)
    if a.shape[-1] > SCHUR_MIN_N:
        return schur.spd_blocked_inverse(a, inverse_cholesky,
                                         max_base_n=SCHUR_MIN_N)
    cuda_build.check_kernel_input(a, "cholesky kernel")
    a32 = a.to(torch.float32)
    x = cuda_build.on_device(a32, "cholesky", inverse_cholesky_cuda,
                             inverse_cholesky_plain, a32)
    return x.to(a.dtype)
