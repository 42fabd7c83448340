"""Host-facing convenience API — counterpart of
``cuda_matrix_inversion_tpu/ops/host_api.py``.

:func:`inverse_batched` and :func:`solve_batched` take NumPy arrays, move
them to a device, run the lane there and return NumPy arrays;
:func:`inverse_batched_device` composes on tensors already on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.ops import linalg
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm
from cuda_matrix_inversion_tpu_torch.types import as_batch


class SingularBatchError(np.linalg.LinAlgError):
    """Raised when ``check=True`` finds non-invertible matrices in a batch
    (the analog of cuBLAS's per-matrix info array); carries the offending
    batch indices."""

    def __init__(self, indices):
        self.indices = list(indices)
        super().__init__(
            f"batch members {self.indices} produced non-finite inverses "
            f"(singular or ill-conditioned beyond the dtype)")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card, as ``"cuda"`` does: on a host without one
    both raise, and the work is never moved to the CPU instead.  CPU
    callers pass ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available")
    return device


def inverse_batched(a: np.ndarray, algorithm: str = "lu", device=None,
                    check: bool = False) -> np.ndarray:
    """Invert a host batch on ``device``; NumPy in, NumPy out.  A host
    lane (a name ending in ``_cpu``) takes the NumPy batch itself and
    touches no device.

    ``check=True`` raises :class:`SingularBatchError` naming the members
    whose inverse is not finite."""
    host = as_batch(a)
    fn = get_inverse_algorithm(algorithm)
    if algorithm.endswith("_cpu"):
        out = fn(host)
    else:
        out = fn(torch.tensor(host, device=resolve_device(device))
                 ).cpu().numpy()
    if check:
        finite = np.isfinite(out).all(axis=(1, 2))
        if not finite.all():
            raise SingularBatchError(np.nonzero(~finite)[0])
    return out


def inverse_batched_device(a: torch.Tensor, algorithm: str = "lu") -> torch.Tensor:
    """Device-resident flavor: tensor in, tensor out, on ``a``'s device."""
    return get_inverse_algorithm(algorithm)(a)


def solve_batched(a: np.ndarray, rhs: np.ndarray, method: str = "lu",
                  device=None) -> np.ndarray:
    """Batched linear solve AX = RHS without forming A⁻¹; NumPy in/out.

    ``method="lu"`` for general systems, ``"cholesky"`` for SPD ones;
    ``"lu_cpu"`` and ``"cholesky_cpu"`` solve each member on the host with
    SciPy and touch no device.  ``rhs``: (batch, n, k) or (batch, n)."""
    solvers = {"lu": linalg.lu_solve, "cholesky": linalg.spd_solve}
    methods = (*solvers, "lu_cpu", "cholesky_cpu")
    if method not in methods:
        raise KeyError(f"unknown solve method {method!r}; have {list(methods)}")
    host_a = as_batch(a)
    host_rhs = np.asarray(rhs, dtype=host_a.dtype)
    squeeze = host_rhs.ndim == 2
    if squeeze:
        host_rhs = host_rhs[..., None]
    if method.endswith("_cpu"):
        import scipy.linalg

        out = np.empty_like(host_rhs)
        for i in range(host_a.shape[0]):
            if method == "cholesky_cpu":
                cf = scipy.linalg.cho_factor(host_a[i], lower=True)
                out[i] = scipy.linalg.cho_solve(cf, host_rhs[i])
            else:
                out[i] = scipy.linalg.solve(host_a[i], host_rhs[i])
    else:
        dev = resolve_device(device)
        out = solvers[method](torch.tensor(host_a, device=dev),
                              torch.tensor(host_rhs, device=dev)).cpu().numpy()
    return out[..., 0] if squeeze else out
