"""Gaussian-Process predictive mean/variance — the flagship model.

Counterpart of ``cuda_matrix_inversion_tpu/models/gp.py``.  With
K = B + diag(c):

    mean = aᵀ K⁻¹ d
    var  = e − aᵀ K⁻¹ a

Inputs are batched: a, c, d — (batch, n, 1); b — (batch, n, n);
e — (batch, 1, 1).  Outputs are (batch, 1, 1), as ``means.mats`` /
``variances.mats``.  ``method`` picks how K⁻¹ is applied:

* ``solve`` — Cholesky solve on ``torch.linalg`` (the default; the
  reference's ``-DGAUSS_SOLVE`` build);
* ``inverse`` / ``lu`` — ``torch.linalg`` Cholesky / LU inverse, then a
  product;
* ``newton_schulz`` — the adaptive Newton-Schulz inverse;
* ``pallas`` — K3, then a product; in :func:`gp_mean_variance` the fused
  kernel K5;
* ``pallas_ns`` — K1 with the spd start, then a product; in
  :func:`gp_mean_variance` the fused kernel K6.

Tensors stay on their device; the ``*_host`` functions take NumPy arrays
and an explicit ``device=``, and return NumPy arrays.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_cholesky,
    cuda_gp,
    linalg,
    newton_schulz,
)
from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device

_INVERSES = {
    "inverse": linalg.inverse_cholesky,
    "lu": linalg.inverse_lu,
    "newton_schulz": newton_schulz.inverse_newton_schulz,
    "pallas": cuda_cholesky.inverse_cholesky,
    "pallas_ns": functools.partial(newton_schulz.inverse_newton_schulz_fixed,
                                   init="spd"),
}


def _kinv_apply(b, c, rhs, method: str):
    """(B + diag c)⁻¹ @ rhs for a stack of right-hand-side columns."""
    k = linalg.add_diagonal(b, c)
    if method == "solve":
        return linalg.spd_solve(k, rhs)
    if method not in _INVERSES:
        raise ValueError(f"unknown method {method!r}")
    return linalg.matmul(_INVERSES[method](k), rhs)


def gp_mean(a, b, c, d, method: str = "solve"):
    """Batched predictive mean aᵀK⁻¹d (the reference's ``calcluateMean``)."""
    return linalg.matmul(a.transpose(-1, -2), _kinv_apply(b, c, d, method))


def gp_variance(a, b, c, e, method: str = "solve"):
    """Batched predictive variance e − aᵀK⁻¹a (the reference's
    ``calcluateVariance``, with the documented sign)."""
    quad = linalg.matmul(a.transpose(-1, -2), _kinv_apply(b, c, a, method))
    return e - quad


def gp_mean_variance(a, b, c, d, e, method: str = "solve"):
    """Mean and variance from one factorization and one 2-RHS solve;
    ``pallas`` and ``pallas_ns`` run the fused kernels K5 and K6."""
    if method == "pallas":
        return cuda_gp.gp_mean_variance_fused(a, b, c, d, e)
    if method == "pallas_ns":
        return cuda_gp.gp_mean_variance_fused_ns(a, b, c, d, e)
    x = _kinv_apply(b, c, torch.cat([d, a], dim=-1), method)
    proj = linalg.matmul(a.transpose(-1, -2), x)    # (batch, 1, 2)
    return proj[:, :, 0:1], e - proj[:, :, 1:2]


def gp_mean_variance_multi(a, b, c, d, e, method: str = "solve"):
    """Mean and variance at ``m`` test points per system, one
    factorization: a — (batch, n, m); b — (batch, n, n); c, d —
    (batch, n, 1); e — (batch, m, 1).  Returns mean, var, each
    (batch, m, 1).  The variance takes only the diagonal of AᵀK⁻¹A, as a
    masked elementwise reduction, never the m×m cross-covariance."""
    x = _kinv_apply(b, c, torch.cat([d, a], dim=-1), method)  # (b, n, 1+m)
    mean = linalg.matmul(a.transpose(-1, -2), x[:, :, 0:1])
    quad = (a * x[:, :, 1:]).sum(dim=1)[:, :, None]          # diag(AᵀK⁻¹A)
    return mean, e - quad


def gp_log_marginal_likelihood(b, c, d):
    """Batched log p(d) = −½ dᵀK⁻¹d − ½ log|K| − n/2 · log 2π from one
    Cholesky factor on ``torch.linalg``, differentiable by autograd (the
    fused kernel K10 is
    :func:`ops.cuda_gp_lml.gp_log_marginal_likelihood_fused`).
    b — (batch, n, n); c, d — (batch, n, 1) → (batch,)."""
    l = linalg.cholesky(linalg.add_diagonal(b, c))
    y = torch.linalg.solve_triangular(l, d, upper=False)
    quad = (y * y).sum(dim=(-2, -1))                        # dᵀK⁻¹d
    logdet = 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
    n = b.shape[-1]
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


# ---- host-facing flavor: NumPy in, NumPy out, on ``device`` (None: the
# card, which raises without one) ----

def _tensors(arrays, device):
    dev = resolve_device(device)
    return [torch.tensor(np.asarray(x), device=dev) for x in arrays]


def gp_mean_host(a, b, c, d, method: str = "solve",
                 device=None) -> np.ndarray:
    return gp_mean(*_tensors((a, b, c, d), device), method=method
                   ).cpu().numpy()


def gp_variance_host(a, b, c, e, method: str = "solve",
                     device=None) -> np.ndarray:
    return gp_variance(*_tensors((a, b, c, e), device), method=method
                       ).cpu().numpy()


def gp_mean_variance_host(a, b, c, d, e, method: str = "solve",
                          device=None):
    mean, var = gp_mean_variance(*_tensors((a, b, c, d, e), device),
                                 method=method)
    return mean.cpu().numpy(), var.cpu().numpy()
