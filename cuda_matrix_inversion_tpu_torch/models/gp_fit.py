"""Batched GP hyper-parameter fitting: maximize the log marginal likelihood.

Counterpart of ``cuda_matrix_inversion_tpu/models/gp_fit.py``.  Per system
of the batch it learns θ = (log amplitude, log noise) of

    K(θ) = e^{2·θ_a} · B + diag(e^{2·θ_n} · c)

by maximizing the log marginal likelihood of the observations d with Adam.
``method="pallas"`` runs every step's forward and gradient on the fused
kernel K10 (:func:`ops.cuda_gp_lml.gp_log_marginal_likelihood_fused`, one
launch forward, an analytic backward of fp32 products); ``"xla"`` is the
``torch.linalg`` Cholesky chain differentiated by autograd.  The names are
the JAX package's.

The JAX package's ``lax.scan`` over the steps is a Python loop here, and
optax's Adam is ``torch.optim.Adam`` with the same defaults (β = 0.9,
0.999, ε = 1e-8 outside the root: the update is lr·m̂/(√v̂ + ε) in both).
The convergence trace stays on the device until the fit ends.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.models.gp import gp_log_marginal_likelihood
from cuda_matrix_inversion_tpu_torch.ops.cuda_gp_lml import (
    gp_log_marginal_likelihood_fused,
)
from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device


class GPFitResult(NamedTuple):
    """Outcome of :func:`fit_gp_scales` (tensors on the fit's device, or
    NumPy arrays from :func:`fit_gp_scales_host`).

    log_amp / log_noise — (batch,) learned per-system scales.
    lml — (batch,) final log marginal likelihood per system.
    lml_path — (steps,) weighted-mean LML before each step's update.
    """

    log_amp: torch.Tensor
    log_noise: torch.Tensor
    lml: torch.Tensor
    lml_path: torch.Tensor


def apply_scales(b, c, log_amp, log_noise):
    """Scaled kernel pieces (b̂, ĉ) such that B̂ + diag ĉ = K(θ); feed them
    to the prediction pipelines (:func:`models.gp.gp_mean_variance`)."""
    amp2 = torch.exp(2.0 * log_amp)[:, None, None]
    noise2 = torch.exp(2.0 * log_noise)[:, None, None]
    return b * amp2, c * noise2


def _batch_lml(theta, b, c, d, method: str = "xla"):
    """Per-system LML under θ — (batch,)."""
    b_hat, c_hat = apply_scales(b, c, theta[:, 0], theta[:, 1])
    if method == "pallas":
        return gp_log_marginal_likelihood_fused(b_hat, c_hat, d)
    if method != "xla":
        raise ValueError(f"unknown method {method!r} (xla | pallas)")
    return gp_log_marginal_likelihood(b_hat, c_hat, d)


def fit_gp_scales(b, c, d, steps: int = 150, lr: float = 0.05,
                  theta0=None, method: str = "xla",
                  weights=None) -> GPFitResult:
    """Fit (log_amp, log_noise) per system by Adam on −LML.

    Shapes: b — (batch, n, n) SPD; c, d — (batch, n, 1), tensors on one
    device; ``theta0`` — optional (batch, 2) initial (log_amp, log_noise),
    a tensor or NumPy array (a JAX fit's θ carries over), default zeros.
    ``weights`` — optional (batch,) loss weights; a system with weight 0
    gets exactly zero gradient, so its θ stays at the initial value.

    The loss is the weighted mean of −LML with the weight sum clamped to at
    least 1; systems share no parameters, so the per-system gradients are
    exact whatever the reduction.  ``lml_path[i]`` is the weighted-mean LML
    at the parameters before step i's update.
    """
    batch = b.shape[0]
    dt, dev = b.dtype, b.device
    theta = (torch.zeros((batch, 2), dtype=dt, device=dev) if theta0 is None
             else torch.as_tensor(theta0, dtype=dt, device=dev).clone())
    theta.requires_grad_(True)
    w = (torch.ones((batch,), dtype=dt, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=dt, device=dev))
    wsum = torch.clamp(w.sum(), min=1.0)
    opt = torch.optim.Adam([theta], lr=lr)
    path = torch.empty((steps,), dtype=dt, device=dev)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = -(w * _batch_lml(theta, b, c, d, method=method)).sum() / wsum
        loss.backward()
        path[i] = -loss.detach()
        opt.step()
    theta = theta.detach()
    with torch.no_grad():
        lml = _batch_lml(theta, b, c, d, method=method)
    return GPFitResult(log_amp=theta[:, 0], log_noise=theta[:, 1], lml=lml,
                       lml_path=path)


def fit_gp_scales_host(b, c, d, steps: int = 150, lr: float = 0.05,
                       theta0=None, method: str = "xla", weights=None,
                       device=None) -> GPFitResult:
    """NumPy in, NumPy out on ``device`` (the card by default, which raises
    without one; ``device="cpu"`` runs the plain kernel versions)."""
    dev = resolve_device(device)
    res = fit_gp_scales(*(torch.tensor(np.asarray(x), device=dev)
                          for x in (b, c, d)),
                        steps=steps, lr=lr, theta0=theta0, method=method,
                        weights=weights)
    return GPFitResult(*(x.cpu().numpy() for x in res))
