"""Fused GP log marginal likelihood: kernel K10 and its autograd backward.

Counterpart of ``_lml_fused_quad_logdet`` and
``gp_log_marginal_likelihood_fused`` of
``cuda_matrix_inversion_tpu/ops/pallas_gp.py``, the hot loop of the
hyper-parameter fit.  Per system, with K = B + diag(c) = LLᵀ,

    quad = dᵀK⁻¹d,    logdet = 2·Σₖ log Lₖₖ,
    LML  = −½ (quad + logdet + n log 2π),

from one launch of ``csrc/gp.cu``'s K10 that writes two floats per system.
Its ``emit_w`` variant, the autograd forward, also writes W = L⁻¹ and
α = K⁻¹d, so the backward needs no second factorization.  On a CPU tensor
:func:`lml_quad_logdet` runs the plain PyTorch version
:func:`lml_quad_logdet_plain`, which repeats the kernel's steps in order.

The kernel takes the flat layout b ``(batch, n, n)``, c, d ``(batch, n)``;
:func:`gp_log_marginal_likelihood_fused` takes the fixture layout.
"""

from __future__ import annotations

import math

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_cholesky, linalg


def _lane_sum(x, square: bool = False):
    """Σ x (Σ x² with ``square``) over the last axis in K10's order: lane l
    of one warp adds x[l], x[l + 32], … to 0 (a rounded square, then a
    rounded sum), then five xor steps add lane l ^ o (o = 16, 8, 4, 2, 1)
    and lane 0's sum is the result.  The zeros that pad the last row of
    lanes leave every partial sum (never −0) unchanged."""
    n = x.shape[-1]
    rows = -(-n // 32)
    xs = torch.zeros(x.shape[:-1] + (rows * 32,), dtype=x.dtype,
                     device=x.device)
    xs[..., :n] = x
    xs = xs.reshape(x.shape[:-1] + (rows, 32))
    s = torch.zeros(x.shape[:-1] + (32,), dtype=x.dtype, device=x.device)
    for r in range(rows):
        v = xs[..., r, :]
        s = s + (v * v if square else v)
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    return s[..., 0]


def lml_quad_logdet_plain(b, c, d, emit_w: bool = False):
    """Plain PyTorch version of K10 on the flat fp32 layout, in the order of
    its packed instance (n > 128), which it repeats bit for bit.

    Without ``emit_w``: factor K, solve L y = d, quad = y·y; returns
    ``(quad, logdet)``.  With it: W = L⁻¹ by forward substitution against
    I, t = W d (tᵢ = Σₖ Wᵢₖ dₖ in increasing k), α = Wᵀt (αⱼ = Σᵢ Wᵢⱼ tᵢ in
    increasing i), quad = t·t; returns ``(quad, logdet, w, alpha)``.  Every
    sum is a rounded product then a rounded sum; quad and log|K| go through
    :func:`_lane_sum`.  The square instance (n ≤ 128) fuses those
    multiply-adds and lands within an ulp or two.
    """
    n = b.shape[-1]
    l = cuda_cholesky.cholesky_plain(linalg.add_diagonal(b, c))
    logdet = 2.0 * _lane_sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)))
    if not emit_w:
        y = cuda_cholesky.forward_substitution_plain(l, d[..., None])[..., 0]
        return _lane_sum(y, square=True), logdet
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    w = cuda_cholesky.forward_substitution_plain(l, eye.expand_as(b))
    t = torch.zeros_like(d)
    for k in range(n):  # rows k.. take W[i][k] d[k]; W is zero above
        t[:, k:] = t[:, k:] + w[:, k:, k] * d[:, k:k + 1]
    alpha = torch.zeros_like(d)
    for i in range(n):  # columns ..i take W[i][j] t[i]
        alpha[:, :i + 1] = alpha[:, :i + 1] + w[:, i, :i + 1] * t[:, i:i + 1]
    return _lane_sum(t, square=True), logdet, w, alpha


def lml_quad_logdet_cuda(b, c, d, emit_w: bool = False):
    """Launch K10 on contiguous CUDA fp32 tensors in the flat layout;
    returns as :func:`lml_quad_logdet_plain`.
    ``lml_quad_logdet_cuda.launches`` counts the launches; of the packed
    instances (n > 128), ``.band_launches`` counts those without ``emit_w``
    and ``.band_emit_w_launches`` those with it (W = L⁻¹ built in place
    over L)."""
    cuda_build.check_kernel_input(b, "gp lml kernel",
                                  max_n=cuda_build.CHOL_MAX_N)
    cuda_build.check_cuda_f32("gp lml kernel", b, c, d)
    batch, n, _ = b.shape
    out = torch.empty((batch, 2), dtype=torch.float32, device=b.device)
    w = alpha = None
    if emit_w:
        w = torch.empty_like(b)
        alpha = torch.empty((batch, n), dtype=torch.float32, device=b.device)
    device, stream = cuda_build.launch_args(b)
    err = cuda_build.library().cmi_gp_lml(
        b.data_ptr(), c.data_ptr(), d.data_ptr(), out.data_ptr(),
        w.data_ptr() if emit_w else None,
        alpha.data_ptr() if emit_w else None, batch, n, int(emit_w), device,
        stream)
    cuda_build.check(err, "gp lml kernel")
    lml_quad_logdet_cuda.launches += 1
    if n > cuda_build.MAX_N and emit_w:
        lml_quad_logdet_cuda.band_emit_w_launches += 1
    elif n > cuda_build.MAX_N:
        lml_quad_logdet_cuda.band_launches += 1
    if emit_w:
        return out[:, 0], out[:, 1], w, alpha
    return out[:, 0], out[:, 1]


lml_quad_logdet_cuda.launches = 0
lml_quad_logdet_cuda.band_launches = 0
lml_quad_logdet_cuda.band_emit_w_launches = 0


def lml_quad_logdet(b, c, d, emit_w: bool = False):
    """(quad, logdet[, w, alpha]) per system through K10, fp32, flat layout
    (b ``(batch, n, n)``, c and d ``(batch, n)``), 1 ≤ n ≤ 256."""
    cuda_build.check_kernel_input(b, "gp lml kernel",
                                  max_n=cuda_build.CHOL_MAX_N)
    batch, n, _ = b.shape
    for name, v in (("c", c), ("d", d)):
        if tuple(v.shape) != (batch, n):
            raise ValueError(f"gp lml kernel: {name} must be {(batch, n)}, "
                             f"got {tuple(v.shape)}")
    b, c, d = (x.to(torch.float32).contiguous() for x in (b, c, d))
    return cuda_build.on_device(b, "gp lml", lml_quad_logdet_cuda,
                                lml_quad_logdet_plain, b, c, d, emit_w)


def _lml_from(quad, logdet, n: int):
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


class _LMLFused(torch.autograd.Function):
    """The fused LML with the JAX package's analytic VJP (``_lml_fused_bwd``)
    on fp32 b ``(batch, n, n)``, c, d ``(batch, n, 1)``."""

    @staticmethod
    def forward(ctx, b, c, d):
        quad, logdet, w, alpha = lml_quad_logdet(b, c[..., 0], d[..., 0],
                                                 emit_w=True)
        ctx.save_for_backward(w, alpha)
        return _lml_from(quad, logdet, b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        """∂LML/∂K = ½(ααᵀ − K⁻¹) with K⁻¹ = WᵀW, ∂LML/∂d = −α; K = B +
        diag c, so ∂/∂B is the whole matrix and ∂/∂c its diagonal.  The
        products are full fp32 (``linalg.matmul``), as JAX's HIGHEST
        ``jnp.matmul`` outside its kernel."""
        w, alpha = ctx.saved_tensors
        kinv = linalg.matmul(w.mT, w)
        al = alpha[:, :, None]
        gk = 0.5 * (linalg.matmul(al, al.mT) - kinv)
        gm = g[:, None, None].to(gk.dtype)
        gb = gm * gk
        gc = gm * torch.diagonal(gk, dim1=-2, dim2=-1)[:, :, None]
        gd = gm * (-al)
        return gb, gc, gd


def gp_log_marginal_likelihood_fused(b, c, d):
    """Batched GP log marginal likelihood through K10, differentiable.

    Same contract as :func:`models.gp.gp_log_marginal_likelihood`
    (b — (batch, n, n); c, d — (batch, n, 1) → (batch,)).  When autograd
    records (grad enabled and an input requires grad) the forward runs the
    ``emit_w`` variant and the backward is the analytic VJP of
    :class:`_LMLFused`; otherwise the plain variant runs alone.  K10 takes
    n ≤ 256, the JAX kernel's ceiling.  float64 and n > 256 take
    :func:`models.gp.gp_log_marginal_likelihood` on ``torch.linalg``,
    differentiated by autograd, the JAX package's route past its kernel.
    """
    n = b.shape[-1]
    if b.dtype == torch.float64 or n > cuda_build.CHOL_MAX_N:
        from cuda_matrix_inversion_tpu_torch.models.gp import (
            gp_log_marginal_likelihood,
        )

        return gp_log_marginal_likelihood(b, c, d)
    orig = b.dtype
    b, c, d = (x.to(torch.float32) for x in (b, c, d))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (b, c, d)):
        return _LMLFused.apply(b, c, d).to(orig)
    quad, logdet = lml_quad_logdet(b, c[..., 0], d[..., 0])
    return _lml_from(quad, logdet, n).to(orig)
