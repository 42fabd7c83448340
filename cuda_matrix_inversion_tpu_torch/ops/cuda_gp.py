"""Fused GP mean/variance: kernels K5 (Cholesky), K6 (Newton-Schulz) and
K11 (warm-start Newton-Schulz).

Counterpart of ``gp_mean_variance_fused``, ``gp_mean_variance_fused_ns``
and ``gp_mean_variance_fused_warm`` of
``cuda_matrix_inversion_tpu/ops/pallas_gp.py``.  For every system, with
K = B + diag(c),

    mean = aᵀ K⁻¹ d,    var = e − aᵀ K⁻¹ a,

in one launch that writes two floats per system (``csrc/gp.cu``); K11 also
writes the refined K⁻¹ for the next timestep.  On a CPU tensor each runs its
plain PyTorch version (:func:`gp_fused_plain`, :func:`gp_fused_ns_plain`,
:func:`gp_fused_warm_plain`), which repeats the kernel's steps in order.

The kernels take the flat layout a, c, d ``(batch, n)``, b
``(batch, n, n)``, e ``(batch,)`` and return ``(batch, 2)`` = [mean, var];
the public functions take the fixture layout.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    linalg,
    newton_schulz,
    schur,
)

# K6's schedule: resolve_schedule(init="spd") — SPD_SCHEDULE (6, 2) at
# MU_MIN_SPD, the last polish residual in fp32 (what the JAX kernel runs).
GP_NS_SCHEDULE = newton_schulz.resolve_schedule(init="spd")


def _project(a, x, e):
    """(mean, var) from x = K⁻¹[d a] in the fixture layout."""
    proj = linalg.matmul(a.transpose(-1, -2), x)   # (batch, 1, 2)
    return proj[:, :, 0:1], e - proj[:, :, 1:2]


def gp_fused_plain(a, b, c, d, e):
    """Plain PyTorch version of K5 on the flat layout: factor K, solve
    L[y_d y_a] = [d a], then mean = y_a·y_d, var = e − y_a·y_a."""
    l = cuda_cholesky.cholesky_plain(linalg.add_diagonal(b, c))
    y = cuda_cholesky.forward_substitution_plain(l, torch.stack([d, a], -1))
    yd, ya = y[..., 0], y[..., 1]
    return torch.stack([(ya * yd).sum(-1), e - (ya * ya).sum(-1)], dim=-1)


def gp_fused_ns_plain(a, b, c, d, e, bf16_products: bool = True):
    """Plain PyTorch version of K6 on the flat layout: X ≈ K⁻¹ by
    :data:`GP_NS_SCHEDULE`, then x = [d a]·X in fp32, mean = x_d·a,
    var = e − x_a·a.  ``bf16_products`` as in
    :func:`newton_schulz.ns_iterate_plain` (False is the JAX reference's
    interpret-mode arithmetic)."""
    x = newton_schulz.ns_iterate_plain(linalg.add_diagonal(b, c),
                                       GP_NS_SCHEDULE, bf16_products)
    proj = (linalg.matmul(torch.stack([d, a], 1), x) * a[:, None, :]).sum(-1)
    return torch.stack([proj[:, 0], e - proj[:, 1]], dim=-1)


def gp_fused_warm_plain(a, b, c, d, e, x0, lo: int = 2, hi: int = 1,
                        bf16_products: bool = True):
    """Plain PyTorch version of K11 on the flat layout: X ← ``x0`` refined
    by K8's unscaled rounds (:func:`newton_schulz.ns_refine_plain`), then
    K6's fp32 epilogue.  Returns ``(out, kinv)``: ``(batch, 2)`` =
    [mean, var] and the refined X."""
    x = newton_schulz.ns_refine_plain(linalg.add_diagonal(b, c), x0, lo, hi,
                                      False, bf16_products)
    proj = (linalg.matmul(torch.stack([d, a], 1), x) * a[:, None, :]).sum(-1)
    return torch.stack([proj[:, 0], e - proj[:, 1]], dim=-1), x


def _gp_launch(fn_name: str, a, b, c, d, e, *extra,
               max_n: int = cuda_build.MAX_N, tail: tuple = ()):
    cuda_build.check_kernel_input(b, "gp kernel", max_n=max_n)
    cuda_build.check_cuda_f32("gp kernel", a, b, c, d, e)
    out = torch.empty((b.shape[0], 2), dtype=torch.float32, device=b.device)
    device, stream = cuda_build.launch_args(b)
    err = getattr(cuda_build.library(), fn_name)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(),
        out.data_ptr(), b.shape[0], b.shape[-1], *extra, device, stream,
        *tail)
    cuda_build.check(err, f"gp kernel {fn_name}")
    return out


def gp_fused_cuda(a, b, c, d, e):
    """Launch K5 on contiguous CUDA fp32 tensors in the flat layout, n ≤
    :data:`cuda_build.CHOL_MAX_N` (past 128 on the packed lower triangle);
    ``gp_fused_cuda.launches`` counts the launches and
    ``gp_fused_cuda.band_launches`` those of the packed instance."""
    out = _gp_launch("cmi_gp_fused", a, b, c, d, e,
                     max_n=cuda_build.CHOL_MAX_N)
    gp_fused_cuda.launches += 1
    if b.shape[-1] > cuda_build.MAX_N:
        gp_fused_cuda.band_launches += 1
    return out


def gp_fused_ns_cuda(a, b, c, d, e):
    """Launch K6 on contiguous CUDA fp32 tensors in the flat layout, n ≤
    :data:`cuda_build.WARM_MAX_N` (one thread block a system up to 128,
    one 2 × 2 thread-block cluster past it); ``gp_fused_ns_cuda.launches``
    counts the launches, ``gp_fused_ns_cuda.band_launches`` those of the
    cluster instance and ``gp_fused_ns_cuda.band_launches_<NP>`` those at
    each padded size NP (160, 192, 224), as the launch reports it."""
    sched = GP_NS_SCHEDULE
    two_c, c_sq = newton_schulz.round_scalars(sched.coeffs, b.device)
    quad_np = ctypes.c_int(0)
    out = _gp_launch("cmi_gp_fused_ns", a, b, c, d, e, sched.lo_iters,
                     sched.hi_iters, two_c, c_sq,
                     max_n=cuda_build.WARM_MAX_N,
                     tail=(ctypes.byref(quad_np),))
    gp_fused_ns_cuda.launches += 1
    if quad_np.value:
        gp_fused_ns_cuda.band_launches += 1
        key = f"band_launches_{quad_np.value}"
        setattr(gp_fused_ns_cuda, key, getattr(gp_fused_ns_cuda, key) + 1)
    return out


def gp_fused_warm_cuda(a, b, c, d, e, x0, lo: int = 2, hi: int = 1):
    """Launch K11 on contiguous CUDA fp32 tensors in the flat layout,
    n ≤ :data:`cuda_build.WARM_MAX_N` (one thread block a system up to
    128, one thread-block cluster past it): ``(out, kinv)`` as
    :func:`gp_fused_warm_plain`.  ``gp_fused_warm_cuda.launches`` counts
    the launches and ``gp_fused_warm_cuda.band_launches`` those of the
    cluster instance."""
    cuda_build.check_kernel_input(b, "gp warm kernel",
                                  max_n=cuda_build.WARM_MAX_N)
    cuda_build.check_cuda_f32("gp warm kernel", x0)
    if x0.shape != b.shape:
        raise ValueError(f"gp warm kernel: x0 {tuple(x0.shape)} must match "
                         f"b {tuple(b.shape)}")
    x0 = x0.contiguous()
    kinv = torch.empty_like(x0)
    out = _gp_launch("cmi_gp_fused_warm", a, b, c, d, e, x0.data_ptr(),
                     kinv.data_ptr(), lo, hi, max_n=cuda_build.WARM_MAX_N)
    gp_fused_warm_cuda.launches += 1
    if b.shape[-1] > cuda_build.MAX_N:
        gp_fused_warm_cuda.band_launches += 1
    return out, kinv


gp_fused_cuda.launches = 0
gp_fused_cuda.band_launches = 0
gp_fused_ns_cuda.launches = 0
gp_fused_ns_cuda.band_launches = 0
for _np in cuda_build.NS_BAND_NP:
    setattr(gp_fused_ns_cuda, f"band_launches_{_np}", 0)
gp_fused_warm_cuda.launches = 0
gp_fused_warm_cuda.band_launches = 0


def _flat(a, b, c, d, e, max_n: int = cuda_build.MAX_N):
    """Check the fixture layout (n ≤ ``max_n``) and return the kernels'
    flat fp32 layout."""
    cuda_build.check_kernel_input(b, "gp kernel", max_n=max_n)
    batch, n, _ = b.shape
    for name, v, shape in (("a", a, (batch, n, 1)), ("c", c, (batch, n, 1)),
                           ("d", d, (batch, n, 1)), ("e", e, (batch, 1, 1))):
        if tuple(v.shape) != shape:
            raise ValueError(f"gp kernel: {name} must be {shape}, got "
                             f"{tuple(v.shape)}")
    f32 = torch.float32
    return (a[..., 0].to(f32).contiguous(), b.to(f32).contiguous(),
            c[..., 0].to(f32).contiguous(), d[..., 0].to(f32).contiguous(),
            e.reshape(batch).to(f32).contiguous())


def _run(b, cuda_fn, plain_fn, flat):
    out = cuda_build.on_device(b, "gp", cuda_fn, plain_fn, *flat).to(b.dtype)
    return out[:, 0, None, None], out[:, 1, None, None]


def gp_schur_route(a, b, c, d, e):
    """The route past K5's ceiling, as the JAX package takes it past 256:
    :func:`schur.spd_schur_solve` of K[d a] with the K3 inverse
    (:func:`cuda_cholesky.inverse_cholesky`) as its base; fixture layout in
    and out, as :func:`gp_mean_variance_fused`."""
    x = schur.spd_schur_solve(linalg.add_diagonal(b, c),
                              torch.cat([d, a], dim=-1),
                              cuda_cholesky.inverse_cholesky,
                              max_base_n=cuda_build.MAX_N)
    return _project(a, x, e)


def gp_mean_variance_fused(a, b, c, d, e):
    """Fused batched GP mean and variance, one K5 launch for the batch.

    a, c, d: (batch, n, 1); b: (batch, n, n); e: (batch, 1, 1).  Returns
    (means, variances), each (batch, 1, 1).  K5 takes n ≤ 256, the JAX
    kernel's ceiling (one thread block a system; past 128 on the packed
    lower triangle).  float64 takes the library solve route, and n > 256
    :func:`gp_schur_route`, as the JAX package routes them.
    """
    if b.dtype == torch.float64:
        return _project(a, linalg.spd_solve(linalg.add_diagonal(b, c),
                                            torch.cat([d, a], dim=-1)), e)
    if b.shape[-1] > cuda_build.CHOL_MAX_N:
        return gp_schur_route(a, b, c, d, e)
    return _run(b, gp_fused_cuda, gp_fused_plain,
                _flat(a, b, c, d, e, max_n=cuda_build.CHOL_MAX_N))


def gp_mean_variance_fused_ns(a, b, c, d, e):
    """Fused GP through Newton-Schulz, one K6 launch for the batch: the
    fastest route for diagonally dominant K (κ ≲ 30); same shapes and
    contract as :func:`gp_mean_variance_fused`.  K6 serves n ≤ 224, the
    JAX kernel's ceiling: one thread block a system up to 128, one
    thread-block cluster past it.  float64 and n > 224 go to
    :func:`gp_mean_variance_fused`, as JAX's do."""
    if b.dtype == torch.float64 or b.shape[-1] > cuda_build.WARM_MAX_N:
        return gp_mean_variance_fused(a, b, c, d, e)
    return _run(b, gp_fused_ns_cuda, gp_fused_ns_plain,
                _flat(a, b, c, d, e, max_n=cuda_build.WARM_MAX_N))


def gp_mean_variance_fused_warm(a, b, c, d, e, prev_kinv, lo_iters: int = 2,
                                hi_iters: int = 1):
    """Warm-start fused GP, one K11 launch: refine ``prev_kinv`` (the
    ``kinv`` this function returned for the previous timestep, or a cold
    K⁻¹) for K = B + diag(c), then mean and variance from it.

    Same shapes as :func:`gp_mean_variance_fused` plus ``prev_kinv``
    ``(batch, n, n)``; returns ``(mean, var, kinv)``, and ``kinv`` chains
    into the next call.  Valid while the drift δ of K satisfies
    δ·κ(K) ≲ 0.3 and κ(K) ≲ 30 (K8's bf16 domain).  K11 serves n ≤ 224,
    the JAX kernel's ceiling: one thread block a system up to 128, one
    thread-block cluster past it.  float64 and n > 224 take the JAX
    package's route past its kernel: mean and variance by
    :func:`gp_mean_variance_fused`, kinv by
    :func:`newton_schulz.inverse_newton_schulz_warm` with its default
    rounds (which warns and solves cold past 224).
    """
    if tuple(prev_kinv.shape) != tuple(b.shape):
        raise ValueError(f"prev_kinv shape {tuple(prev_kinv.shape)} must "
                         f"match b {tuple(b.shape)}")
    if b.dtype == torch.float64 or b.shape[-1] > cuda_build.WARM_MAX_N:
        mean, var = gp_mean_variance_fused(a, b, c, d, e)
        kinv = newton_schulz.inverse_newton_schulz_warm(
            linalg.add_diagonal(b, c), prev_kinv)
        return mean, var, kinv
    flat = _flat(a, b, c, d, e, max_n=cuda_build.WARM_MAX_N)
    x0 = prev_kinv.to(torch.float32).contiguous()
    out, kinv = cuda_build.on_device(b, "gp warm", gp_fused_warm_cuda,
                                     gp_fused_warm_plain, *flat, x0,
                                     lo_iters, hi_iters)
    out = out.to(b.dtype)
    return out[:, 0, None, None], out[:, 1, None, None], kinv.to(b.dtype)
