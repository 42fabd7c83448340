"""The port's fused log marginal likelihood (K10's plain version and its
autograd backward) and the hyper-parameter fit against the JAX package.

Same NumPy inputs, cast to float32, go through the JAX functions (the
Pallas kernel in interpret mode, where its products are fp32) and through
the port on CPU tensors, where K10 runs its plain version.  The fit
fixture is the JAX suite's ``synth`` (``tests/test_gp_fit.py``): a
low-rank-plus-diagonal B, so amplitude and noise are separately
identifiable, and observations drawn from known scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.models import gp as jax_gp
from cuda_matrix_inversion_tpu.models import gp_fit as jax_fit
from cuda_matrix_inversion_tpu.ops import pallas_gp
from cuda_matrix_inversion_tpu_torch.models import gp, gp_fit
from cuda_matrix_inversion_tpu_torch.ops import cuda_gp_lml

TRUE_LA, TRUE_LN = np.log(1.8), np.log(0.5)


def _synth(batch=16, n=48, rank=6, seed=1234):
    """tests/test_gp_fit.py's fixture: B = W Wᵀ + 0.05 I (rank ≪ n),
    c ∈ [0.5, 1.5), d drawn from K* = e^{2θ_a}B + diag(e^{2θ_n}c)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((batch, n, rank))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.05 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    k = (np.exp(2 * TRUE_LA) * b.astype(np.float64)
         + np.exp(2 * TRUE_LN) * np.eye(n) * c[:, :, 0][:, None, :])
    d = (np.linalg.cholesky(k) @ rng.standard_normal((batch, n, 1))
         ).astype(np.float32)
    return b, c, d


@pytest.fixture(scope="module")
def synth():
    return _synth()


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("emit_w", [False, True])
@pytest.mark.parametrize("n", [11, 48])
def test_k10_plain_matches_jax(n, emit_w):
    """quad and logdet (and W = L⁻¹, α = K⁻¹d) against the JAX kernel,
    whose W comes from its blocked factor-inverse body (n = 11 is padded to
    16 there and sliced back): 1e-5 relative — the same factorization in
    another summation order."""
    b, c, d = _synth(batch=5, n=n, rank=3, seed=n)
    ref = pallas_gp._lml_fused_quad_logdet(b, c, d, emit_w=emit_w, block=1)
    got = cuda_gp_lml.lml_quad_logdet(*_t(b, c[..., 0], d[..., 0]),
                                      emit_w=emit_w)
    assert len(got) == len(ref) == (4 if emit_w else 2)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == np.asarray(r).shape
        assert _rel(g.numpy(), r) <= 1e-5
    if emit_w:
        w = got[2].numpy()
        assert (np.triu(w, 1) == 0).all()


@pytest.mark.parametrize("n", [11, 48])
def test_fused_lml_matches_jax_and_library(n):
    """The fused LML against JAX's fused LML and against the port's
    ``torch.linalg`` LML, at the JAX test's rtol 1e-4 / atol 1e-3."""
    b, c, d = _synth(batch=6, n=n, rank=3, seed=2 * n)
    ref = np.asarray(pallas_gp.gp_log_marginal_likelihood_fused(b, c, d))
    got = cuda_gp_lml.gp_log_marginal_likelihood_fused(*_t(b, c, d))
    lib = gp.gp_log_marginal_likelihood(*_t(b, c, d))
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("n", [11, 48])
def test_fused_gradients_match_jax(n):
    """∂/∂b, ∂/∂c, ∂/∂d of Σ LML through the analytic backward against
    ``jax.grad`` of the JAX fused function (its custom VJP), at the JAX
    test's 2e-3; n = 11 pins the gradient where JAX slices W back from its
    padded n."""
    b, c, d = _synth(batch=5, n=n, rank=3, seed=3 * n)
    args = _t(b, c, d, grad=True)
    cuda_gp_lml.gp_log_marginal_likelihood_fused(*args).sum().backward()
    ref = jax.grad(lambda *a: jnp.sum(
        pallas_gp.gp_log_marginal_likelihood_fused(*a)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (b, c, d)))
    for x, r in zip(args, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3)


def test_theta_gradient_matches_jax(synth):
    """∂/∂θ of Σ LML through apply_scales, ``method="pallas"`` (the fit's
    gradient), against ``jax.grad`` of JAX's pallas ``_batch_lml`` and the
    port's own ``"xla"`` (autograd through ``torch.linalg``), at 2e-3."""
    b, c, d = synth
    theta = np.full((b.shape[0], 2), 0.1, np.float32)
    ref = jax.grad(lambda t: jnp.sum(jax_fit._batch_lml(
        t, *map(jnp.asarray, (b, c, d)), method="pallas")))(
        jnp.asarray(theta))
    grads = {}
    for method in ("pallas", "xla"):
        t = torch.tensor(theta, requires_grad=True)
        gp_fit._batch_lml(t, *_t(b, c, d), method=method).sum().backward()
        grads[method] = t.grad.numpy()
    for g in grads.values():
        np.testing.assert_allclose(g, np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_fit_matches_jax_fit(synth):
    """60 Adam steps with K10 on both sides, from the same θ = 0, at the
    JAX test's bounds: lml rtol 1e-3 / atol 1e-2, θ atol 5e-3 (Adam divides
    by √v̂ + ε while v̂ is small, so early gradient differences of ~1e-5
    reach θ larger than they are).  The trace too: lml_path[0] is the LML
    at θ = 0 before any update."""
    b, c, d = synth
    ref = jax_fit.fit_gp_scales_host(b, c, d, steps=60, lr=0.05,
                                     method="pallas")
    got = gp_fit.fit_gp_scales_host(b, c, d, steps=60, lr=0.05,
                                    method="pallas", device="cpu")
    assert got.lml_path.shape == (60,) and got.log_amp.shape == (16,)
    np.testing.assert_allclose(got.lml, ref.lml, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got.log_amp, ref.log_amp, atol=5e-3)
    np.testing.assert_allclose(got.log_noise, ref.log_noise, atol=5e-3)
    np.testing.assert_allclose(got.lml_path, ref.lml_path, rtol=1e-3,
                               atol=1e-2)
    lml0 = gp.gp_log_marginal_likelihood(*_t(b, c, d)).numpy().mean()
    assert got.lml_path[0] == pytest.approx(lml0, rel=1e-5)


def test_fit_continues_a_jax_fit(synth):
    """θ from 30 JAX steps, as NumPy, seeds 30 more steps in the port; the
    result matches JAX continuing the same way (each restart begins a new
    Adam state, on both sides) at the fit bounds."""
    b, c, d = synth
    first = jax_fit.fit_gp_scales_host(b, c, d, steps=30, lr=0.05)
    theta0 = np.stack([first.log_amp, first.log_noise], axis=1)
    ref = jax_fit.fit_gp_scales_host(b, c, d, steps=30, lr=0.05,
                                     theta0=theta0)
    got = gp_fit.fit_gp_scales_host(b, c, d, steps=30, lr=0.05,
                                    theta0=theta0, device="cpu")
    np.testing.assert_allclose(got.log_amp, ref.log_amp, atol=5e-3)
    np.testing.assert_allclose(got.log_noise, ref.log_noise, atol=5e-3)
    np.testing.assert_allclose(got.lml, ref.lml, rtol=1e-3, atol=1e-2)
    assert got.lml.mean() >= first.lml.mean() - 1e-3


@pytest.mark.parametrize("method", ["pallas", "xla"])
def test_zero_weight_systems_keep_theta(synth, method):
    """A system with weight 0 gets exactly zero gradient, so Adam leaves its
    θ at the initial value bit for bit, and it drops out of the trace."""
    b, c, d = (x[:6] for x in synth)
    theta0 = np.full((6, 2), 0.25, np.float32)
    weights = np.array([1, 0, 1, 0, 0, 1], np.float32)
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=10, theta0=theta0,
                                    method=method, weights=weights,
                                    device="cpu")
    frozen = weights == 0
    assert (res.log_amp[frozen] == np.float32(0.25)).all()
    assert (res.log_noise[frozen] == np.float32(0.25)).all()
    assert (res.log_amp[~frozen] != np.float32(0.25)).all()
    alone = gp_fit.fit_gp_scales_host(b[~frozen], c[~frozen], d[~frozen],
                                      steps=10, theta0=theta0[~frozen],
                                      method=method, device="cpu")
    np.testing.assert_allclose(res.lml_path, alone.lml_path, rtol=1e-6)


def test_fit_recovers_generating_scales(synth):
    """tests/test_gp_fit.py's recovery checks on the port ("xla", 250
    steps): the LML rises, the batch-mean scales land near the generating
    ones, and the fit reaches the generating parameters' own likelihood."""
    b, c, d = synth
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=250, lr=0.05,
                                    device="cpu")
    assert res.lml_path[-1] > res.lml_path[0] + 1.0
    assert res.lml_path.shape == (250,)
    assert abs(res.log_amp.mean() - TRUE_LA) < 0.25
    assert abs(res.log_noise.mean() - TRUE_LN) < 0.4
    theta_star = torch.tensor([TRUE_LA, TRUE_LN],
                              dtype=torch.float32).repeat(b.shape[0], 1)
    lml_star = gp_fit._batch_lml(theta_star, *_t(b, c, d)).numpy()
    assert res.lml.mean() >= lml_star.mean() - 0.5


def test_fitted_scales_beat_unscaled_and_feed_prediction(synth):
    """The K10 fit (150 steps) dominates the neutral start per system, and
    its scales feed the prediction pipeline."""
    b, c, d = synth
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=150, lr=0.05,
                                    method="pallas", device="cpu")
    lml0 = gp.gp_log_marginal_likelihood(*_t(b, c, d)).numpy()
    assert (res.lml >= lml0 - 1e-3).all()
    assert res.lml.mean() > lml0.mean() + 1.0
    b_hat, c_hat = gp_fit.apply_scales(*_t(b, c, res.log_amp, res.log_noise))
    ref = jax_fit.apply_scales(jnp.asarray(b), jnp.asarray(c),
                               jnp.asarray(res.log_amp),
                               jnp.asarray(res.log_noise))
    np.testing.assert_allclose(b_hat.numpy(), np.asarray(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(c_hat.numpy(), np.asarray(ref[1]), rtol=1e-6)
    a = torch.tensor(np.random.default_rng(3).standard_normal(
        (b.shape[0], b.shape[1], 1)).astype(np.float32))
    e = torch.full((b.shape[0], 1, 1), 2.0)
    for method in ("pallas", "solve"):
        mean, var = gp.gp_mean_variance(a, b_hat, c_hat, torch.tensor(d), e,
                                        method=method)
        assert torch.isfinite(mean).all() and torch.isfinite(var).all()


def test_routes_validation_and_no_launch_on_cpu(synth):
    """float64 and n > 256 take the torch.linalg LML (JAX's route past its
    kernel), n = 140 K10's plain version (the packed instance's
    arithmetic); without grad the plain variant runs alone; an unknown
    method raises; CPU tensors launch no kernel."""
    cuda_gp_lml.lml_quad_logdet_cuda.launches = 0
    b, c, d = (x[:3] for x in synth)
    b64, c64, d64 = (torch.tensor(x, dtype=torch.float64) for x in (b, c, d))
    np.testing.assert_allclose(
        cuda_gp_lml.gp_log_marginal_likelihood_fused(b64, c64, d64).numpy(),
        np.asarray(jax_gp.gp_log_marginal_likelihood(
            *(np.asarray(x, np.float64) for x in (b, c, d)))), rtol=1e-12)
    band = _synth(batch=2, n=140, rank=4, seed=7)
    got = cuda_gp_lml.gp_log_marginal_likelihood_fused(*_t(*band))
    quad, logdet = cuda_gp_lml.lml_quad_logdet_plain(
        *_t(band[0], band[1][..., 0], band[2][..., 0]))
    assert torch.equal(got, cuda_gp_lml._lml_from(quad, logdet, 140))
    big = _synth(batch=2, n=264, rank=4, seed=7)
    got = cuda_gp_lml.gp_log_marginal_likelihood_fused(*_t(*big))
    np.testing.assert_allclose(
        got.numpy(), gp.gp_log_marginal_likelihood(*_t(*big)).numpy())
    with torch.no_grad():
        args = _t(b, c, d, grad=True)
        plain = cuda_gp_lml.gp_log_marginal_likelihood_fused(*args)
    assert plain.grad_fn is None
    with pytest.raises(ValueError, match="unknown method"):
        gp_fit._batch_lml(torch.zeros(3, 2), *_t(b, c, d), method="qr")
    assert cuda_gp_lml.lml_quad_logdet_cuda.launches == 0
    with pytest.raises(ValueError, match="float32 CUDA"):
        cuda_gp_lml.lml_quad_logdet_cuda(*_t(b, c[..., 0], d[..., 0]))
    with pytest.raises(ValueError, match="c must be"):
        cuda_gp_lml.lml_quad_logdet(*_t(b, c, d))
