"""The port's serving engines against the JAX package's.

The behaviour tests of ``tests/test_engine.py`` on ``device="cpu"``
(buckets, warmup, padding, singular members, the warm paths, concurrency),
with JAX's warm band: the warm kernels K8 and K11 serve n ≤ 224, so a
bf16 request warns and solves cold only past it, as JAX's engine does.
``GPEngine`` results are also held against the JAX engine on the same
inputs.
"""

import sys
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu import engine as jax_engine
from cuda_matrix_inversion_tpu_torch import GPEngine, InversionEngine
from cuda_matrix_inversion_tpu_torch import engine
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.models import gp_fit
from cuda_matrix_inversion_tpu_torch.ops.host_api import SingularBatchError
from cuda_matrix_inversion_tpu_torch.ops import cuda_gp, newton_schulz

CPU = {"device": "cpu"}


def _gp_inputs(batch, n, rng):
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a, c, d = (rng.random((batch, n, 1), dtype=np.float32) for _ in range(3))
    e = rng.random((batch, 1, 1), dtype=np.float32)
    return a, b, c, d, e


def _closed_form(a, b, c, d, e):
    n = b.shape[-1]
    kinv = np.linalg.inv(b.astype(np.float64)
                         + np.eye(n) * c[:, :, 0][:, None, :])
    at = np.transpose(a, (0, 2, 1))
    return at @ (kinv @ d), e - at @ (kinv @ a), kinv


def _sym_drift(x, scale, rng):
    x2 = x + scale * rng.standard_normal(x.shape).astype(np.float32)
    return ((x2 + np.transpose(x2, (0, 2, 1))) / 2).astype(np.float32)


@pytest.mark.parametrize("name", ["DEFAULT_DIM_BUCKETS",
                                  "DEFAULT_BATCH_BUCKETS",
                                  "WARM_DIM_BUCKETS"])
def test_bucket_tuples_are_the_jax_packages(name):
    assert getattr(engine, name) == getattr(jax_engine, name)


def test_round_up():
    assert engine._round_up(5, (8, 32)) == 8
    assert engine._round_up(8, (8, 32)) == 8
    assert engine._round_up(9, (8, 32)) == 32
    with pytest.raises(ValueError):
        engine._round_up(33, (8, 32))


def test_engine_serves_arbitrary_shapes():
    rng = np.random.default_rng(1)
    eng = InversionEngine(algorithm="lu", **CPU)
    for batch, n in ((3, 5), (10, 16), (8, 8)):
        a = make_spd_batch(batch, n, rng).astype(np.float32)
        out = eng.inverse(a)
        assert out.shape == a.shape and out.dtype == np.float32
        assert identity_error_inf(a, out) < 1e-4
    # two of those shapes share a bucket → two bound buckets
    assert len(eng.compiled_shapes) == 2


def test_engine_warmup_runs_each_bucket():
    rng = np.random.default_rng(2)
    eng = InversionEngine(algorithm="lu_pallas", **CPU)
    eng.warmup([(3, 5), (100, 16)])
    assert eng.compiled_shapes == [(8, 8), (128, 16)]
    before = dict(eng._compiled)
    eng.inverse(make_spd_batch(2, 4, rng).astype(np.float32))
    eng.inverse(make_spd_batch(6, 7, rng).astype(np.float32))
    assert dict(eng._compiled) == before


def test_engine_defaults_to_the_resolved_device():
    """``device=None`` means the card: without one the engines raise, as
    ``device="cuda"`` does; CPU callers say ``device="cpu"``."""
    assert GPEngine(**CPU).device == torch.device("cpu")
    assert InversionEngine(**CPU).device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for make in (InversionEngine, GPEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InversionEngine(device="cuda")


def test_engine_single_matrix_and_empty():
    eng = InversionEngine(algorithm="lu", **CPU)
    single = make_spd_batch(1, 4, np.random.default_rng(3))[0].astype(
        np.float32)
    assert eng.inverse(single).shape == (1, 4, 4)
    assert eng.inverse(np.zeros((0, 4, 4), np.float32)).shape == (0, 4, 4)
    assert eng.inverse_warm(np.zeros((0, 4, 4)),
                            np.zeros((0, 4, 4))).shape == (0, 4, 4)


@pytest.mark.parametrize("algorithm", ["lu", "lu_pallas", "gauss_pallas"])
def test_engine_check_raises_on_singular(algorithm):
    eng = InversionEngine(algorithm=algorithm, **CPU)
    a = make_square_batch(3, 8, np.random.default_rng(4)).astype(np.float32)
    a[2] = 0.0
    with pytest.raises(SingularBatchError) as err:
        eng.inverse(a, check=True)
    assert err.value.indices == [2]


def test_engine_gauss_pallas_matches_jax_engine():
    """The gauss_pallas lane through both engines (bucket (8, 32), identity
    padding): 1e-4 relative, the lane's parity bound."""
    a = make_square_batch(5, 20, np.random.default_rng(5)).astype(np.float32)
    got = InversionEngine(algorithm="gauss_pallas", **CPU).inverse(a)
    ref = jax_engine.InversionEngine(algorithm="gauss_pallas").inverse(a)
    assert identity_error_inf(a, got) < 1e-4
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4


def test_engine_inverse_warm():
    rng = np.random.default_rng(6)
    eng = InversionEngine(**CPU)
    a = make_spd_batch(10, 16, rng).astype(np.float32)
    inv1 = eng.inverse(a)
    a2 = _sym_drift(a, 0.01, rng)
    inv2 = eng.inverse_warm(a2, inv1)
    assert identity_error_inf(a2, inv2) < 1e-4
    # the warm bucket does not enter the cold cache
    assert eng.compiled_shapes == [(32, 16)]
    assert list(eng._compiled_warm) == [(32, 16)]
    with pytest.raises(ValueError, match="mismatched"):
        eng.inverse_warm(a2, inv1[:3])


def test_engine_warm_precision_wiring():
    rng = np.random.default_rng(7)
    assert InversionEngine(**CPU).warm_precision == "bf16"
    with pytest.raises(ValueError, match="warm_precision"):
        InversionEngine(warm_precision="fp8", **CPU)
    eng = InversionEngine(algorithm="newton_schulz_pan500_pallas", **CPU)
    assert eng.warm_precision == "split3"
    a = make_square_batch(6, 16, rng).astype(np.float32)
    inv1 = eng.inverse(a)
    a2 = (a + 0.005 * rng.standard_normal(a.shape)).astype(np.float32)
    inv2 = eng.inverse_warm(a2, inv1, check=True)
    assert identity_error_inf(a2, inv2) < 1e-4
    assert list(eng._compiled_warm_check) == [(8, 16)]


def test_engine_warm_runs_the_warm_kernel():
    """Below the ceiling the warm request goes through K8's wrapper (its
    plain version here: the launch counter stays 0 on CPU tensors) and
    matches a direct call of inverse_newton_schulz_warm bit for bit (8×32
    fills its bucket, so nothing is padded)."""
    rng = np.random.default_rng(8)
    eng = InversionEngine(**CPU)
    a = make_spd_batch(8, 32, rng).astype(np.float32)
    x0 = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = _sym_drift(a, 0.01, rng)
    newton_schulz.ns_refine_cuda.launches = 0
    got = eng.inverse_warm(a2, x0)
    ref = newton_schulz.inverse_newton_schulz_warm(torch.tensor(a2),
                                                   torch.tensor(x0))
    np.testing.assert_array_equal(got, ref.numpy())
    assert newton_schulz.ns_refine_cuda.launches == 0


def test_engine_warm_split3_past_the_ceiling():
    """A split3 engine refines n = 140 > 128 through the batched split3
    rounds: no warning, the gate holds from the previous inverse, one warm
    bucket (8, 160)."""
    rng = np.random.default_rng(20260820)
    eng = InversionEngine(algorithm="newton_schulz_pan500_pallas", **CPU)
    a = make_square_batch(2, 140, rng).astype(np.float32)
    inv1 = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = (a + 1e-4 * rng.standard_normal(a.shape)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        inv2 = eng.inverse_warm(a2, inv1)
    assert identity_error_inf(a2, inv2) < 1e-4
    assert list(eng._compiled_warm) == [(8, 160)]


def test_engine_warm_dim_buckets_and_warning_band():
    """JAX's warm buckets and JAX's warning band: the warm kernels serve
    n <= 224, so a bf16 engine warns only past it, where JAX's does; a
    split3 engine never warns."""
    eng = InversionEngine(**CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for n, want in ((128, (32, 128)), (150, (32, 160)),
                        (224, (32, 224))):
            assert eng._warm_buckets_for(10, n) == want
            assert jax_engine.InversionEngine()._warm_buckets_for(
                10, n) == want
        assert eng._warm_buckets_for(10, 150, True) == (32, 160)
        assert eng._warm_buckets_for(10, 300, True) == (32, 512)
    for n, want in ((232, (32, 256)), (300, (32, 512))):
        with pytest.warns(UserWarning, match="cold adaptive solve"):
            assert eng._warm_buckets_for(10, n) == want
        with pytest.warns(UserWarning, match="cold adaptive solve"):
            assert jax_engine.InversionEngine()._warm_buckets_for(
                10, n) == want


def test_engine_inverse_warm_160_bucket_runs_cold():
    """A bf16 warm request at n = 140 is served from the 160 bucket by
    K8's path (its plain version here), as JAX's engine serves it from its
    kernel: no warning, no cold solve (the result is the refinement of
    the padded previous inverse), and it passes the gate."""
    rng = np.random.default_rng(9)
    eng = InversionEngine(**CPU)
    a = make_spd_batch(4, 140, rng).astype(np.float32)
    inv1 = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = _sym_drift(a, 0.005, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        inv2 = eng.inverse_warm(a2, inv1)
    assert identity_error_inf(a2, inv2) < 1e-4
    assert list(eng._compiled_warm) == [(8, 160)]
    pa, px = (eng._pad_square(m, 8, 160) for m in (a2, inv1))
    want = newton_schulz.ns_refine_plain(torch.tensor(pa), torch.tensor(px),
                                         2, 1, False).numpy()
    np.testing.assert_array_equal(inv2, want[:4, :140, :140])


def test_engine_inverse_warm_check_divergence():
    rng = np.random.default_rng(10)
    eng = InversionEngine(**CPU)
    a = make_spd_batch(6, 16, rng).astype(np.float32)
    inv1 = eng.inverse(a)
    out = eng.inverse_warm(a, inv1, check=True)
    assert identity_error_inf(a, out) < 1e-4
    # a far batch: the refinement diverges to finite garbage, which only
    # the residual check catches
    far = make_spd_batch(6, 16, np.random.default_rng(999)).astype(np.float32)
    far = far * 7.0 + 3.0
    with pytest.raises(np.linalg.LinAlgError, match="diverged"):
        eng.inverse_warm(far, inv1, check=True)


def test_engine_concurrent_requests():
    rng = np.random.default_rng(11)
    eng = InversionEngine(**CPU)
    batches = [make_spd_batch(4 + i, 16, rng).astype(np.float32)
               for i in range(8)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(eng.inverse, batches))
    for a, inv in zip(batches, results):
        assert identity_error_inf(a, inv) < 1e-4


def test_engine_bucket_cache_under_thread_stress():
    """32 threads (more than this host's cores) with a 1 µs switch
    interval bind 6 buckets at once: every bucket lands in the cache
    exactly once and every request is right — a lost update to the cache
    would drop a bucket."""
    eng = InversionEngine(algorithm="lu", **CPU)
    shapes = [(b, n) for b in (5, 20) for n in (6, 12, 30)]
    rng = np.random.default_rng(12)
    work = [make_spd_batch(*shapes[i % 6], rng).astype(np.float32)
            for i in range(96)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            futures = [pool.submit(eng.inverse, a) for a in work]
            results = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(old)
    assert eng.compiled_shapes == [(8, 8), (8, 16), (8, 32), (32, 8),
                                   (32, 16), (32, 32)]
    assert all(identity_error_inf(a, x) < 1e-4 for a, x in zip(work, results))
    assert threading.active_count() < 32


def test_engine_512_bucket():
    a = make_spd_batch(2, 300, np.random.default_rng(13)).astype(np.float32)
    out = InversionEngine(algorithm="lu", **CPU).inverse(a)
    assert identity_error_inf(a, out) < 1e-4


@pytest.mark.parametrize("method", ["solve", "pallas", "pallas_ns"])
def test_gp_engine_matches_jax_engine(method):
    rng = np.random.default_rng(14)
    args = _gp_inputs(7, 12, rng)
    eng = GPEngine(method=method, **CPU)
    eng.warmup([(7, 12)])
    assert eng.compiled_shapes == [(8, 16)]
    mean, var = eng.mean_variance(*args)
    assert mean.shape == (7, 1, 1) and mean.dtype == np.float32
    mref, vref, _ = _closed_form(*args)
    np.testing.assert_allclose(mean, mref, atol=1e-4)
    np.testing.assert_allclose(var, vref, atol=1e-4)
    jm, jv = jax_engine.GPEngine(method=method).mean_variance(*args)
    np.testing.assert_allclose(mean, jm, atol=1e-4)
    np.testing.assert_allclose(var, jv, atol=1e-4)
    z = eng.mean_variance(*(x[:0] for x in args))
    assert z[0].shape == (0, 1, 1)


def test_gp_engine_warm_chain_matches_jax_engine():
    """Two timesteps from a cold K⁻¹, through K11's plain version: mean and
    var within 1e-4 of fp64 and of the JAX engine, the chained K⁻¹ under
    the gate; shape and empty-batch rules."""
    rng = np.random.default_rng(15)
    n, batch = 16, 6
    a, b, c, d, e = _gp_inputs(batch, n, rng)
    kinv = np.linalg.inv(b.astype(np.float64)
                         + np.eye(n) * c[:, :, 0][:, None, :]
                         ).astype(np.float32)
    eng = GPEngine(**CPU)
    eng.warmup_warm([(batch, n)])
    jeng = jax_engine.GPEngine()
    jkinv = kinv
    cuda_gp.gp_fused_warm_cuda.launches = 0
    for _ in range(2):
        b = _sym_drift(b, 0.003, rng)
        mean, var, kinv = eng.mean_variance_warm(a, b, c, d, e, kinv)
        jm, jv, jkinv = jeng.mean_variance_warm(a, b, c, d, e, jkinv)
        mref, vref, kref = _closed_form(a, b, c, d, e)
        np.testing.assert_allclose(mean, mref, atol=1e-4)
        np.testing.assert_allclose(var, vref, atol=1e-4)
        np.testing.assert_allclose(mean, jm, atol=1e-4)
        np.testing.assert_allclose(var, jv, atol=1e-4)
        k = b.astype(np.float64) + np.eye(n) * c[:, :, 0][:, None, :]
        assert np.abs(k @ kinv - np.eye(n)).max() < 1e-4
        assert kinv.shape == (batch, n, n)
    assert cuda_gp.gp_fused_warm_cuda.launches == 0
    assert list(eng._compiled_gp_warm) == [(8, 16)]
    with pytest.raises(ValueError, match="prev_kinv"):
        eng.mean_variance_warm(a, b, c, d, e, kinv[:2])
    z = eng.mean_variance_warm(a[:0], b[:0], c[:0], d[:0], e[:0], kinv[:0])
    assert z[0].shape == (0, 1, 1) and z[2].shape == (0, n, n)


def test_gp_engine_fit():
    """10 systems pad to the 32-bucket with weight-0 systems, which leave
    the real systems' trajectories and the trace as the direct fit's
    (1e-4); against the JAX engine's fit at the fit bounds (lml rtol 1e-3
    / atol 1e-2, θ atol 5e-3)."""
    rng = np.random.default_rng(16)
    batch, n, rank = 10, 16, 4
    w = rng.standard_normal((batch, n, rank))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.05 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    eng = GPEngine(**CPU)
    assert eng.fit_method == "pallas"
    assert GPEngine(dtype="float64", **CPU).fit_method == "xla"
    res = eng.fit(b, c, d, steps=30)
    assert res.log_amp.shape == (batch,) and res.lml_path.shape == (30,)
    ref = gp_fit.fit_gp_scales_host(b, c, d, steps=30, method="pallas",
                                    device="cpu")
    np.testing.assert_allclose(res.log_amp, ref.log_amp, atol=1e-4)
    np.testing.assert_allclose(res.log_noise, ref.log_noise, atol=1e-4)
    np.testing.assert_allclose(res.lml, ref.lml, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(res.lml_path, ref.lml_path, rtol=1e-4,
                               atol=1e-3)
    jres = jax_engine.GPEngine(fit_method="xla").fit(b, c, d, steps=30)
    np.testing.assert_allclose(res.log_amp, jres.log_amp, atol=5e-3)
    np.testing.assert_allclose(res.log_noise, jres.log_noise, atol=5e-3)
    np.testing.assert_allclose(res.lml, jres.lml, rtol=1e-3, atol=1e-2)
    assert len(eng._compiled_fit) == 1
    eng.fit(b[:8], c[:8], d[:8], steps=30)
    assert len(eng._compiled_fit) == 2
    z = eng.fit(b[:0], c[:0], d[:0], steps=5)
    assert z.log_amp.shape == (0,) and z.lml_path.shape == (5,)
