"""The warm kernels K8 and K11 at 129 ≤ n ≤ 224 against the JAX package.

The JAX warm kernels serve n ≤ 224; the port's K8 and K11 serve the same
band, one thread-block cluster a matrix past n = 128.  On the CPU the
wrappers run their plain versions (``ns_refine_plain``,
``gp_fused_warm_plain``), which these tests hold against the JAX kernels
in interpret mode (every product fp32, ``block=1``), from the same X0.
Inputs are NumPy draws from a seed of each test, cast to float32 (the
suite runs JAX with x64 on).  Tolerances are max-norm relative on
inverses and absolute on mean and variance.
"""

import warnings

import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu import engine as jax_engine
from cuda_matrix_inversion_tpu.ops import newton_schulz as jax_ns
from cuda_matrix_inversion_tpu.ops import pallas_gp
from cuda_matrix_inversion_tpu_torch import GPEngine, InversionEngine
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_nonsym_cond,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp, linalg
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns

CPU = {"device": "cpu"}
# The port's CPU path rounds its products to bf16 as the card does; JAX's
# interpret mode computes them in fp32.  Each lands within its residual
# (≲ 2e-5 on these draws) of A⁻¹, so they differ by at most K1's 2e-4
# relative; with fp32 products on both sides (bf16_products=False) only
# the order of the sums differs: 1e-5.
RTOL_PATH, RTOL_FP32 = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs in parallel workers: with PyTorch's OpenMP pool and
    NumPy's BLAS on one thread each of these small products runs at once
    instead of waiting for the worker's other threads.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _drifted(a, delta, rng, symmetric):
    """``a`` plus a Gaussian perturbation of relative 2-norm δ (symmetrised
    for SPD input), float32."""
    noise = rng.standard_normal(a.shape)
    if symmetric:
        noise = (noise + np.transpose(noise, (0, 2, 1))) / 2
    scale = (np.linalg.norm(a, 2, axis=(1, 2))
             / np.linalg.norm(noise, 2, axis=(1, 2)))[:, None, None]
    return (a + delta * scale * noise).astype(np.float32)


def _warm_case(precision, batch, n, seed):
    """(a, x0): bf16 on the reference's SPD class (κ ≈ 2–3, its warm
    domain) drifted by δ = 1e-3; split3 on a κ = 500 nonsymmetric batch
    drifted by δ = 1e-4; x0 the exact inverse before the drift."""
    rng = np.random.default_rng(seed)
    if precision == "bf16":
        a0 = make_spd_batch(batch, n, rng).astype(np.float32)
        delta = 1e-3
    else:
        a0 = make_nonsym_cond(batch, n, 500.0, rng)
        delta = 1e-4
    x0 = np.linalg.inv(a0.astype(np.float64)).astype(np.float32)
    return _drifted(a0, delta, rng, precision == "bf16"), x0


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [140, 160])
def test_k8_band_cpu_path_matches_jax_interpret(precision, n):
    """``inverse_newton_schulz_warm`` at n = 140 and 160 runs K8's plain
    version (no warning, no launch) within RTOL_PATH of JAX's warm kernel;
    with fp32 products it is JAX's interpret-mode arithmetic, RTOL_FP32;
    all three through the gate."""
    a, x0 = _warm_case(precision, 2, n, 1500 + n)
    ref = np.asarray(jax_ns.inverse_newton_schulz_warm(
        a, x0, block=1, precision=precision))
    before = ns.ns_refine_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = ns.inverse_newton_schulz_warm(torch.tensor(a), torch.tensor(x0),
                                          precision=precision).numpy()
    assert ns.ns_refine_cuda.launches == before
    fp32 = ns.ns_refine_plain(torch.tensor(a), torch.tensor(x0), 2, 1,
                              precision == "split3",
                              bf16_products=False).numpy()
    assert _rel(x, ref) <= RTOL_PATH
    assert _rel(fp32, ref) <= RTOL_FP32
    for out in (x, fp32, ref):
        assert identity_error_inf(a, out) < 1e-4


@pytest.mark.parametrize("n", [192, 224])
def test_k8_band_split3_residual_is_fp64(n):
    """Past n = 128 K8's split3 residuals are float64 (as the kernel's
    cluster instance accumulates them): the CPU path is the rounds written
    out with ``residual_f64``, bit for bit, and holds the gate on the
    κ = 500 class at n = 192 and 224."""
    a, x0 = _warm_case("split3", 3, n, 1600 + n)
    at, xt = torch.tensor(a), torch.tensor(x0)
    x = ns.inverse_newton_schulz_warm(at, xt, precision="split3")
    eye = torch.eye(n)
    want = xt
    for _ in range(2):
        want = ns._mm_split3(want, 2.0 * eye - ns._mm_split3(at, want))
    want = want + ns._mm_split3(want, linalg.residual_f64(at, want))
    assert torch.equal(x, want)
    assert identity_error_inf(a, x.numpy()) < 1e-4


def _gp_case(batch, n, seed):
    """A GP system drifted by δ = 1e-3 (relative 2-norm, symmetric) from
    the one whose exact K⁻¹ is the previous timestep's; with the fp64 mean
    and variance after the drift."""
    rng = np.random.default_rng(seed)
    g = make_gp_batch(batch, n, rng)
    data = {k: g[k].astype(np.float32) for k in "abcde"}
    k0 = (data["b"].astype(np.float64)
          + np.eye(n) * data["c"][:, :, 0][:, None, :])
    kinv0 = np.linalg.inv(k0).astype(np.float32)
    data["b"] = _drifted(data["b"], 1e-3, rng, True)
    k1 = (data["b"].astype(np.float64)
          + np.eye(n) * data["c"][:, :, 0][:, None, :])
    kinv = np.linalg.inv(k1)
    at = np.transpose(data["a"], (0, 2, 1)).astype(np.float64)
    mean = (at @ kinv @ data["d"].astype(np.float64))[:, 0, 0]
    var = (data["e"] - at @ kinv @ data["a"].astype(np.float64))[:, 0, 0]
    return data, kinv0, mean, var


@pytest.mark.parametrize("n", [160, 200])
def test_k11_band_cpu_path_matches_jax_interpret(n):
    """``gp_mean_variance_fused_warm`` at n = 160 and 200 runs K11's plain
    version (no warning, no launch): mean and var within 1e-4 of JAX's warm
    kernel and of fp64; K11's fp32-product plain version within RTOL_FP32
    of JAX's refined K⁻¹, the CPU path's within RTOL_PATH."""
    data, kinv0, mean, var = _gp_case(2, n, 1700 + n)
    args = [data[k] for k in "abcde"]
    ref = [np.asarray(x) for x in pallas_gp.gp_mean_variance_fused_warm(
        *args, kinv0, block=1)]
    before = cuda_gp.gp_fused_warm_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [x.numpy() for x in cuda_gp.gp_mean_variance_fused_warm(
            *(torch.tensor(x) for x in args), torch.tensor(kinv0))]
    assert cuda_gp.gp_fused_warm_cuda.launches == before
    flat = cuda_gp._flat(*(torch.tensor(x) for x in args),
                         max_n=cuda_build.WARM_MAX_N)
    _, kinv32 = cuda_gp.gp_fused_warm_plain(*flat, torch.tensor(kinv0),
                                            bf16_products=False)
    for col, exact in ((0, mean), (1, var)):
        assert np.abs(got[col][:, 0, 0] - ref[col][:, 0, 0]).max() < 1e-4
        assert np.abs(got[col][:, 0, 0] - exact).max() < 1e-4
    assert _rel(kinv32.numpy(), ref[2]) <= RTOL_FP32
    assert _rel(got[2], ref[2]) <= RTOL_PATH
    assert got[2].shape == (2, n, n) and got[2].dtype == np.float32


@pytest.mark.parametrize("n", [129, 224])
def test_warm_band_emits_no_warning(n):
    """bf16 at the band's two ends: K8 and K11 serve them, as JAX's kernels
    do, with no warning (the cold-solve warning is for n > 224)."""
    a, x0 = _warm_case("bf16", 2, n, 1800 + n)
    data, kinv0, _, _ = _gp_case(2, n, 1900 + n)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = ns.inverse_newton_schulz_warm(torch.tensor(a), torch.tensor(x0))
        cuda_gp.gp_mean_variance_fused_warm(
            *(torch.tensor(data[k]) for k in "abcde"), torch.tensor(kinv0))
        assert InversionEngine(**CPU)._warm_buckets_for(10, n) == (
            32, 160 if n == 129 else 224)
    assert identity_error_inf(a, x.numpy()) < 1e-4


def test_warm_past_224_warns_as_jax_does():
    """n = 232, past the warm kernels: the bf16 lane warns and solves
    cold, and a bf16 engine warns in its bucketing where JAX's engine
    does; split3 refines through batched products without a warning."""
    a, x0 = _warm_case("bf16", 2, 232, 2000)
    with pytest.warns(UserWarning, match="n <= 224"):
        x = ns.inverse_newton_schulz_warm(torch.tensor(a), torch.tensor(x0))
    assert identity_error_inf(a, x.numpy()) < 1e-4
    with pytest.warns(UserWarning, match="n <= 224"):
        assert InversionEngine(**CPU)._warm_buckets_for(10, 232) == (32, 256)
    with pytest.warns(UserWarning, match="n <= 224"):
        assert jax_engine.InversionEngine()._warm_buckets_for(
            10, 232) == (32, 256)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert InversionEngine(**CPU)._warm_buckets_for(
            10, 232, True) == (32, 256)


def test_warm_wrappers_reject_past_224_before_any_launch():
    """``ns_refine_cuda`` and ``gp_fused_warm_cuda`` reject n = 225 (the
    JAX kernels' ceiling is 224) with ValueError before any launch, and
    still reject a CPU tensor inside the band."""
    a = torch.eye(225)[None]
    v = torch.ones(1, 225)
    e = torch.ones(1)
    before = (ns.ns_refine_cuda.launches, cuda_gp.gp_fused_warm_cuda.launches)
    with pytest.raises(ValueError, match="1..224"):
        ns.ns_refine_cuda(a, a, 2, 1, False)
    with pytest.raises(ValueError, match="1..224"):
        cuda_gp.gp_fused_warm_cuda(v, a, v, v, e, a)
    a = torch.eye(160)[None]
    v = torch.ones(1, 160)
    with pytest.raises(ValueError, match="float32 CUDA"):
        ns.ns_refine_cuda(a, a, 2, 1, True)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cuda_gp.gp_fused_warm_cuda(v, a, v, v, e, a)
    assert (ns.ns_refine_cuda.launches,
            cuda_gp.gp_fused_warm_cuda.launches) == before
    assert cuda_build.WARM_MAX_N == 224


@pytest.mark.parametrize("n,bucket", [(140, 160), (192, 192), (224, 224)])
def test_engine_inverse_warm_in_the_band(n, bucket):
    """A bf16 engine's warm request at n = 140, 192 and 224 is served from
    the 160, 192 and 224 buckets by K8's path with no warning, refines the
    previous inverse (the same bits as the warm lane on the padded
    batch), and passes the gate."""
    rng = np.random.default_rng(2100 + n)
    eng = InversionEngine(**CPU)
    a = make_spd_batch(3, n, rng).astype(np.float32)
    prev = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = _drifted(a, 1e-3, rng, True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = eng.inverse_warm(a2, prev)
    assert list(eng._compiled_warm) == [(8, bucket)]
    assert identity_error_inf(a2, out) < 1e-4
    pa, px = (np.tile(np.eye(bucket, dtype=np.float32), (8, 1, 1))
              for _ in range(2))
    pa[:3, :n, :n], px[:3, :n, :n] = a2, prev
    want = ns.ns_refine_plain(torch.tensor(pa), torch.tensor(px), 2, 1,
                              False).numpy()[:3, :n, :n]
    np.testing.assert_array_equal(out, want)


def test_gp_engine_warm_chain_in_the_band():
    """``GPEngine.mean_variance_warm`` at n = 192 chained over 3 drifting
    timesteps from a cold K⁻¹, with no warning: every mean and var within
    1e-4 of the fp64 closed form, every K⁻¹ through the gate."""
    rng = np.random.default_rng(2200)
    n = 192
    g = make_gp_batch(3, n, rng)
    data = {k: g[k].astype(np.float32) for k in "abcde"}
    eng = GPEngine(**CPU)
    kinv = np.linalg.inv(data["b"].astype(np.float64) + np.eye(n)
                         * data["c"][:, :, 0][:, None, :]).astype(np.float32)
    b = data["b"]
    for _ in range(3):
        b = _drifted(b, 1e-3, rng, True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mean, var, kinv = eng.mean_variance_warm(
                data["a"], b, data["c"], data["d"], data["e"], kinv)
        k = (b.astype(np.float64)
             + np.eye(n) * data["c"][:, :, 0][:, None, :])
        kinv64 = np.linalg.inv(k)
        at = np.transpose(data["a"], (0, 2, 1)).astype(np.float64)
        assert np.abs(mean - at @ kinv64 @ data["d"]).max() < 1e-4
        assert np.abs(var - (data["e"] - at @ kinv64 @ data["a"])).max() < 1e-4
        assert identity_error_inf(k.astype(np.float32), kinv) < 1e-4


def test_ns_band_probe_patches_match_the_kernel_source():
    """The card probe of the band instances (``bench/ns_band_probe.py``)
    stamps a clock split into copies of ``csrc/ns_cluster_rounds.cuh`` and
    ``ns_quad_rounds.cuh``, ``newton_schulz.cu`` and ``ns_common.cuh``,
    and reads registers and
    cluster occupancy of kernels it names: every anchor must still occur as
    often as the probe expects, every stamp id must have a phase name, the
    kernels it names must exist, and the probe refuses to run without a
    card."""
    import re

    from cuda_matrix_inversion_tpu_torch.bench import ns_band_probe

    for stamps, phases in ((ns_band_probe.BAND_STAMPS,
                            ns_band_probe.BAND_PHASES),
                           (ns_band_probe.QUAD_STAMPS,
                            ns_band_probe.QUAD_PHASES)):
        for unit, patches in stamps.items():
            text = (cuda_build.CSRC_DIR / unit).read_text()
            for anchor, new, count in patches:
                assert text.count(anchor) == count, (unit, anchor)
                for stamp_id in re.findall(r"ns_stamp\((\d+)\)", new):
                    assert int(stamp_id) == 0 or int(stamp_id) in phases
    for unit, kernels in (("newton_schulz.cu", ns_band_probe.NS_KERNELS),
                          ("gp.cu", ns_band_probe.GP_KERNELS)):
        text = (cuda_build.CSRC_DIR / unit).read_text()
        for kernel in kernels:
            assert kernel.split("<")[0] in text
    assert "band_smem_bytes" in (cuda_build.CSRC_DIR
                                 / "ns_cluster_rounds.cuh").read_text()
    with pytest.raises(SystemExit, match="CUDA device"):
        ns_band_probe.main()
