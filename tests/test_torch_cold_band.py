"""K1 and K6 at 129 ≤ n ≤ 224 against the JAX package.

The JAX kernels ``ns_vmem_iterate`` (the four fixed Newton-Schulz lanes)
and ``_gp_ns_kernel`` (the GP method ``pallas_ns``) serve n ≤ 224; the
port's K1 and K6 serve the same band, one thread-block cluster a matrix
past n = 128.  On the CPU the wrappers run their plain versions
(``ns_iterate_plain``, ``gp_fused_ns_plain``), which these tests hold
against the JAX kernels in interpret mode (every product fp32,
``block=1``).  Inputs are NumPy draws from a seed of each test, cast to
float32 (the suite runs JAX with x64 on).  Tolerances are max-norm
relative on inverses and absolute on mean and variance.
"""

import warnings

import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu.ops import newton_schulz as jax_ns
from cuda_matrix_inversion_tpu.ops import pallas_gp
from cuda_matrix_inversion_tpu.ops import schur as jax_schur
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_nonsym_cond,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp, linalg
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu_torch.ops.registry import LANES

_FIXED = ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
          "newton_schulz_pallas", "newton_schulz_pan500_pallas")
# The port's CPU path rounds its products to bf16 as the card does; JAX's
# interpret mode computes them in fp32.  Each lands within its residual
# (≲ 2e-5 on these draws) of A⁻¹, so they differ by at most K1's 2e-4
# relative; with fp32 products on both sides (bf16_products=False) only
# the order of the sums differs: 1e-5.
RTOL_PATH, RTOL_FP32 = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs in parallel workers: with PyTorch and NumPy's BLAS on
    one thread each of these small products runs at once instead of waiting
    for the worker's other threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _batch(lane, n, seed):
    """Two members of the lane's class: the general lanes' κ = 300
    nonsymmetric batches for pan500 (as ``tests/test_torch_slice.py``
    draws them past 128), the reference's SPD class for the others."""
    rng = np.random.default_rng(seed)
    if lane == "newton_schulz_pan500_pallas":
        return make_nonsym_cond(2, n, 300.0, rng)
    return make_spd_batch(2, n, rng).astype(np.float32)


@pytest.mark.parametrize("lane", _FIXED)
@pytest.mark.parametrize("n", [140, 200])
def test_k1_band_plain_matches_jax_interpret(lane, n):
    """K1's plain version with fp32 products is JAX's interpret-mode
    ``ns_vmem_iterate`` arithmetic (RTOL_FP32); the lane's CPU path (bf16
    products, as the card; split3's polish residual fp64) runs it with no
    warning and no launch, within RTOL_PATH of JAX's; all three through
    the gate."""
    a = _batch(lane, n, 3000 + n + len(lane))
    keywords = LANES[lane]["keywords"]
    ref = np.asarray(jax_ns.inverse_newton_schulz_pallas(
        a, block=1, interpret=True, **keywords))
    fp32 = ns.ns_iterate_plain(torch.tensor(a), LANES[lane]["schedule"],
                               bf16_products=False).numpy()
    before = (ns.ns_iterate_cuda.launches, ns.ns_iterate_cuda.band_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = ns.inverse_newton_schulz_fixed(torch.tensor(a),
                                           **keywords).numpy()
    assert (ns.ns_iterate_cuda.launches,
            ns.ns_iterate_cuda.band_launches) == before
    assert x.shape == a.shape and x.dtype == np.float32
    assert _rel(fp32, ref) <= RTOL_FP32
    assert _rel(x, ref) <= RTOL_PATH
    for out in (x, fp32, ref):
        assert identity_error_inf(a, out) < 1e-4


@pytest.mark.parametrize("n", [192, 224])
def test_k1_band_split3_residual_is_fp64(n):
    """Past n = 128 K1's split3 polish residuals are float64 (as the
    kernel's cluster instance accumulates them): the pan500 lane's CPU path
    is the rounds written out with ``residual_f64``, bit for bit, the same
    bits as the batched route it replaced, and holds the gate on the
    κ = 500 class at n = 192 and 224."""
    a = make_nonsym_cond(3, n, 500.0, np.random.default_rng(3100 + n))
    at = torch.tensor(a)
    lane = "newton_schulz_pan500_pallas"
    sched = LANES[lane]["schedule"]
    x = ns.inverse_newton_schulz_fixed(at, **LANES[lane]["keywords"])
    eye = torch.eye(n)
    want = ns._seed(at, "pan")
    for c in sched.coeffs:
        t = (2.0 * c) * eye - (c * c) * ns._mm_split3(at, want)
        want = ns._mm_split3(want, t)
    for _ in range(sched.hi_iters):
        want = want + ns._mm_split3(want, linalg.residual_f64(at, want))
    assert torch.equal(x, want)
    assert torch.equal(x, ns.inverse_newton_schulz_pan500_batched(at))
    assert identity_error_inf(a, x.numpy()) < 1e-4


def _gp_system(n, seed):
    g = make_gp_batch(2, n, np.random.default_rng(seed))
    return ({k: g[k].astype(np.float32) for k in "abcde"},
            g["means"][:, 0, 0], g["variances"][:, 0, 0])


@pytest.mark.parametrize("n", [160, 200])
def test_k6_band_plain_matches_jax_interpret(n, monkeypatch):
    """K6's plain version with fp32 products against JAX's interpret-mode
    ``_gp_ns_kernel``: 1e-5 on mean and var.  ``pallas_ns``'s CPU path
    runs K6's plain version (not K5's Schur route, no launch, no warning)
    within 1e-4 of the fp64 closed form."""
    data, means, variances = _gp_system(n, 3200 + n)
    args = [data[k] for k in "abcde"]
    ref = [np.asarray(x)[:, 0, 0] for x in pallas_gp.gp_mean_variance_fused_ns(
        *args, block=1, interpret=True)]
    flat = cuda_gp._flat(*(torch.tensor(x) for x in args),
                         max_n=cuda_build.WARM_MAX_N)
    fp32 = cuda_gp.gp_fused_ns_plain(*flat, bf16_products=False).numpy()
    seen = []
    plain = cuda_gp.gp_fused_ns_plain

    def spy(*xs):
        seen.append(xs[1].shape[-1])
        return plain(*xs)

    monkeypatch.setattr(cuda_gp, "gp_fused_ns_plain", spy)
    before = (cuda_gp.gp_fused_ns_cuda.launches,
              cuda_gp.gp_fused_ns_cuda.band_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [x.numpy()[:, 0, 0] for x in cuda_gp.gp_mean_variance_fused_ns(
            *(torch.tensor(x) for x in args))]
    assert seen == [n]
    assert (cuda_gp.gp_fused_ns_cuda.launches,
            cuda_gp.gp_fused_ns_cuda.band_launches) == before
    for col, exact in ((0, means), (1, variances)):
        assert np.abs(fp32[:, col] - ref[col]).max() <= RTOL_FP32
        assert np.abs(got[col] - exact).max() < 1e-4
        assert np.abs(ref[col] - exact).max() < 1e-4


def test_spd_schur_base_past_224_is_224(monkeypatch):
    """Past K1's 224 the spd lanes take the Schur recursion down to a base
    of 224, as JAX's does: at n = 320 the base runs at 128 and 192 on both
    sides (a base of 128 would split the 192 block again), and the result
    passes the gate."""
    seen = []
    plain = ns.ns_iterate_plain

    def spy(a, sched, bf16_products=True):
        seen.append(a.shape[-1])
        return plain(a, sched, bf16_products)

    monkeypatch.setattr(ns, "ns_iterate_plain", spy)
    a = make_spd_batch(2, 320, np.random.default_rng(3320)).astype(
        np.float32)
    x = ns.inverse_newton_schulz_fixed(
        torch.tensor(a), **LANES["newton_schulz_spd_pallas"]["keywords"])
    jax_seen = []

    def jax_base(block):
        jax_seen.append(block.shape[-1])
        return np.linalg.inv(np.asarray(block))

    jax_schur.spd_blocked_inverse(a, jax_base, max_base_n=224)
    assert seen == jax_seen == [128, 192]
    assert identity_error_inf(a, x.numpy()) < 1e-4


def test_k1_k6_wrappers_reject_past_224_before_any_launch():
    """``ns_iterate_cuda`` and ``gp_fused_ns_cuda`` reject n = 225 (the
    JAX kernels' ceiling is 224) with ValueError before any launch, and
    still reject a CPU tensor inside the band."""
    sched = LANES["newton_schulz_spd10_pallas"]["schedule"]
    e = torch.ones(1)
    before = (ns.ns_iterate_cuda.launches, cuda_gp.gp_fused_ns_cuda.launches)
    for n, match in ((225, "1..224"), (160, "float32 CUDA")):
        a = torch.eye(n)[None]
        v = torch.ones(1, n)
        with pytest.raises(ValueError, match=match):
            ns.ns_iterate_cuda(a, sched)
        with pytest.raises(ValueError, match=match):
            cuda_gp.gp_fused_ns_cuda(v, a, v, v, e)
    assert (ns.ns_iterate_cuda.launches,
            cuda_gp.gp_fused_ns_cuda.launches) == before
