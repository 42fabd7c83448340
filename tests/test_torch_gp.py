"""The port's GP pipeline against the JAX package: the fused kernels' plain
versions (K5, K6), every ``models.gp`` function and method, the ``.mats``
reader and GP fixture copies, and the device rules.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on).  The JAX kernels run in interpret mode, where every product is
fp32 (``mid_split=False``), with a batch block of one matrix: the block
only sets how many matrices one interpreted grid step unrolls (at least 8
by default), so the per-matrix arithmetic is the same at a fraction of the
interpret-mode compile time.  Tolerances are absolute on mean and variance
(values of order 0.1–1).
"""

import filecmp
import functools
import os

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.io import fixtures as jax_fixtures
from cuda_matrix_inversion_tpu.io import mats as jax_mats
from cuda_matrix_inversion_tpu.models import gp as jax_gp
from cuda_matrix_inversion_tpu.ops import newton_schulz as jax_ns
from cuda_matrix_inversion_tpu.ops import pallas_cholesky, pallas_gp
from cuda_matrix_inversion_tpu.ops import xla
from cuda_matrix_inversion_tpu_torch.io import fixtures, mats
from cuda_matrix_inversion_tpu_torch.models import gp
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_cholesky,
    cuda_gp,
    linalg,
    newton_schulz,
)

BATCH = 6
METHODS = ["solve", "inverse", "lu", "newton_schulz", "pallas", "pallas_ns"]
# Port against JAX: fp32 on both sides for the Cholesky/LU methods; the
# Newton-Schulz methods round their products to bf16 on the port's CPU
# path (as the card does) and not in JAX's, so each side sits within its
# own residual of K⁻¹ — bounded by the JAX test's 1e-4 against fp64.
ATOL = {"solve": 1e-5, "inverse": 1e-5, "lu": 1e-5, "pallas": 1e-5,
        "newton_schulz": 1e-4, "pallas_ns": 1e-4}


def _system(n, seed=0):
    """A GP system as ``generate_gaussian_fixtures`` draws it, float32,
    with its fp64 closed-form mean and variance."""
    g = fixtures.make_gp_batch(BATCH, n, np.random.default_rng(seed + n))
    return ({k: g[k].astype(np.float32) for k in "abcde"},
            g["means"], g["variances"])


@pytest.fixture
def jax_block1(monkeypatch):
    """The JAX models.gp methods reach their kernels through module
    attributes imported at call time; give each a batch block of one."""
    for module, name in ((pallas_gp, "gp_mean_variance_fused"),
                         (pallas_gp, "gp_mean_variance_fused_ns"),
                         (pallas_cholesky, "inverse_cholesky"),
                         (jax_ns, "inverse_newton_schulz_pallas")):
        monkeypatch.setattr(module, name,
                            functools.partial(getattr(module, name), block=1))


def _t(data, keys):
    return [torch.tensor(data[k]) for k in keys]


def _np(xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("n", [12, 16, 64])
def test_k5_plain_matches_jax(n):
    """The same factor and a two-column solve against the JAX kernel's
    W = L⁻¹ products (blocked at n = 64): 1e-5; both within 1e-4 of
    fp64."""
    data, means, variances = _system(n)
    ref = _np(pallas_gp.gp_mean_variance_fused(*(data[k] for k in "abcde"),
                                               block=1))
    got = _np(cuda_gp.gp_mean_variance_fused(*_t(data, "abcde")))
    for g, r, exact in zip(got, ref, (means, variances)):
        assert g.shape == (BATCH, 1, 1) and g.dtype == np.float32
        assert np.abs(g - r).max() <= 1e-5
        assert np.abs(g - exact).max() < 1e-4
        assert np.abs(r - exact).max() < 1e-4


@pytest.mark.parametrize("n", [12, 16, 64])
def test_k6_plain_matches_jax(n):
    """fp32 products (bf16_products=False) are the JAX kernel's
    interpret-mode arithmetic: 1e-5.  The port's CPU path (bf16 products,
    as the card) is held to the fp32 path within K1's 2e-4 relative and to
    fp64 within the JAX test's 1e-4."""
    data, means, variances = _system(n)
    ref = _np(pallas_gp.gp_mean_variance_fused_ns(
        *(data[k] for k in "abcde"), block=1))
    flat = cuda_gp._flat(*_t(data, "abcde"))
    fp32 = cuda_gp.gp_fused_ns_plain(*flat, bf16_products=False).numpy()
    bf16 = _np(cuda_gp.gp_mean_variance_fused_ns(*_t(data, "abcde")))
    for col, (g, r, exact) in enumerate(zip(bf16, ref, (means, variances))):
        assert np.abs(fp32[:, col] - r[:, 0, 0]).max() <= 1e-5
        rel = np.abs(g[:, 0, 0] - fp32[:, col]).max() / np.abs(r).max()
        assert rel <= 2e-4
        assert np.abs(g - exact).max() < 1e-4
        assert np.abs(r - exact).max() < 1e-4


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [16, 64])
def test_gp_mean_variance_matches_jax(n, method, jax_block1):
    data, means, variances = _system(n)
    ref = _np(jax_gp.gp_mean_variance(*(data[k] for k in "abcde"),
                                      method=method))
    got = _np(gp.gp_mean_variance(*_t(data, "abcde"), method=method))
    for g, r, exact in zip(got, ref, (means, variances)):
        assert g.shape == (BATCH, 1, 1) and g.dtype == np.float32
        assert np.abs(g - r).max() <= ATOL[method]
        assert np.abs(g - exact).max() < 1e-4


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [16, 64])
def test_gp_mean_and_variance_match_jax(n, method, jax_block1):
    data, means, variances = _system(n)
    a, b, c, d, e = (data[k] for k in "abcde")
    mean = gp.gp_mean(*_t(data, "abcd"), method=method).numpy()
    var = gp.gp_variance(*_t(data, "abce"), method=method).numpy()
    for g, r, exact in ((mean, jax_gp.gp_mean(a, b, c, d, method=method),
                         means),
                        (var, jax_gp.gp_variance(a, b, c, e, method=method),
                         variances)):
        assert g.shape == (BATCH, 1, 1)
        assert np.abs(g - np.asarray(r)).max() <= ATOL[method]
        assert np.abs(g - exact).max() < 1e-4


@pytest.mark.parametrize("method", ["solve", "pallas"])
def test_gp_multi_and_lml_match_jax(method, jax_block1):
    """m = 3 test points per system through one factorization, and the log
    marginal likelihood (library Cholesky on both sides): 1e-5 and 1e-4
    (values of order −1e2)."""
    rng = np.random.default_rng(31)
    data, _, _ = _system(16)
    a = rng.random((BATCH, 16, 3)).astype(np.float32)
    e = rng.random((BATCH, 3, 1)).astype(np.float32)
    b, c, d = data["b"], data["c"], data["d"]
    ref = _np(jax_gp.gp_mean_variance_multi(a, b, c, d, e, method=method))
    got = _np(gp.gp_mean_variance_multi(
        *(torch.tensor(x) for x in (a, b, c, d, e)), method=method))
    for g, r in zip(got, ref):
        assert g.shape == (BATCH, 3, 1)
        assert np.abs(g - r).max() <= 1e-5
    ref = np.asarray(jax_gp.gp_log_marginal_likelihood(b, c, d))
    got = gp.gp_log_marginal_likelihood(*(torch.tensor(x) for x in (b, c, d)))
    assert got.shape == (BATCH,) and np.abs(got.numpy() - ref).max() <= 1e-4


def test_host_wrappers_and_f64_route(jax_block1):
    """NumPy in, NumPy out on device="cpu"; float64 stays float64 on the
    library route and agrees with the JAX f64 route to 1e-12."""
    g = fixtures.make_gp_batch(4, 12, np.random.default_rng(8))
    a, b, c, d, e = (g[k] for k in "abcde")
    for method in ("pallas", "pallas_ns"):
        mean, var = gp.gp_mean_variance_host(a, b, c, d, e, method=method,
                                             device="cpu")
        assert mean.dtype == np.float64
        rm, rv = _np(jax_gp.gp_mean_variance(a, b, c, d, e, method=method))
        assert np.abs(mean - rm).max() < 1e-12
        assert np.abs(var - rv).max() < 1e-12
    f32 = [x.astype(np.float32) for x in (a, b, c, d, e)]
    mean = gp.gp_mean_host(*f32[:4], method="pallas", device="cpu")
    var = gp.gp_variance_host(*f32[:3], f32[4], method="pallas_ns",
                              device="cpu")
    assert isinstance(mean, np.ndarray) and mean.dtype == np.float32
    assert np.abs(mean - g["means"]).max() < 1e-4
    assert np.abs(var - g["variances"]).max() < 1e-4
    with pytest.raises(ValueError, match="unknown method"):
        gp.gp_mean(*(torch.tensor(x) for x in f32[:4]), method="qr")


def test_k5_schur_route_past_128():
    """n = 160 > 128: K = B + diag(c) solved through spd_schur_solve on
    the K3 plain base; K6 routes to it too."""
    data, means, variances = _system(160)
    for fn in (cuda_gp.gp_mean_variance_fused,
               cuda_gp.gp_mean_variance_fused_ns):
        mean, var = _np(fn(*_t(data, "abcde")))
        assert mean.shape == (BATCH, 1, 1)
        assert np.abs(mean - means).max() < 1e-4
        assert np.abs(var - variances).max() < 1e-4


def test_indefinite_system_is_confined():
    """A negative definite K in one system: only that system comes out
    non-finite, in both fused methods; the others are unchanged."""
    data, _, _ = _system(20)
    bad = dict(data)
    bad["b"] = data["b"].copy()
    bad["b"][2] = -bad["b"][2]
    for method in ("pallas", "pallas_ns"):
        good = _np(gp.gp_mean_variance(*_t(data, "abcde"), method=method))
        got = _np(gp.gp_mean_variance(*_t(bad, "abcde"), method=method))
        for g, ok in zip(got, good):
            finite = np.isfinite(g[:, 0, 0])
            assert finite.tolist() == [True, True, False, True, True, True]
            np.testing.assert_array_equal(g[finite], ok[finite])


def test_cpu_tensors_launch_no_kernel_and_cuda_raises():
    for fn in (cuda_cholesky.cholesky_cuda,
               cuda_cholesky.inverse_cholesky_cuda,
               cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_ns_cuda,
               newton_schulz.ns_iterate_cuda):
        fn.launches = 0
    data, _, _ = _system(16)
    for method in METHODS:
        gp.gp_mean_variance(*_t(data, "abcde"), method=method)
        gp.gp_mean(*_t(data, "abcd"), method=method)
    cuda_cholesky.cholesky(torch.tensor(data["b"]))
    for fn in (cuda_cholesky.cholesky_cuda,
               cuda_cholesky.inverse_cholesky_cuda,
               cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_ns_cuda,
               newton_schulz.ns_iterate_cuda):
        assert fn.launches == 0
    with pytest.raises(ValueError, match="float32 CUDA"):
        cuda_gp.gp_fused_cuda(*cuda_gp._flat(*_t(data, "abcde")))
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gp.gp_mean_variance_host(*(data[k] for k in "abcde"),
                                 method="pallas", device="cuda")


def test_gaussian_fixture_through_port_reader(fixture_root):
    """The JAX-generated gaussian_20_16x16 set read by the port's
    ``read_test_folder`` (identical arrays to the JAX reader), then both
    fused methods against its means.mats / variances.mats."""
    folder = os.path.join(fixture_root, "gaussian_20_16x16")
    data = mats.read_test_folder(folder, dtype=np.float32)
    ref = jax_mats.read_test_folder(folder, dtype=np.float32)
    assert sorted(data) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(data[k], ref[k])
    for method in ("pallas", "pallas_ns"):
        mean, var = gp.gp_mean_variance_host(*(data[k] for k in "abcde"),
                                             method=method, device="cpu")
        assert np.abs(mean - data["means"]).max() < 1e-4
        assert np.abs(var - data["variances"]).max() < 1e-4
    inv = mats.read_test_folder(os.path.join(fixture_root,
                                             "inverse_20_8x8"))
    assert inv["a"].dtype == np.float32 and inv["aInv"].shape == (20, 8, 8)


def test_mats_copy_matches_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((3, 4, 5))
    mats.write_mats(str(tmp_path / "port.mats"), arr)
    jax_mats.write_mats(str(tmp_path / "jax.mats"), arr)
    assert filecmp.cmp(tmp_path / "port.mats", tmp_path / "jax.mats",
                       shallow=False)
    for dtype in (np.float32, np.float64):
        got = mats.read_mats(str(tmp_path / "jax.mats"), dtype=dtype)
        np.testing.assert_array_equal(
            got, jax_mats.read_mats(str(tmp_path / "jax.mats"), dtype=dtype))
    assert mats.read_mats(str(tmp_path / "jax.mats")).dtype == np.float32
    (tmp_path / "bad.mats").write_text("1\t2\t2\n1.0\t2.0\t3.0\n")
    with pytest.raises(ValueError, match="expected 4 values"):
        mats.read_mats(str(tmp_path / "bad.mats"))
    with pytest.raises(ValueError, match="unknown fixture kind"):
        mats.read_test_folder(str(tmp_path), kind="qr")


def test_gaussian_fixture_copy_matches_jax_package(tmp_path):
    fixtures.generate_gaussian_fixtures(str(tmp_path / "port"), 8, num=5,
                                        seed=3)
    jax_fixtures.generate_gaussian_fixtures(str(tmp_path / "jax"), 8, num=5,
                                            seed=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 7
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False)


def test_linalg_additions_match_jax():
    rng = np.random.default_rng(6)
    b = fixtures.make_spd_batch(3, 10, rng).astype(np.float32)
    c = rng.random((3, 10, 1)).astype(np.float32)
    for cv in (c, c[..., 0]):
        np.testing.assert_array_equal(
            linalg.add_diagonal(torch.tensor(b), torch.tensor(cv)).numpy(),
            np.asarray(xla.add_diagonal(b, cv)))
    got = linalg.spd_logdet(torch.tensor(b)).numpy()
    assert np.abs(got - np.asarray(xla.spd_logdet(b))).max() <= 1e-4
    g = rng.standard_normal((4, 6, 6)).astype(np.float32)
    sign, logdet = linalg.lu_logdet(torch.tensor(g))
    rs, rl = xla.lu_logdet(g)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(rs))
    assert np.abs(logdet.numpy() - np.asarray(rl)).max() <= 1e-5


# ---- K11: the warm fused GP ----

def _warm_chain(n, seed):
    """A GP system, JAX's warm step from a cold K⁻¹ (step 0), and the
    system after a drift of B by δ = 1e-3 (relative 2-norm, symmetric).
    Returns (step-1 inputs, JAX's step-0 K⁻¹, fp64 mean and var at step 1):
    the state a serving loop carries across is JAX's own."""
    rng = np.random.default_rng(seed)
    data, _, _ = _system(n, seed)
    k0 = (data["b"].astype(np.float64)
          + np.eye(n) * data["c"][:, :, 0][:, None, :])
    kinv0 = np.linalg.inv(k0).astype(np.float32)
    _, _, kinv1 = pallas_gp.gp_mean_variance_fused_warm(
        *(data[k] for k in "abcde"), kinv0, block=1)
    noise = rng.standard_normal(data["b"].shape)
    noise = (noise + np.transpose(noise, (0, 2, 1))) / 2
    scale = (np.linalg.norm(data["b"], 2, axis=(1, 2))
             / np.linalg.norm(noise, 2, axis=(1, 2)))[:, None, None]
    step1 = dict(data, b=(data["b"] + 1e-3 * scale * noise).astype(np.float32))
    k1 = (step1["b"].astype(np.float64)
          + np.eye(n) * step1["c"][:, :, 0][:, None, :])
    kinv = np.linalg.inv(k1)
    at = np.transpose(step1["a"], (0, 2, 1)).astype(np.float64)
    means = at @ kinv @ step1["d"].astype(np.float64)
    variances = step1["e"] - at @ kinv @ step1["a"].astype(np.float64)
    return step1, np.asarray(kinv1), means, variances


@pytest.mark.parametrize("n,lo,hi", [
    pytest.param(12, 2, 1, id="12"), pytest.param(16, 2, 1, id="16"),
    pytest.param(64, 2, 1, id="64"), pytest.param(16, 0, 1, id="16-lo0-hi1"),
    pytest.param(16, 1, 2, id="16-lo1-hi2")])
def test_k11_plain_matches_jax(n, lo, hi):
    """From JAX's own previous K⁻¹: the fp32 plain version (the JAX
    kernel's interpret-mode arithmetic) within 1e-5 of JAX on mean and var
    and 1e-5 relative on the refined K⁻¹; the port's bf16 path within
    K1's 2e-4 relative of it; both within 1e-4 of fp64 and the refined K⁻¹
    under the gate.  (lo, hi) = (2, 1) is the default schedule; (0, 1) is
    one fp32 polish round alone, and (1, 2) puts a split-residual polish
    round before it."""
    data, kinv0, means, variances = _warm_chain(n, 40 + n)
    args = [data[k] for k in "abcde"]
    ref = _np(pallas_gp.gp_mean_variance_fused_warm(
        *args, kinv0, lo_iters=lo, hi_iters=hi, block=1))
    flat = cuda_gp._flat(*_t(data, "abcde"))
    out32, kinv32 = cuda_gp.gp_fused_warm_plain(*flat, torch.tensor(kinv0),
                                                lo, hi, bf16_products=False)
    got = _np(cuda_gp.gp_mean_variance_fused_warm(
        *_t(data, "abcde"), torch.tensor(kinv0), lo_iters=lo, hi_iters=hi))
    for col, exact in enumerate((means, variances)):
        assert np.abs(out32[:, col].numpy() - ref[col][:, 0, 0]).max() <= 1e-5
        rel = (np.abs(got[col][:, 0, 0] - out32[:, col].numpy()).max()
               / np.abs(ref[col]).max())
        assert rel <= 2e-4
        assert np.abs(got[col] - exact).max() < 1e-4
        assert np.abs(ref[col] - exact).max() < 1e-4
    assert np.abs(kinv32.numpy() - ref[2]).max() / np.abs(ref[2]).max() <= 1e-5
    assert got[2].shape == (BATCH, n, n) and got[2].dtype == np.float32
    k = linalg.add_diagonal(torch.tensor(data["b"]),
                            torch.tensor(data["c"])).numpy()
    assert np.abs(k.astype(np.float64) @ got[2] - np.eye(n)).sum(-1).max() < 1e-4


def test_k11_route_past_128_and_validation():
    """n = 140: mean and var by K5's route, K⁻¹ by the warm NS route,
    which warns and solves cold past the kernel's 128; a prev_kinv of the
    wrong shape raises; CPU tensors launch no kernel."""
    cuda_gp.gp_fused_warm_cuda.launches = 0
    data, kinv0, means, variances = _warm_chain(140, 3)
    with pytest.warns(UserWarning, match="cold adaptive solve"):
        mean, var, kinv = _np(cuda_gp.gp_mean_variance_fused_warm(
            *_t(data, "abcde"), torch.tensor(kinv0)))
    assert np.abs(mean - means).max() < 1e-4
    assert np.abs(var - variances).max() < 1e-4
    assert kinv.shape == (BATCH, 140, 140)
    assert cuda_gp.gp_fused_warm_cuda.launches == 0
    with pytest.raises(ValueError, match="prev_kinv"):
        cuda_gp.gp_mean_variance_fused_warm(*_t(data, "abcde"),
                                            torch.tensor(kinv0)[:2])
    small, k0, _, _ = _warm_chain(8, 4)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cuda_gp.gp_fused_warm_cuda(*cuda_gp._flat(*_t(small, "abcde")),
                                   torch.tensor(k0))


def test_gp_ns_probe_patches_match_the_kernel_source():
    """The card probe of K6 and K11 (``bench/gp_ns_probe.py``) builds its
    variants by patching ``csrc/gp.cu`` and the round loop K6 and K11
    share with K1 and K8 (``csrc/ns_mma_rounds.cuh``): every anchor must
    still occur as often as the probe expects, and the probe refuses to
    run without a card."""
    from cuda_matrix_inversion_tpu_torch.bench import gp_ns_probe
    from cuda_matrix_inversion_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "gp.cu").read_text()
    assert src.count(gp_ns_probe.DIRECT) == 1
    assert set(gp_ns_probe.STAMPS) == {"gp.cu", "ns_mma_rounds.cuh",
                                       "ns_common.cuh"}
    for unit, patches in gp_ns_probe.STAMPS.items():
        text = (cuda_build.CSRC_DIR / unit).read_text()
        for anchor, _, count in patches:
            assert text.count(anchor) == count, (unit, anchor)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            gp_ns_probe.main()
