"""The port's Newton-Schulz module against the JAX package.

Same NumPy inputs (cast to float32 explicitly: the suite runs JAX with x64
on, and float64 would send the JAX functions down their f64 routes) go
through the JAX function, in interpret mode as its own suite runs it, and
through the port.  Tolerances are max-norm relative differences.
"""

import struct
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch, make_square_batch
from cuda_matrix_inversion_tpu.ops import newton_schulz as jax_ns
from cuda_matrix_inversion_tpu.ops import registry as jax_registry
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_nonsym_cond
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu_torch.ops.registry import LANES, build_lane_table

_FIXED = ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
          "newton_schulz_pallas", "newton_schulz_pan500_pallas")


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _make_cond(batch, n, kappa, rng):
    """SPD batch with eigenvalues logspaced over [1/κ, 1]."""
    q, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    lam = np.logspace(0, -np.log10(kappa), n)
    return ((q * lam[None, None, :]) @ np.transpose(q, (0, 2, 1))
            ).astype(np.float32)


def _nonsym_cond(batch, n, kappa, rng):
    """Nonsymmetric batch with 2-norm condition number κ."""
    q1, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    s = np.geomspace(1.0 / kappa, 1.0, n)
    return ((q1 * s[None, None, :]) @ q2).astype(np.float32)


def _bits(xs):
    return [struct.pack("<d", float(x)) for x in xs]


@pytest.mark.parametrize("name", [
    "SPD_SCHEDULE", "PAN_SCHEDULE", "PAN500_SCHEDULE", "MU_MIN_SPD",
    "MU_MIN_PAN", "MU_MIN_PAN500", "SPLIT3_NOISE_FLOOR"])
def test_schedule_constants_are_the_jax_packages(name):
    assert getattr(ns, name) == getattr(jax_ns, name)
    assert type(getattr(ns, name)) is type(getattr(jax_ns, name))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_lane_table_from_jax_registry(lane):
    """The lane table built from the JAX registry's partial keywords is
    the port's built-in one, and each fixed lane's per-round scalars equal
    JAX's scaled_round_coeffs bit for bit."""
    fn = jax_registry.get_inverse_algorithm(lane)
    # floats handed over as NumPy scalars, as a table read from data would be
    keywords = {k: np.asarray(v)[()] if isinstance(v, float) else v
                for k, v in getattr(fn, "keywords", {}).items()}
    assert build_lane_table({lane: keywords}) == {lane: LANES[lane]}
    sched = LANES[lane]["schedule"]
    if sched is None:
        return
    split3 = keywords.get("precision") == "split3"
    spd = keywords.get("init") == "spd"
    schedule = (jax_ns.PAN500_SCHEDULE if split3
                else jax_ns.SPD_SCHEDULE if spd else jax_ns.PAN_SCHEDULE)
    mu = keywords.get("mu_min", jax_ns.MU_MIN_PAN500 if split3
                      else jax_ns.MU_MIN_SPD if spd else jax_ns.MU_MIN_PAN)
    lo = keywords.get("lo_iters", schedule[0])
    ref = jax_ns.scaled_round_coeffs(
        float(mu), lo, noise_floor=jax_ns.SPLIT3_NOISE_FLOOR if split3
        else 5e-3)
    assert _bits(sched.coeffs) == _bits(ref)
    assert (sched.lo_iters, sched.hi_iters) == (
        lo, keywords.get("hi_iters", schedule[1]))


@pytest.mark.parametrize("mu_min,rounds,floor", [
    (2e-5, 12, 5e-3), (0.01, 6, 5e-3), (0.03, 4, 5e-3), (3e-8, 14, 2e-4),
    (0.5, 3, 5e-3)])
def test_scaled_round_coeffs_bitwise(mu_min, rounds, floor):
    assert _bits(ns.scaled_round_coeffs(mu_min, rounds, floor)) == _bits(
        jax_ns.scaled_round_coeffs(mu_min, rounds, noise_floor=floor))


@pytest.mark.parametrize("lane,n", [
    ("newton_schulz_spd_pallas", 32), ("newton_schulz_spd10_pallas", 32),
    ("newton_schulz_pallas", 32), ("newton_schulz_pan500_pallas", 64)])
def test_plain_fp32_matches_jax_interpret(lane, n):
    """bf16_products=False is the JAX reference's interpret-mode arithmetic
    (every product fp32).  Same operations up to summation order; the
    iteration corrects itself: 1e-5 on the SPD lanes (κ ≤ 30), 1e-4 on
    pan500 at κ = 500 (κ·ε₃₂ ≈ 3e-5)."""
    rng = np.random.default_rng(n + len(lane))
    if lane == "newton_schulz_pan500_pallas":
        a, rtol = _nonsym_cond(4, n, 500.0, rng), 1e-4
    else:
        a, rtol = make_spd_batch(4, n, rng).astype(np.float32), 1e-5
    ref = np.asarray(jax_registry.get_inverse_algorithm(lane)(a))
    x = ns.ns_iterate_plain(torch.tensor(a), LANES[lane]["schedule"],
                            bf16_products=False).numpy()
    assert _rel(x, ref) <= rtol
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < 1e-4


def _emulate_k1(a, sched):
    """Faithful-bf16 NumPy emulation of K1 (ml_dtypes rounding, fp32
    accumulation), as tests/test_pallas_kernels.py emulates the TPU."""
    f32 = np.float32

    def r32(x):
        return x.astype(ml_dtypes.bfloat16).astype(f32)

    def one(x, y):
        return np.einsum("bij,bjk->bik", r32(x).astype(np.float64),
                         r32(y).astype(np.float64)).astype(f32)

    def dot3(x, y):
        xl, yl = (x - r32(x)).astype(f32), (y - r32(y)).astype(f32)
        return (one(x, y) + one(xl, y) + one(x, yl)).astype(f32)

    def full(x, y):
        return np.einsum("bij,bjk->bik", x.astype(np.float64),
                         y.astype(np.float64)).astype(f32)

    eye = np.eye(a.shape[-1], dtype=f32)
    r_inf = np.abs(a).sum(axis=2).max(axis=1)
    if sched.init == "spd":
        s = (f32(1) / r_inf)[:, None, None]
        x = (f32(2) * s) * eye - (s * s) * a
    else:
        c_1 = np.abs(a).sum(axis=1).max(axis=1)
        x = np.swapaxes(a, 1, 2) * (f32(1) / (r_inf * c_1))[:, None, None]
    contract = dot3 if sched.split3 else one
    for c in sched.coeffs:
        x = contract(x, f32(2 * c) * eye - f32(c * c) * contract(a, x))
    for i in range(sched.hi_iters):
        if sched.split3:
            x = x + dot3(x, eye - full(a, x))
        else:
            final = i == sched.hi_iters - 1 and sched.polish_highest
            x = x + one(x, eye - (full(a, x) if final else dot3(a, x)))
    return x


@pytest.mark.parametrize("lane,kappa", [
    ("newton_schulz_spd_pallas", 30.0), ("newton_schulz_spd10_pallas", 10.0),
    ("newton_schulz_pallas", 30.0), ("newton_schulz_pan500_pallas", 500.0)])
def test_bf16_plain_holds_gate_at_domain_edge(lane, kappa):
    """bf16_products=True (the card's arithmetic) at each lane's κ edge,
    n = 64: the gate holds, and the result agrees within 2e-4 with the
    NumPy faithful-bf16 emulation (both residuals sit near 2e-5; their
    difference is bounded by the sum)."""
    rng = np.random.default_rng(int(kappa))
    a = (_nonsym_cond(4, 64, kappa, rng) if "pan500" in lane
         else _make_cond(4, 64, kappa, rng))
    sched = LANES[lane]["schedule"]
    x = ns.ns_iterate_plain(torch.tensor(a), sched, bf16_products=True).numpy()
    emu = _emulate_k1(a, sched)
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, emu) < 1e-4
    assert _rel(x, emu) <= 2e-4


@pytest.mark.parametrize("lane", _FIXED)
def test_scaled_identity_does_not_diverge(lane):
    """3.7·I: the whole spectrum sits at the top of the tracked interval,
    the divergence class the noise-floor clamp exists for."""
    a = (np.eye(64, dtype=np.float32)[None].repeat(8, axis=0) * 3.7)
    x = ns.inverse_newton_schulz_fixed(torch.tensor(a),
                                       **LANES[lane]["keywords"]).numpy()
    assert identity_error_inf(a, x) < 1e-4


def test_adaptive_near_identity_matches_jax():
    """The 0.01-perturbed identity through the adaptive loop: its start has
    residual < 1, which must not trip the strict-decrease guard."""
    rng = np.random.default_rng(16)
    n = 16
    a = rng.standard_normal((5, n, n)).astype(np.float32) * 0.01
    a = (a + np.transpose(a, (0, 2, 1))) / 2 + np.eye(n, dtype=np.float32)
    x = ns.inverse_newton_schulz(torch.tensor(a)).numpy()
    ref = np.asarray(jax_ns.inverse_newton_schulz(a))
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, ref) <= 2e-4


def test_fixed_lane_validation_and_f64_route():
    a = torch.tensor(make_spd_batch(2, 8, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="precision"):
        ns.inverse_newton_schulz_fixed(a.float(), precision="fp8")
    with pytest.raises(ValueError, match="pan"):
        ns.inverse_newton_schulz_fixed(a.float(), init="spd",
                                       precision="split3")
    with pytest.raises(ValueError, match="polish_highest"):
        ns.inverse_newton_schulz_fixed(a.float(), precision="split3",
                                       polish_highest=False)
    with pytest.raises(ValueError, match="init"):
        ns.inverse_newton_schulz(a.float(), init="eye")
    with pytest.warns(UserWarning, match="split3.*float64"):
        x = ns.inverse_newton_schulz_fixed(a, precision="split3")
    assert x.dtype == torch.float64
    assert identity_error_inf(a.numpy(), x.numpy()) < 1e-8


def test_polish_highest_false_uses_split_residual():
    """polish_highest=False makes the last polish residual the 3-pass
    split too; on a well-conditioned batch it still holds the gate."""
    a = make_spd_batch(4, 32, np.random.default_rng(5)).astype(np.float32)
    sched = ns.resolve_schedule(init="spd", polish_highest=False)
    x = ns.ns_iterate_plain(torch.tensor(a), sched).numpy()
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, _emulate_k1(a, sched)) <= 2e-4


@pytest.mark.parametrize("lane", _FIXED)
def test_fixed_lanes_past_128_match_jax_routes(lane):
    """n = 256, past K1's 128 and JAX's 224: both take JAX's routes — the
    spd lanes the Schur recursion (128/128 on both sides, onto the kernel's
    bf16 plain version here and JAX's interpreted fp32 kernel), pan500 the
    split3 batched lane (bf16 splits here, fp32 on JAX's CPU), pan the
    adaptive loop.  ≤ 2e-4 relative, as at n ≤ 128, and the gate; JAX's
    pan500 polish (fp32 residual) sits on the CPU's floor at κ = 500 here
    (1.2e-4), the port's (fp64 residual) under the gate."""
    rng = np.random.default_rng(256)
    if lane == "newton_schulz_pan500_pallas":
        a = _nonsym_cond(2, 256, 500.0, rng)
    else:
        a = make_spd_batch(2, 256, rng).astype(np.float32)
    ref = np.asarray(jax_registry.get_inverse_algorithm(lane)(a))
    before = ns.ns_iterate_cuda.launches
    x = ns.inverse_newton_schulz_fixed(torch.tensor(a),
                                       **LANES[lane]["keywords"]).numpy()
    assert ns.ns_iterate_cuda.launches == before
    assert x.shape == a.shape and x.dtype == np.float32
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < (1.3e-4 if "pan500" in lane
                                         else 1e-4)
    assert _rel(x, ref) <= 2e-4


def test_spd10_schedule_reaches_the_schur_base(monkeypatch):
    """Every schedule keyword of the spd10 lane (mu_min = 0.03 with 4 + 2
    rounds) reaches the Schur base past 128; dropping one would run the
    base on the spd defaults."""
    seen = []
    plain = ns.ns_iterate_plain

    def spy(a, sched, bf16_products=True):
        seen.append((a.shape[-1], sched))
        return plain(a, sched, bf16_products)

    monkeypatch.setattr(ns, "ns_iterate_plain", spy)
    a = make_spd_batch(2, 256, np.random.default_rng(10)).astype(np.float32)
    lane = LANES["newton_schulz_spd10_pallas"]
    x = ns.inverse_newton_schulz_fixed(torch.tensor(a), **lane["keywords"])
    assert identity_error_inf(a, x.numpy()) < 1e-4
    assert [n for n, _ in seen] == [128, 128]
    assert all(sched == lane["schedule"] for _, sched in seen)
    assert lane["schedule"] != LANES["newton_schulz_spd_pallas"]["schedule"]


def test_pan500_batched_is_k1s_split3_arithmetic():
    """The split3 lane's batched route repeats K1's plain split3 lo rounds
    (the JAX XLA lane runs the kernel's schedule at HIGH), then polishes
    with fp64 residuals; its κ = 500 result at n = 256 passes the gate
    where the fp32-residual polish (K1's own) does not on this CPU.
    float64 goes to the LU route."""
    a = _nonsym_cond(2, 24, 300.0, np.random.default_rng(11))
    sched = LANES["newton_schulz_pan500_pallas"]["schedule"]
    at = torch.tensor(a)
    x = ns.inverse_newton_schulz_pan500_batched(at)
    lo = ns._rounds(at, ns._seed(at, "pan"), sched.coeffs, 0, True, True,
                    True)
    for _ in range(sched.hi_iters):
        lo = lo + ns._mm_split3(lo, ns.residual_f64(at, lo))
    assert torch.equal(x, lo)
    big = _nonsym_cond(4, 256, 500.0, np.random.default_rng(41))
    x = ns.inverse_newton_schulz_pan500_batched(torch.tensor(big)).numpy()
    assert identity_error_inf(big, x) < 1e-4
    fp32 = ns.ns_iterate_plain(torch.tensor(big), sched).numpy()
    assert identity_error_inf(big, fp32) > 1e-4
    a64 = torch.tensor(a.astype(np.float64))
    assert torch.equal(ns.inverse_newton_schulz_pan500_batched(a64),
                       ns.inverse_lu(a64))


# ---- K8: warm-start refinement ----

def _drifted(a, delta, rng, symmetric):
    """``a`` plus a Gaussian perturbation of relative 2-norm δ (symmetrised
    for SPD input), float32."""
    noise = rng.standard_normal(a.shape)
    if symmetric:
        noise = (noise + np.transpose(noise, (0, 2, 1))) / 2
    scale = (np.linalg.norm(a, 2, axis=(1, 2))
             / np.linalg.norm(noise, 2, axis=(1, 2)))[:, None, None]
    return (a + delta * scale * noise).astype(np.float32)


def _warm_case(precision, n, seed):
    """(a, x0): a drifted batch and JAX's own cold inverse of the batch
    before the drift (the state a serving loop carries across).  bf16: the
    reference's SPD class (``make_spd_batch``, κ ≈ 2–3) drifted by δ = 1e-3;
    split3: a nonsymmetric κ = 300 batch drifted by δ = 5e-4 (δ·κ = 0.15)."""
    rng = np.random.default_rng(seed)
    if precision == "bf16":
        a0 = make_spd_batch(4, n, rng).astype(np.float32)
        x0 = jax_ns.inverse_newton_schulz_pallas(a0, init="spd", block=1)
        return _drifted(a0, 1e-3, rng, True), np.asarray(x0)
    a0 = _nonsym_cond(4, n, 300.0, rng)
    x0 = jax_ns.inverse_newton_schulz_pallas(a0, precision="split3", block=1)
    return _drifted(a0, 5e-4, rng, False), np.asarray(x0)


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [16, 48])
def test_warm_plain_fp32_matches_jax_interpret(precision, n):
    """K8's plain version with fp32 products (bf16_products=False) is the
    JAX warm kernel's interpret-mode arithmetic: 1e-5 relative, from the
    same X0 (JAX's previous inverse), and both under the gate."""
    a, x0 = _warm_case(precision, n, n + len(precision))
    ref = np.asarray(jax_ns.inverse_newton_schulz_warm(
        a, x0, block=1, precision=precision))
    x = ns.ns_refine_plain(torch.tensor(a), torch.tensor(x0), 2, 1,
                           precision == "split3", bf16_products=False).numpy()
    assert _rel(x, ref) <= 1e-5
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < 1e-4


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [16, 48])
def test_warm_bf16_products_hold_gate(precision, n):
    """The card's arithmetic (bf16_products=True, through
    ``inverse_newton_schulz_warm``) on the same drifted batches: the fp64
    gate holds (the TPU ledger's warm edge on this SPD class is 5.93e-5 at
    16×128), and the result is within 2e-4 relative of the fp32 path (K1's
    bound: each sits within its residual of A⁻¹)."""
    a, x0 = _warm_case(precision, n, n + len(precision))
    x = ns.inverse_newton_schulz_warm(torch.tensor(a), torch.tensor(x0),
                                      precision=precision).numpy()
    fp32 = ns.ns_refine_plain(torch.tensor(a), torch.tensor(x0), 2, 1,
                              precision == "split3",
                              bf16_products=False).numpy()
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, fp32) <= 2e-4


@pytest.mark.parametrize("kappa", [30.0, 300.0])
def test_warm_split3_where_bf16_stalls(kappa):
    """At κ = 30 (SPD) and κ = 300 (nonsymmetric), δ·κ = 0.15: split3
    recovers the gate, and the bf16 lane does not — its one-pass products
    carry 2⁻⁹·κ·‖R‖ (measured ≈ 1e-3 at κ = 30, ≈ 4e-2 at κ = 300), which
    is why the pan500 engine refines through split3."""
    rng = np.random.default_rng(int(kappa))
    a0 = (_make_cond(4, 48, kappa, rng) if kappa < 100
          else _nonsym_cond(4, 48, kappa, rng))
    x0 = np.linalg.inv(a0.astype(np.float64)).astype(np.float32)
    a = _drifted(a0, 0.15 / kappa, rng, kappa < 100)
    at, xt = torch.tensor(a), torch.tensor(x0)
    split3 = ns.inverse_newton_schulz_warm(at, xt, precision="split3")
    bf16 = ns.inverse_newton_schulz_warm(at, xt, precision="bf16")
    assert identity_error_inf(a, split3.numpy()) < 1e-4
    assert identity_error_inf(a, bf16.numpy()) > 1e-4


def test_warm_routes_past_128_and_f64():
    """n = 140 > the kernel's 128: split3 refines through batched products
    with one extra polish and no warning (JAX's route past its 224); bf16
    warns and solves cold.  float64 takes the adaptive route."""
    rng = np.random.default_rng(140)
    a0 = make_square_batch(2, 140, rng).astype(np.float32)
    x0 = np.linalg.inv(a0.astype(np.float64)).astype(np.float32)
    a = _drifted(a0, 1e-4, rng, False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = ns.inverse_newton_schulz_warm(torch.tensor(a), torch.tensor(x0),
                                          precision="split3")
    assert identity_error_inf(a, x.numpy()) < 1e-4
    spd = make_spd_batch(2, 140, rng).astype(np.float32)
    with pytest.warns(UserWarning, match="cold adaptive solve"):
        x = ns.inverse_newton_schulz_warm(torch.tensor(spd),
                                          torch.tensor(spd))
    assert identity_error_inf(spd, x.numpy()) < 1e-4
    a64 = make_spd_batch(2, 12, rng)
    x64 = ns.inverse_newton_schulz_warm(torch.tensor(a64),
                                        torch.zeros(2, 12, 12,
                                                    dtype=torch.float64))
    assert x64.dtype == torch.float64
    assert identity_error_inf(a64, x64.numpy()) < 1e-8


def test_warm_split3_past_128_polishes_with_fp64_residual():
    """The warm split3 route past the kernel's 128 on the κ = 500 class at
    4×256, drifted by δ = 1e-4 from its exact inverse: its polish residual
    is fp64 (the rounds written out here with ``residual_f64``), and it
    holds the gate, where the same rounds with an fp32 residual do not."""
    rng = np.random.default_rng(256)
    a0 = make_nonsym_cond(4, 256, 500.0, rng)
    x0 = np.linalg.inv(a0.astype(np.float64)).astype(np.float32)
    at = torch.tensor(_drifted(a0, 1e-4, rng, False))
    xt = torch.tensor(x0)
    x = ns.inverse_newton_schulz_warm(at, xt, precision="split3")
    eye = torch.eye(256)
    want = xt
    for _ in range(2):  # lo_iters
        want = ns._mm_split3(want, 2.0 * eye - ns._mm_split3(at, want))
    fp32 = want
    for _ in range(2):  # hi_iters + 1 past the kernel
        want = want + ns._mm_split3(want, ns.residual_f64(at, want))
        fp32 = fp32 + ns._mm_split3(fp32, eye - at @ fp32)
    assert _rel(x.numpy(), want.numpy()) <= 1e-6
    assert identity_error_inf(at.numpy(), x.numpy()) < 1e-4
    assert identity_error_inf(at.numpy(), fp32.numpy()) > 1e-4


def test_warm_validation_and_no_launch_on_cpu():
    ns.ns_refine_cuda.launches = 0
    a = torch.tensor(make_spd_batch(3, 8, np.random.default_rng(0)),
                     dtype=torch.float32)
    x = ns.inverse_newton_schulz_warm(a, torch.linalg.inv(a))
    assert identity_error_inf(a.numpy(), x.numpy()) < 1e-4
    assert ns.ns_refine_cuda.launches == 0
    with pytest.raises(ValueError, match="precision"):
        ns.inverse_newton_schulz_warm(a, a, precision="fp8")
    with pytest.raises(ValueError, match="must match"):
        ns.inverse_newton_schulz_warm(a, a[:2])
    with pytest.raises(ValueError, match="float32 CUDA"):
        ns.ns_refine_cuda(a, a, 2, 1, False)


def test_ns_probe_patches_match_the_kernel_source():
    """The card probe of K1 and K8 (``bench/ns_probe.py``) builds its
    clock-split variant by patching ``csrc/newton_schulz.cu``, the shared
    tensor-core loop (``csrc/ns_mma_rounds.cuh``) and ``csrc/ns_common.cuh``
    (the stamps' bookkeeping): every anchor must still occur as often as
    the probe expects, every stamp id must have a phase name, the
    occupancy reader must name what the source defines, and the probe
    refuses to run without a card."""
    import re

    from cuda_matrix_inversion_tpu_torch.bench import gp_ns_probe, ns_probe
    from cuda_matrix_inversion_tpu_torch.ops import cuda_build

    assert set(ns_probe.STAMPS) == {"newton_schulz.cu", "ns_mma_rounds.cuh",
                                    "ns_common.cuh"}
    for unit, patches in ns_probe.STAMPS.items():
        text = (cuda_build.CSRC_DIR / unit).read_text()
        for anchor, new, count in patches:
            assert text.count(anchor) == count, (unit, anchor)
            for stamp_id in re.findall(r"ns_stamp\((\d+)\)", new):
                assert int(stamp_id) == 0 or int(stamp_id) in gp_ns_probe.PHASES
    src = (cuda_build.CSRC_DIR / "newton_schulz.cu").read_text()
    for name in ("ns_mma_kernel", "ns_smem_bytes"):
        assert name in ns_probe.OCCUPANCY and name in src + (
            cuda_build.CSRC_DIR / "ns_mma_rounds.cuh").read_text()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            ns_probe.main()
