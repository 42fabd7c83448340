"""The port's fp64-class lane (``ops/double_single.py``: an fp32 seed refined
in native float64) against the JAX package's double-single tier, and the
lane's contracts from ``bench/chip_tests.py`` at CPU-sized shapes.

The suite runs JAX with x64 on, so JAX's f64 inputs take its double-single
split and both sides are checked against genuine f64 arithmetic.  The
residual is JAX's ``residual_inf_ds`` metric: max |I − AX| over the batch,
in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.ops import double_single as jax_ds
from cuda_matrix_inversion_tpu.ops.registry import (
    get_inverse_algorithm as jax_get_inverse_algorithm,
)
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.ops import double_single as ds
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm


def _resid(a, x):
    """max |I − AX| per member, float64."""
    a, x = np.asarray(a, np.float64), np.asarray(x, np.float64)
    return np.abs(np.eye(a.shape[-1]) - a @ x).max(axis=(1, 2))


def test_matches_jax_hiacc_f64_kappa500():
    """Both refine the lu_pallas seed of the same float64 batch; JAX stops
    at its double-single floor (~κ·2⁻⁴⁸), the port at the fp64 one, so the
    two inverses agree to far below either's fp32 seed (1e-10 relative)."""
    a = fixtures.make_nonsym_cond(2, 64, 500.0, np.random.default_rng(7)
                                  ).astype(np.float64)
    ref = np.asarray(jax_ds.inverse_hiacc(jnp.asarray(a),
                                          algorithm="lu_pallas", block=1))
    x = ds.inverse_hiacc(torch.tensor(a))
    assert x.dtype == torch.float64
    x = x.numpy()
    assert np.abs(x - ref).max() / np.abs(ref).max() <= 1e-10
    assert _resid(a, x).max() <= 1e-11
    assert _resid(a, ref).max() <= 1e-11



@pytest.mark.parametrize("algorithm,kw", [
    ("newton_schulz_spd_pallas", {"lo_iters": 8}),
    ("lu_bign_pallas", {"pw": 8}),
    ("gauss_pallas", {"polish": 0}),
])
def test_lane_forwards_the_seed_keywords_as_jax_does(algorithm, kw):
    """The lane passes keywords on to its seed lane, as the JAX package's
    ``inverse_hiacc`` does: both lanes (JAX's seeds in interpret mode) on
    the same float64 SPD batch at n = 16 reach the lane's 1e-11 and agree
    to 1e-10 relative."""
    a = fixtures.make_spd_batch(2, 16, np.random.default_rng(66)
                                ).astype(np.float64)
    ref = np.asarray(jax_get_inverse_algorithm("lu_hiacc")(
        jnp.asarray(a), algorithm=algorithm, **kw))
    x = get_inverse_algorithm("lu_hiacc")(torch.tensor(a), algorithm=algorithm,
                                          **kw).numpy()
    assert np.abs(x - ref).max() / np.abs(ref).max() <= 1e-10
    assert _resid(a, x).max() <= 1e-11
    assert _resid(a, ref).max() <= 1e-11

def test_lane_contract_kappa500_n128():
    """The registry lane (3 fixed rounds) on JAX's ``lu_hiacc_kappa500_128``
    draw as float64: ≤ 1e-11 (TPU ledger 1.85e-13)."""
    a = fixtures.make_nonsym_cond(2, 128, 500.0, np.random.default_rng(61)
                                  ).astype(np.float64)
    lane = get_inverse_algorithm("lu_hiacc")
    assert lane.keywords == {"algorithm": "lu_pallas", "iters": 3}
    x = lane(torch.tensor(a)).numpy()
    assert _resid(a, x).max() <= 1e-11


def test_adaptive_contract_kappa2e4():
    """Adaptive refinement at κ·ε₃₂ ≈ 1e-3 (JAX's
    ``lu_hiacc_kappa2e4_adaptive`` draw): ≤ 1e-8, also on the seeds where a
    fixed schedule fell short in the JAX tests."""
    for seed in (62, 0, 1, 1234, 2026):
        a = fixtures.make_nonsym_cond(2, 32, 2e4, np.random.default_rng(seed))
        x = ds.inverse_hiacc(torch.tensor(a.astype(np.float64))).numpy()
        assert _resid(a, x).max() <= 1e-8, seed


def test_rescues_the_kappa_4n_class():
    """The κ ≤ 4n square class past n = 128, where no fp32 lane can gate
    (JAX's ``hiacc_rescues_512_kappa4n`` at a CPU size): the lane seeds on
    the blocked LU and reaches ≤ 1e-8."""
    a = fixtures.make_square_batch(2, 256, np.random.default_rng(65)
                                   ).astype(np.float32)
    x = get_inverse_algorithm("lu_hiacc")(torch.tensor(a.astype(np.float64)))
    assert _resid(a, x.numpy()).max() <= 1e-8


def test_per_member_stop_with_a_singular_member():
    """W4, a difference by design: one singular member (a zero column)
    stops only itself.  The others reach the fp64 floor; the JAX loop
    stops the whole batch on the NaN residual after one round, which
    leaves them ~100× higher."""
    a = fixtures.make_nonsym_cond(3, 64, 500.0, np.random.default_rng(8)
                                  ).astype(np.float64)
    a[1, :, 3] = 0.0
    x = ds.inverse_hiacc(torch.tensor(a)).numpy()
    xh, xl = jax_ds.inverse_hiacc_ds(jnp.asarray(a), algorithm="lu")
    ref = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    assert not np.isfinite(x[1]).all() and not np.isfinite(ref[1]).all()
    ok = [0, 2]
    got, jax_got = _resid(a[ok], x[ok]), _resid(a[ok], ref[ok])
    assert got.max() <= 1e-12
    assert (jax_got > 10 * got).all()
    # the same members refined without the singular one
    alone = ds.inverse_hiacc(torch.tensor(a[ok])).numpy()
    np.testing.assert_array_equal(x[ok], alone)


@pytest.mark.parametrize("iters", [None, 2])
def test_f32_a_is_promoted_exactly(iters):
    """A float32 A is refined as the float64 A of the same values (the JAX
    pair of a float32 A has a zero low part); the result comes back in
    float32, at the fp32 floor."""
    a = fixtures.make_nonsym_cond(2, 32, 100.0, np.random.default_rng(3))
    x0 = torch.linalg.inv(torch.tensor(a))
    x32 = ds.refine_f64(torch.tensor(a), x0, iters=iters)
    x64 = ds.refine_f64(torch.tensor(a.astype(np.float64)), x0, iters=iters)
    assert x32.dtype == x64.dtype == torch.float64
    assert torch.equal(x32, x64)
    out = ds.inverse_hiacc(torch.tensor(a), iters=iters)
    assert out.dtype == torch.float32
    assert _resid(a, out.numpy()).max() < 1e-5


def test_fixed_rounds_and_adaptive_stop():
    """``iters`` runs exactly that many rounds; the adaptive loop runs at
    most ``max_iters``, and stops after the round whose input residual did
    not improve 4× (JAX's rule): from X0 = A⁻¹/2, R goes ½ → ¼, so it stops
    after two rounds."""
    a = torch.tensor(fixtures.make_nonsym_cond(
        2, 16, 10.0, np.random.default_rng(4)).astype(np.float64))
    x0 = 0.5 * torch.linalg.inv(a)
    one = ds.refine_f64(a, x0, iters=1)
    eye = torch.eye(16, dtype=torch.float64)
    assert torch.equal(one, x0 + x0 @ (eye - a @ x0))
    assert torch.equal(ds.refine_f64(a, x0, max_iters=1), one)
    assert torch.equal(ds.refine_f64(a, x0), ds.refine_f64(a, x0, iters=2))
