"""The port's blocked LU (K9's plain version and the blocked LU around it) against the
JAX package's ``ops/lu_bign.py`` in interpret mode, at the shapes of
``tests/test_lu_bign.py``; ``lu_pallas`` past K2's n = 128 against JAX's
``inverse_lu``; the panel-width rule and the shared-memory ceiling.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on).  Tolerances are max-norm relative differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.bench import chip_tests as jax_chip_tests
from cuda_matrix_inversion_tpu.ops import lu_bign as jax_lu_bign
from cuda_matrix_inversion_tpu.ops import pallas_lu as jax_pallas_lu
from cuda_matrix_inversion_tpu_torch import InversionEngine
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.ops import cuda_lu, linalg, lu_bign
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

# Port and JAX factor with the same pivots and the same fp32 operations in
# another order (JAX's rows stay in place and are gathered by one-hot
# products); both polished results land within κ·ε₃₂ of A⁻¹.
LU_RTOL = 1e-4
# The first panel alone: the same getf2 and triangular inverses, fp32,
# operations in another order (the trailing products differ).
PANEL_RTOL = 1e-5


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _case(name, rng):
    """The inputs and panel width of each case of tests/test_lu_bign.py."""
    if name == "general_48":
        return rng.standard_normal((5, 48, 48)).astype(np.float32), 16
    if name == "odd_37":
        return rng.standard_normal((3, 37, 37)).astype(np.float32), 8
    if name == "permutation_32":
        a = np.zeros((2, 32, 32), np.float32)
        a[:, np.arange(32), rng.permutation(32)] = 1.0
        return a + 1e-3 * rng.standard_normal(a.shape).astype(np.float32), 8
    if name == "kappa2e3_32":
        u, _ = np.linalg.qr(rng.standard_normal((3, 32, 32)))
        v, _ = np.linalg.qr(rng.standard_normal((3, 32, 32)))
        s = np.geomspace(1.0, 1.0 / 2000.0, 32)
        return ((u * s[None, None, :]) @ v).astype(np.float32), 16
    return rng.standard_normal((2, 24, 24)), 8  # f64_24


@pytest.mark.parametrize("name", ["general_48", "odd_37", "permutation_32",
                                  "kappa2e3_32", "f64_24"])
def test_blocked_lu_matches_jax(name):
    a, pw = _case(name, np.random.default_rng(len(name)))
    ref = np.asarray(jax_lu_bign.inverse_lu_big(jnp.asarray(a), pw=pw,
                                                block=1, interpret=True))
    x = lu_bign.inverse_lu_big(torch.tensor(a), pw=pw)
    assert x.dtype == torch.tensor(a).dtype and x.shape == a.shape
    x = x.numpy()
    a32 = a.astype(np.float32)
    assert identity_error_inf(a32, x) < 1e-4
    assert identity_error_inf(a32, ref) < 1e-4
    assert _rel(x, ref) <= LU_RTOL


@pytest.mark.parametrize("n,pw", [(32, 8), (48, 16)])
def test_panel_plain_matches_jax_panel(n, pw):
    """The first panel: JAX's L11⁻¹ and (U11⁻¹)ᵀ, its destination vector
    against the port's row permutation (the row that became pivot t sits
    at dest = t), and JAX's factored rows gathered into pivot order."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((2, n, n)).astype(np.float32)
    dest = jnp.arange(n, 2 * n, dtype=jnp.float32)[None, :].repeat(2, axis=0)
    pan, dest, ldi, udi = jax_lu_bign._call_panel(
        jnp.asarray(a), dest, 0, pw, 2, 1, True)
    work = torch.tensor(a)
    perm = torch.arange(n, dtype=torch.int32).repeat(2, 1)
    ipiv, ldi_p, udi_p = lu_bign.lu_panel_plain(work, perm, 0, pw)
    perm = perm.numpy()
    assert ipiv.dtype == torch.int32 and ipiv.shape == (2, pw)
    dest = np.asarray(dest)
    for b in range(2):
        np.testing.assert_array_equal(dest[b, perm[b, :pw]], np.arange(pw))
        assert sorted(perm[b]) == list(range(n))
    # LAPACK's ipiv replays the permutation
    replay = np.arange(n)[None].repeat(2, 0)
    for s in range(pw):
        for b in range(2):
            p = ipiv[b, s].item()
            replay[b, [s, p]] = replay[b, [p, s]]
    np.testing.assert_array_equal(replay, perm)
    assert _rel(ldi_p, ldi) <= PANEL_RTOL
    assert _rel(udi_p, np.swapaxes(np.asarray(udi), 1, 2)) <= PANEL_RTOL
    gathered = np.take_along_axis(np.asarray(pan), perm[:, :, None], axis=1)
    assert _rel(work[:, :, :pw], gathered) <= PANEL_RTOL
    # the other columns hold PA
    np.testing.assert_array_equal(
        work[:, :, pw:].numpy(),
        np.take_along_axis(a, perm[:, :, None], axis=1)[:, :, pw:])


def test_singular_member_is_confined():
    """A zero column gives a zero pivot (0/0, never clamped): that member
    alone comes out non-finite, the other equals its own inverse."""
    a = np.random.default_rng(16).standard_normal((2, 16, 16)
                                                  ).astype(np.float32)
    good = lu_bign.inverse_lu_big(torch.tensor(a[:1]), pw=8).numpy()
    a[1, :, 3] = 0.0
    ref = np.asarray(jax_lu_bign.inverse_lu_big(jnp.asarray(a), pw=8,
                                                block=1, interpret=True))
    x = lu_bign.inverse_lu_big(torch.tensor(a), pw=8).numpy()
    for out in (x, ref):
        assert np.isfinite(out[0]).all() and not np.isfinite(out[1]).all()
    np.testing.assert_array_equal(x[0], good[0])


def test_pick_pw_rules():
    """At least two panels (2·pw ≤ n), the first panel within one block's
    shared memory at n padded to a multiple of pw, the widest such."""
    assert lu_bign.pick_pw(512) == lu_bign.DEFAULT_PW
    for n in (8, 17, 24, 40, 100, 129, 160, 256, 300, 512, 1000, 1695,
              1696, 2000, 5000, 6000):
        pw = lu_bign.pick_pw(n)
        assert pw in (8, 16, 32, 64)
        n_pad = -(-n // pw) * pw
        if pw > 8:
            assert 2 * pw <= n
            assert lu_bign.panel_smem_bytes(n_pad, pw) <= lu_bign.MAX_SMEM
            wider = 2 * pw
            if wider <= lu_bign.DEFAULT_PW:
                w_pad = -(-n // wider) * wider
                assert (2 * wider > n or lu_bign.panel_smem_bytes(
                    w_pad, wider) > lu_bign.MAX_SMEM)
    assert lu_bign.pick_pw(16) == 8 and lu_bign.pick_pw(40) == 16
    assert lu_bign.panel_smem_bytes(1695, 32) <= lu_bign.MAX_SMEM
    assert lu_bign.panel_smem_bytes(1696, 32) > lu_bign.MAX_SMEM


def test_past_the_ceiling_raises():
    """pw = 8 still overflows one block at n = 7000: a clear error, as
    JAX's ``_panel_block`` raises past its VMEM budget."""
    assert lu_bign.pick_pw(7000) == 8
    with pytest.raises(ValueError, match="shared memory"):
        lu_bign.inverse_lu_big(torch.zeros(0, 7000, 7000))
    with pytest.raises(ValueError, match="shared memory"):
        lu_bign.inverse_lu_big(torch.zeros(0, 2000, 2000), pw=32)


@pytest.mark.parametrize("n", [160, 300])
def test_lu_pallas_past_128_matches_jax(n):
    """``lu_pallas`` past K2 runs the blocked LU; JAX serves 160 with
    its one-launch kernel and 300 with the XLA LU in interpret mode.  The
    κ = 500 class (the κ ≈ 4n class sits on the fp32 floor at this n).
    The port polishes with an fp64 residual and passes the gate; JAX's fp32
    residual sits on the floor at n = 300 on the CPU (1.1e-4), so only the
    port is gated there."""
    a = fixtures.make_nonsym_cond(2, n, 500.0, np.random.default_rng(n))
    ref = np.asarray(jax_pallas_lu.inverse_lu(jnp.asarray(a), block=1,
                                              interpret=True))
    before = cuda_lu.lu_inverse_cuda.launches, lu_bign.lu_panel_cuda.launches
    x = get_inverse_algorithm("lu_pallas")(torch.tensor(a)).numpy()
    assert (cuda_lu.lu_inverse_cuda.launches,
            lu_bign.lu_panel_cuda.launches) == before
    np.testing.assert_array_equal(
        x, lu_bign.inverse_lu_big(torch.tensor(a)).numpy())
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < (1e-4 if n <= 256 else 1.2e-4)
    assert _rel(x, ref) <= LU_RTOL


def test_routes_f64_and_lane():
    """float64 keeps the library route on ``lu_pallas``; the
    ``lu_bign_pallas`` lane is the blocked LU with no keywords at any n."""
    a64 = torch.tensor(fixtures.make_square_batch(2, 130,
                                                  np.random.default_rng(3)))
    assert torch.equal(cuda_lu.inverse_lu(a64), linalg.inverse_lu(a64))
    lane = get_inverse_algorithm("lu_bign_pallas")
    assert lane.keywords == {}
    a = fixtures.make_nonsym_cond(3, 20, 100.0, np.random.default_rng(4))
    x = lane(torch.tensor(a)).numpy()
    assert identity_error_inf(a, x) < 1e-4


def test_engine_serves_the_256_bucket():
    """An ``lu_pallas`` engine request at n = 200 pads to the 256 bucket
    and runs the blocked LU on the CPU."""
    a = fixtures.make_nonsym_cond(3, 200, 500.0, np.random.default_rng(5))
    eng = InversionEngine(algorithm="lu_pallas", device="cpu")
    x = eng.inverse(a)
    assert eng.compiled_shapes == [(8, 256)]
    assert x.shape == a.shape and x.dtype == np.float32
    assert identity_error_inf(a, x) < 1e-4


@pytest.mark.parametrize("args", [(2, 12, 500.0), (3, 8, 2e4), (1, 5, 10.0)])
def test_nonsym_cond_copy_matches_chip_tests(args):
    got = fixtures.make_nonsym_cond(*args, np.random.default_rng(61))
    ref = jax_chip_tests._make_nonsym_cond(*args, np.random.default_rng(61))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
