"""The port's Gauss-Jordan inverse (K7's plain version, lane
``gauss_pallas``) against the JAX package.

Same NumPy inputs, cast to float32 explicitly (the suite runs JAX with x64
on), go through the JAX ``inverse_gauss_jordan`` in interpret mode, with a
batch block of one matrix (the block only sets how many matrices one
interpreted grid step unrolls), and through the port on CPU tensors.
Tolerances are max-norm relative differences, and the gate is
max‖AX − I‖∞ (row sums) in fp64.
"""

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.ops import pallas_gauss_jordan as jax_gj
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
from cuda_matrix_inversion_tpu_torch.ops import cuda_gauss_jordan as gj
from cuda_matrix_inversion_tpu_torch.ops import host_api
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _draw(kind, n, seed):
    """``make_square_batch`` (κ ≤ 4n, sign-mixed, so pivoting swaps rows),
    or the same plus n·P for a random permutation P, which puts every
    pivot off the diagonal."""
    rng = np.random.default_rng(seed)
    a = make_square_batch(6, n, rng)
    if kind == "permuted":
        a = a + n * np.eye(n)[rng.permutation(n)]
    return a.astype(np.float32)


@pytest.mark.parametrize("kind", ["square", "permuted"])
@pytest.mark.parametrize("n", [5, 8, 20, 64])
def test_polished_matches_jax(kind, n):
    """Plain K7 + one fp32 polish against the JAX kernel + its polish: both
    under the 1e-4 gate, and within 1e-4 relative of each other (each sits
    within its κ·ε₃₂ polish floor, ≤ 256 · 6e-8 ≈ 1.5e-5, of A⁻¹)."""
    a = _draw(kind, n, 10 * n + len(kind))
    ref = np.asarray(jax_gj.inverse_gauss_jordan(a, block=1))
    x = gj.inverse_gauss_jordan(torch.tensor(a)).numpy()
    assert x.dtype == np.float32 and x.shape == a.shape
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < 1e-4
    assert _rel(x, ref) <= 1e-4


@pytest.mark.parametrize("kind", ["square", "permuted"])
@pytest.mark.parametrize("n", [8, 64])
def test_raw_kernel_matches_jax(kind, n):
    """polish=0 on both sides: the raw Gauss-Jordan inverses.  The two
    pivot on the same rows and differ in the order of their updates only;
    Gauss-Jordan's forward error is κ-proportional, so they agree within
    κ·ε₃₂·n ≲ 1e-3 relative (measured ≲ 1e-5), and against the fp64
    inverse within the same bound."""
    a = _draw(kind, n, 20 * n + len(kind))
    ref = np.asarray(jax_gj.inverse_gauss_jordan(a, block=1, polish=0))
    x = gj.inverse_gauss_jordan(torch.tensor(a), polish=0).numpy()
    exact = np.linalg.inv(a.astype(np.float64))
    assert _rel(x, ref) <= 1e-3
    assert _rel(x, exact) <= 1e-3
    np.testing.assert_array_equal(
        x, gj.gauss_jordan_plain(torch.tensor(a)).numpy())


def test_pivot_rows_are_the_first_maxima():
    """A permutation matrix scaled per row: every step's pivot is the one
    nonzero of its column, so the plain version inverts it exactly (the
    inverse of P·D is D⁻¹·Pᵀ with power-of-two scales)."""
    rng = np.random.default_rng(3)
    n = 12
    perm = rng.permutation(n)
    scale = 2.0 ** rng.integers(-3, 4, n)
    a = (np.eye(n)[perm] * scale[:, None]).astype(np.float32)[None]
    x = gj.gauss_jordan_plain(torch.tensor(a)).numpy()
    np.testing.assert_array_equal(x, np.linalg.inv(a.astype(np.float64)))


def test_singular_member_is_confined():
    """Member 2 is all ones (rank 1) and member 4 zero: only they come out
    non-finite, with and without the polish; the others are unchanged."""
    a = _draw("square", 16, 7)
    good = gj.inverse_gauss_jordan(torch.tensor(a)).numpy()
    bad = a.copy()
    bad[2] = 1.0
    bad[4] = 0.0
    for polish in (0, 1):
        x = gj.inverse_gauss_jordan(torch.tensor(bad), polish=polish).numpy()
        finite = np.isfinite(x).all(axis=(1, 2))
        assert finite.tolist() == [True, True, False, True, False, True]
        if polish:
            np.testing.assert_array_equal(x[finite], good[finite])
    with pytest.raises(host_api.SingularBatchError) as err:
        host_api.inverse_batched(bad, "gauss_pallas", device="cpu",
                                 check=True)
    assert err.value.indices == [2, 4]


def test_gauss_pallas_lane_through_host_api():
    """The registry lane with no keywords, NumPy in and out on the CPU,
    against JAX's lane on the same batch."""
    assert get_inverse_algorithm("gauss_pallas").keywords == {}
    a = _draw("square", 32, 5)
    x = host_api.inverse_batched(a, "gauss_pallas", device="cpu")
    ref = np.asarray(jax_gj.inverse_gauss_jordan(a, block=1))
    assert x.dtype == np.float32
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, ref) <= 1e-4


def test_routes_past_the_kernel():
    """n > 192 and float64 take the library LU route with its polish, as
    the JAX wrapper does; a non-default polish there raises; 192 itself
    stays on the kernel."""
    rng = np.random.default_rng(9)
    a = make_square_batch(2, 200, rng).astype(np.float32)
    x = gj.inverse_gauss_jordan(torch.tensor(a)).numpy()
    assert identity_error_inf(a, x) < 1e-4
    a64 = make_square_batch(3, 12, rng)
    x64 = gj.inverse_gauss_jordan(torch.tensor(a64))
    assert x64.dtype == torch.float64
    ref64 = np.asarray(jax_gj.inverse_gauss_jordan(a64))
    assert _rel(x64.numpy(), ref64) <= 1e-12
    for big in (torch.tensor(a), torch.tensor(a64)):
        with pytest.raises(ValueError, match="polish"):
            gj.inverse_gauss_jordan(big, polish=2)
    eye = torch.eye(192).repeat(1, 1, 1) * 2.0
    np.testing.assert_array_equal(gj.inverse_gauss_jordan(eye).numpy(),
                                  0.5 * np.eye(192, dtype=np.float32)[None])


def test_cpu_tensor_launches_no_kernel_and_shape_checks():
    gj.gauss_jordan_cuda.launches = 0
    gj.inverse_gauss_jordan(torch.tensor(_draw("square", 8, 1)))
    assert gj.gauss_jordan_cuda.launches == 0
    with pytest.raises(ValueError, match="float32 CUDA"):
        gj.gauss_jordan_cuda(torch.eye(4)[None])
    with pytest.raises(ValueError, match="1..192"):
        gj.gauss_jordan_cuda(torch.eye(193)[None])
    with pytest.raises(ValueError, match="batch, n, n"):
        gj.inverse_gauss_jordan(torch.zeros(2, 3, 4))
