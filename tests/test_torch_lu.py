"""The port's pivoted LU inverse (K2's plain version + polish) against the
JAX package's ``pallas_lu.inverse_lu`` in interpret mode.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on; float64 would take the JAX f64 route).  Relative agreement is in
the max norm.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from cuda_matrix_inversion_tpu.io.fixtures import make_square_batch
from cuda_matrix_inversion_tpu.ops import pallas_lu
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.ops import cuda_lu, linalg


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _batch(case, n):
    rng = np.random.default_rng(7 * n + len(case))
    if case == "zero_diag":  # diag-dominant with a[0,0] = 0: must pivot
        a = rng.standard_normal((4, n, n)).astype(np.float32)
        a = a + n * np.eye(n, dtype=np.float32)
        a[:, 0, 0] = 0.0
        return a
    if case == "permuted":  # every column needs a non-trivial pivot
        a = rng.standard_normal((4, n, n)).astype(np.float32)
        return a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    return make_square_batch(4, n, rng).astype(np.float32)  # κ ≤ 4n


@pytest.mark.parametrize("case,n", [
    ("zero_diag", 32), ("permuted", 64), ("square", 8), ("square", 20),
    ("square", 32), ("square", 64)])
def test_inverse_lu_matches_jax_interpret(case, n):
    """Gate on both sides and agreement ≤ 1e-4 where κ ≤ 4n (κ·ε₃₂ ≲ 3e-5;
    both sides end with the same fp32 polish).  The zero-diagonal stress
    batch has κ ≈ 1e4: there, as in the JAX suite, the residual is held
    within 8× LAPACK's on the same draw and agreement to κ·ε₃₂ ≈ 1e-3."""
    a = _batch(case, n)
    ref = np.asarray(pallas_lu.inverse_lu(a))
    x = cuda_lu.inverse_lu(torch.tensor(a)).numpy()
    assert x.dtype == np.float32 and x.shape == a.shape
    if case == "zero_diag":
        gate, rtol = max(8 * identity_error_inf(a, np.linalg.inv(a)), 1e-5), 1e-3
    else:
        gate, rtol = 1e-4, 1e-4
    assert identity_error_inf(a, ref) < gate
    assert identity_error_inf(a, x) < gate
    assert _rel(x, ref) <= rtol


def test_pivots_and_factors_match_lapack():
    """Same pivot rule as LAPACK getrf (first maximum of |·| at or below
    the diagonal), on draws without ties; the compact factors agree."""
    a = make_square_batch(4, 32, np.random.default_rng(3)).astype(np.float32)
    lu, ipiv, perm = cuda_lu.lu_factor_plain(torch.tensor(a))
    for b in range(a.shape[0]):
        ref_lu, ref_piv = scipy.linalg.lu_factor(a[b])
        np.testing.assert_array_equal(ipiv[b].numpy(), ref_piv)
        assert _rel(lu[b].numpy(), ref_lu) <= 1e-5
        lower = np.tril(lu[b].numpy(), -1) + np.eye(32, dtype=np.float32)
        np.testing.assert_allclose(lower @ np.triu(lu[b].numpy()),
                                   a[b][perm[b].numpy()], atol=1e-4)


def test_singular_member_is_nonfinite_and_isolated():
    a = _batch("square", 32)
    a[1] = 1.0  # rank 1
    x = cuda_lu.inverse_lu(torch.tensor(a)).numpy()
    assert not np.isfinite(x[1]).all()
    assert np.isfinite(x[[0, 2, 3]]).all()
    assert identity_error_inf(a[[0, 2, 3]], x[[0, 2, 3]]) < 1e-4


def test_f64_takes_linalg_route():
    a = make_square_batch(3, 16, np.random.default_rng(4))
    x = cuda_lu.inverse_lu(torch.tensor(a))
    assert x.dtype == torch.float64
    assert torch.equal(x, linalg.inverse_lu(torch.tensor(a)))
    assert identity_error_inf(a, x.numpy()) < 1e-12


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_tiny_n_same_path(n):
    """n ≤ 8 goes through the same factorization (no panel width)."""
    a = _batch("permuted", n)
    x, _ = cuda_lu.lu_inverse_plain(torch.tensor(a))
    assert _rel(x.numpy(), np.linalg.inv(a.astype(np.float64))) <= 1e-5
    assert identity_error_inf(a, cuda_lu.inverse_lu(torch.tensor(a))) < 1e-5
