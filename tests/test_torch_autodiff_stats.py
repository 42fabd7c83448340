"""The port's small ops against the JAX package's: the inverse backward
(``ops/autodiff.py``) against ``jax.grad``, ``torch.autograd.gradcheck`` in
fp64, the batch statistics (``ops/stats.py``) and the Strassen product
(``ops/strassen.py``).

Inputs are drawn from ``np.random.default_rng(seed)`` here, never from the
session ``rng`` fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.ops import autodiff as jax_autodiff
from cuda_matrix_inversion_tpu.ops import stats as jax_stats
from cuda_matrix_inversion_tpu.ops import strassen as jax_strassen
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import autodiff, stats, strassen

# fp32 gradients of two inverses that differ in their last bits (κ ≈ 2–3
# SPD draws, n = 8), max-norm relative
GRAD_RTOL = 1e-4


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("algorithm", ["lu", "lu_pallas"])
def test_gradient_matches_jax_grad(algorithm):
    """d sum(X * G) / dA through the lane, against ``jax.grad`` of JAX's
    ``differentiable`` (its Pallas kernel in interpret mode), and against
    the closed form −A⁻ᵀ G A⁻ᵀ in fp64."""
    rng = np.random.default_rng(41)
    a = make_spd_batch(3, 8, rng).astype(np.float32)
    g = rng.standard_normal((3, 8, 8)).astype(np.float32)
    jax_inv = jax_autodiff.differentiable(algorithm)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jax_inv(x) * g))(
        jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    x = autodiff.differentiable(algorithm)(at)
    (got,) = torch.autograd.grad((x * torch.tensor(g)).sum(), at)
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert _rel(got, ref) <= GRAD_RTOL
    inv = np.linalg.inv(a.astype(np.float64))
    closed = -np.swapaxes(inv, -1, -2) @ g @ np.swapaxes(inv, -1, -2)
    assert _rel(got, closed) <= GRAD_RTOL


@pytest.mark.parametrize("kind", ["spd", "square"])
def test_gradcheck_fp64_on_lu(kind):
    rng = np.random.default_rng(42)
    make = make_spd_batch if kind == "spd" else make_square_batch
    a = torch.tensor(make(2, 5, rng), requires_grad=True)
    assert torch.autograd.gradcheck(autodiff.differentiable("lu"), (a,))


def test_forward_is_the_lane_and_named():
    a = torch.tensor(make_spd_batch(2, 6, np.random.default_rng(43)),
                     dtype=torch.float32)
    fn = autodiff.differentiable("lu_pallas")
    assert fn.__name__ == "inverse_lu_pallas_diff"
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )

    assert torch.equal(fn(a), get_inverse_algorithm("lu_pallas")(a))


def test_with_inverse_vjp_wraps_any_function():
    calls = []

    def inv(a):
        calls.append(a.shape)
        return torch.linalg.inv(a)

    a = torch.tensor(make_spd_batch(1, 4, np.random.default_rng(44)),
                     requires_grad=True)
    x = autodiff.with_inverse_vjp(inv)(a)
    x.sum().backward()
    assert calls == [(1, 4, 4)]  # the backward re-runs nothing
    xi = torch.linalg.inv(a.detach())
    ones = torch.ones_like(xi)
    assert torch.allclose(a.grad, -(xi.mT @ ones @ xi.mT), rtol=1e-12)


@pytest.mark.parametrize("shape", [(7, 4), (3, 9, 5)])
def test_stats_match_jax(shape):
    x = np.random.default_rng(45).standard_normal(shape)
    t = torch.tensor(x)
    for name in ("column_mean", "subtract_column_mean"):
        np.testing.assert_allclose(getattr(stats, name)(t).numpy(),
                                   np.asarray(getattr(jax_stats, name)(x)),
                                   rtol=1e-12, atol=1e-14)
    for ddof in (0, 1):
        got = stats.covariance(t, ddof=ddof).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_stats.covariance(x, ddof=ddof)),
            rtol=1e-12, atol=1e-14)
    if len(shape) == 2:
        np.testing.assert_allclose(stats.covariance(t, ddof=1).numpy(),
                                   np.cov(x, rowvar=False), rtol=1e-12)


@pytest.mark.parametrize("shapes,cutoff", [
    (((16, 16), (16, 16)), 4),
    (((13, 11), (11, 9)), 3),
    (((2, 20, 18), (2, 18, 21)), 5),
    (((6, 6), (6, 6)), 512),
])
def test_strassen_matches_jax(shapes, cutoff):
    rng = np.random.default_rng(46)
    a, b = (rng.standard_normal(s) for s in shapes)
    got = strassen.strassen_matmul(torch.tensor(a), torch.tensor(b),
                                   cutoff=cutoff).numpy()
    ref = np.asarray(jax_strassen.strassen_matmul(jnp.asarray(a),
                                                  jnp.asarray(b),
                                                  cutoff=cutoff))
    assert got.shape == ref.shape == (a @ b).shape
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, a @ b, rtol=1e-10, atol=1e-12)


def test_strassen_rejects_mismatched_inner_dims():
    with pytest.raises(ValueError, match="inner dims"):
        strassen.strassen_matmul(torch.ones(3, 4), torch.ones(5, 3))
