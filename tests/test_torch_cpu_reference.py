"""The port's host oracle (``ops/cpu_reference.py``) and host lanes against
the JAX package's: the copied oracle bit for bit, the host lanes through
``inverse_batched`` and ``solve_batched`` (which touch no device), and the
registry's host-lane names.

Inputs are drawn from ``np.random.default_rng(seed)`` here, never from the
session ``rng`` fixture.
"""

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.ops import cpu_reference as jax_cpu
from cuda_matrix_inversion_tpu.ops import host_api as jax_host_api
from cuda_matrix_inversion_tpu.ops import registry as jax_registry
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_spd_batch,
    make_square_batch,
    singular_demo_batch,
)
from cuda_matrix_inversion_tpu_torch.native import build, oracle
from cuda_matrix_inversion_tpu_torch.ops import cpu_reference, host_api
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)

SCIPY_LANES = ["cholesky_cpu", "gauss_cpu", "lu_cpu"]
NATIVE_LANES = ["cholesky_native_cpu", "lu_native_cpu"]
DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kind", [("inverse_lu", "square"),
                                       ("inverse_cholesky", "spd"),
                                       ("inverse_gauss_jordan", "square")])
def test_inverse_oracles_equal_jax(name, kind, dtype):
    rng = np.random.default_rng(11)
    make = make_spd_batch if kind == "spd" else make_square_batch
    a = make(6, 12, rng).astype(dtype)
    got = getattr(cpu_reference, name)(a)
    ref = getattr(jax_cpu, name)(a)
    assert got.dtype == ref.dtype == dtype
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["calculate_mean_cpu",
                                  "calculate_mean_solve_cpu",
                                  "calculate_variance_cpu",
                                  "calculate_variance_solve_cpu"])
def test_gp_oracles_equal_jax(name, dtype):
    g = make_gp_batch(5, 10, np.random.default_rng(12))
    last = "d" if "mean" in name else "e"
    args = [g[k].astype(dtype) for k in ("a", "b", "c", last)]
    got = getattr(cpu_reference, name)(*args)
    ref = getattr(jax_cpu, name)(*args)
    assert got.shape == ref.shape == (5, 1, 1)
    assert np.array_equal(got, ref)
    truth = g["means"] if "mean" in name else g["variances"]
    assert np.abs(got - truth).max() < (1e-4 if dtype == np.float32
                                        else 1e-12)


@pytest.mark.parametrize("name", ["inverse_lu", "inverse_cholesky"])
def test_lapack_oracles_raise_on_a_singular_member_as_jax(name):
    a = make_spd_batch(3, 6, np.random.default_rng(13))
    a[1] = 0.0
    for fn in (getattr(cpu_reference, name), getattr(jax_cpu, name)):
        with pytest.raises(np.linalg.LinAlgError, match="matrix 1"):
            fn(a)


@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("method", ["lu_cpu", "cholesky_cpu"])
def test_solve_batched_host_methods_match_jax(method, squeeze):
    """F6: the port's ``solve_batched`` knew only ``lu`` and ``cholesky``
    and raised ``KeyError`` for the host methods, which JAX's has."""
    rng = np.random.default_rng(14)
    make = make_spd_batch if method == "cholesky_cpu" else make_square_batch
    a = make(4, 9, rng).astype(np.float32)
    rhs = rng.standard_normal((4, 9) if squeeze else (4, 9, 3))
    got = host_api.solve_batched(a, rhs, method=method)
    ref = jax_host_api.solve_batched(a, rhs, method=method)
    assert got.shape == ref.shape == rhs.shape
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    x = got if not squeeze else got[..., None]
    b = rhs if not squeeze else rhs[..., None]
    assert np.abs(a.astype(np.float64) @ x - b).max() < 1e-4


def test_solve_batched_host_methods_touch_no_device(monkeypatch):
    """The host methods run where there is no card, even when a device is
    named, and never build a tensor."""
    monkeypatch.setattr(torch, "tensor", _no_tensor)
    a = make_spd_batch(2, 5, np.random.default_rng(15))
    for method in ("lu_cpu", "cholesky_cpu"):
        x = host_api.solve_batched(a, a[:, :, :1], method=method,
                                   device="cuda")
        assert np.abs(x[:, :, 0] - np.eye(5)[0]).max() < 1e-12
    with pytest.raises(KeyError, match="bogus"):
        host_api.solve_batched(a, a, method="bogus")


def _no_tensor(*args, **kwargs):
    raise AssertionError("a host lane built a tensor")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lane", SCIPY_LANES)
def test_inverse_batched_host_lanes_match_jax(lane, dtype, monkeypatch):
    """F7: the port's ``inverse_batched`` moved every batch to a torch
    device; a host lane takes the NumPy batch as JAX's does, on a host
    without a card even when a device is named."""
    rng = np.random.default_rng(16)
    a = make_spd_batch(5, 11, rng).astype(dtype)
    ref = jax_host_api.inverse_batched(a, algorithm=lane)
    monkeypatch.setattr(torch, "tensor", _no_tensor)
    got = host_api.inverse_batched(a, algorithm=lane, device="cuda")
    assert got.dtype == ref.dtype == dtype
    assert np.array_equal(got, ref)


def test_inverse_batched_host_lane_check_raises_as_jax():
    """``check=True`` names the non-finite members of a host lane's output,
    as JAX's does: the singular demo batch through ``gauss_cpu`` (the
    zero column gives no pivot; the rank-2 member rounds to a finite
    one)."""
    a = singular_demo_batch()
    with np.errstate(divide="ignore", invalid="ignore"):
        with pytest.raises(jax_host_api.SingularBatchError) as ref:
            jax_host_api.inverse_batched(a, algorithm="gauss_cpu", check=True)
        with pytest.raises(host_api.SingularBatchError) as got:
            host_api.inverse_batched(a, algorithm="gauss_cpu", check=True)
    assert got.value.indices == ref.value.indices == [2]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = host_api.inverse_batched(a, algorithm="gauss_cpu")
        ref_out = jax_host_api.inverse_batched(a, algorithm="gauss_cpu")
    assert np.array_equal(out, ref_out, equal_nan=True)


def test_host_lane_names_match_jax():
    """The three SciPy lanes as in JAX's registry; the native ones exactly
    when the port's oracle loads (built first, so that another process's
    build cannot land between the two looks); the host lanes after the
    device lanes."""
    built = build.ensure_built() is not None
    host = list_inverse_algorithms(cpu=True)
    jax_host = jax_registry.list_inverse_algorithms(cpu=True)
    assert [n for n in jax_host if n not in NATIVE_LANES] == SCIPY_LANES
    assert oracle.available() == built
    assert host == sorted(SCIPY_LANES + (NATIVE_LANES if built else []))
    assert list_inverse_algorithms() == (list_inverse_algorithms(cpu=False)
                                         + host)
    assert get_inverse_algorithm("lu_cpu") is cpu_reference.inverse_lu
    assert get_inverse_algorithm("gauss_cpu") is (
        cpu_reference.inverse_gauss_jordan)
