"""The port's mixed-dimension bucketing against the JAX package's
``parallel/bucketing.py``: the same packing, and the same inverses and GP
means and variances on ragged lists.  The JAX side runs its library lanes
(``lu``, ``cholesky``, GP ``solve``): its interpreted kernels cost tens of
seconds at these sizes.  Tolerances are max-norm relative differences, and
absolute 1e-4 on GP means and variances (the JAX test's bound).
"""

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.parallel import bucketing as jax_bucketing
from cuda_matrix_inversion_tpu_torch import bucketed_gp_mean_variance
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_nonsym_cond,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_lu, lu_bign
from cuda_matrix_inversion_tpu_torch.parallel import bucketing

SIZES = [4, 8, 12, 17, 32, 40, 5, 100, 150]


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def test_buckets_and_packing_are_the_jax_packages():
    sizes = [3, 8, 9, 32, 100, 500, 129, 512]
    assert bucketing.DEFAULT_BUCKETS == jax_bucketing.DEFAULT_BUCKETS
    assert (bucketing.assign_buckets(sizes)
            == jax_bucketing.assign_buckets(sizes)
            == [8, 8, 32, 32, 128, 512, 512, 512])
    assert bucketing.assign_buckets([5, 30], (16, 32)) == [16, 32]
    with pytest.raises(ValueError, match="exceeds largest bucket 512"):
        bucketing.assign_buckets([513])
    rng = np.random.default_rng(1)
    ms = [make_spd_batch(1, n, rng)[0].astype(np.float32) for n in (4, 8, 20)]
    stacks, index = bucketing.pack_buckets(ms)
    ref_stacks, ref_index = jax_bucketing.pack_buckets(ms)
    assert index == ref_index == [(8, 0, 4), (8, 1, 8), (32, 0, 20)]
    assert sorted(stacks) == sorted(ref_stacks) == [8, 32]
    for k in stacks:
        assert stacks[k].dtype == np.float32
        np.testing.assert_array_equal(stacks[k], ref_stacks[k])
    with pytest.raises(ValueError, match="square"):
        bucketing.pack_buckets([np.ones((3, 4, 4))])


@pytest.mark.parametrize("algorithm,jax_algorithm,kind", [
    ("lu", "lu", "spd"), ("cholesky_pallas", "cholesky", "spd"),
    ("lu_pallas", "lu", "general")])
def test_bucketed_inverse_matches_jax(algorithm, jax_algorithm, kind):
    """A ragged list over the 8, 32 and 128 buckets (and 512 for the
    general class, whose 300 runs the blocked LU): every inverse within
    1e-4 relative of JAX's and through the gate."""
    rng = np.random.default_rng(len(algorithm))
    if kind == "spd":
        ms = [make_spd_batch(1, n, rng)[0].astype(np.float32) for n in SIZES]
    else:
        ms = [make_nonsym_cond(1, n, 100.0, rng)[0] for n in SIZES + [300]]
    before = cuda_lu.lu_inverse_cuda.launches, lu_bign.lu_panel_cuda.launches
    got = bucketing.bucketed_inverse(ms, algorithm=algorithm, device="cpu")
    assert (cuda_lu.lu_inverse_cuda.launches,
            lu_bign.lu_panel_cuda.launches) == before
    ref = jax_bucketing.bucketed_inverse(ms, algorithm=jax_algorithm)
    assert len(got) == len(ms)
    for m, x, r in zip(ms, got, ref):
        assert x.shape == m.shape and x.dtype == np.float32
        assert identity_error_inf(m[None], x[None]) < 1e-4
        assert _rel(x, r) <= 1e-4


def test_bucketed_inverse_default_lane_and_buckets():
    """The default lane is ``cholesky_pallas``; custom buckets pad to the
    next one."""
    rng = np.random.default_rng(5)
    ms = [make_spd_batch(1, n, rng)[0].astype(np.float32) for n in (3, 20)]
    got = bucketing.bucketed_inverse(ms, buckets=(16, 64), device="cpu")
    for m, x in zip(ms, got):
        assert identity_error_inf(m[None], x[None]) < 1e-4
    with pytest.raises(ValueError, match="exceeds"):
        bucketing.bucketed_inverse(ms, buckets=(8,), device="cpu")


@pytest.mark.parametrize("method,jax_method", [("solve", "solve"),
                                               ("pallas", "solve"),
                                               ("pallas_ns", "solve")])
def test_bucketed_gp_matches_jax(method, jax_method):
    rng = np.random.default_rng(7)
    problems, expected = [], []
    for n in (4, 8, 19, 33, 130):
        b = make_spd_batch(1, n, rng)[0].astype(np.float32)
        a, c, d = (rng.random(n).astype(np.float32) for _ in range(3))
        e = np.float32(rng.random())
        problems.append((a, b, c, d, np.asarray(e)))
        k = b.astype(np.float64) + np.diag(c.astype(np.float64))
        kinv = np.linalg.inv(k)
        expected.append((a @ (kinv @ d), e - a @ (kinv @ a)))
    got = bucketed_gp_mean_variance(problems, method=method, device="cpu")
    ref = jax_bucketing.bucketed_gp_mean_variance(problems, method=jax_method)
    assert len(got) == len(problems)
    for (m, v), (mr, vr), (me, ve) in zip(got, ref, expected):
        assert isinstance(m, float) and isinstance(v, float)
        assert abs(m - mr) < 1e-4 and abs(v - vr) < 1e-4
        assert abs(m - me) < 1e-4 and abs(v - ve) < 1e-4
