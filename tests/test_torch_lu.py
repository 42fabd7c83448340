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


def _k2_schedule_replay(a: torch.Tensor):
    """K2's schedule (``csrc/lu.cu``) in plain PyTorch, float32, each step
    an unfused mul then sub: the batch padded with the identity to the
    kernel's NP (16, 32, 64 or 128); the factor by panels of 4 columns (in
    a panel, the first maximum by position, NaN never winning, the rows
    swapping positions, each column's step on the panel's columns only; at
    the panel's end each pivot row past the panel takes the panel's
    earlier steps in order (U12), then the rows past the panel its 4
    steps in order); the forward pass against P by blocks of NP/8 (at most
    4) rows, ascending (each block's triangle, then its terms on the rows
    below), the back pass by blocks descending (each block's triangle last
    row first, each row's division after its terms, then the block's terms
    on the rows above).  Returns ``(A⁻¹, ipiv)`` cut to n."""
    batch, n, _ = a.shape
    np_ = 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 128
    rb = min(4, np_ // 8)
    w = torch.eye(np_).repeat(batch, 1, 1)
    w[:, :n, :n] = a
    rows = torch.arange(batch)
    perm = torch.arange(np_).repeat(batch, 1)
    ipiv = torch.empty((batch, np_), dtype=torch.int32)
    for k0 in range(0, np_, 4):
        for j in range(k0, k0 + 4):
            mag = torch.nan_to_num(w[:, j:, j].abs(), nan=-1.0)
            p = torch.where(mag.max(1).values >= 0, j + mag.argmax(1), j)
            ipiv[:, j] = p.to(torch.int32)
            wj, wp = w[rows, j].clone(), w[rows, p].clone()
            w[rows, j], w[rows, p] = wp, wj
            pj, pp = perm[rows, j].clone(), perm[rows, p].clone()
            perm[rows, j], perm[rows, p] = pp, pj
            w[:, j + 1:, j] = w[:, j + 1:, j] / w[:, j, j:j + 1]
            pan = slice(j + 1, k0 + 4)
            w[:, j + 1:, pan] = (w[:, j + 1:, pan]
                                 - w[:, j + 1:, j:j + 1] * w[:, j:j + 1, pan])
        past = slice(k0 + 4, np_)
        for h in range(1, 4):  # U12, row h taking steps k0 .. k0 + h - 1
            for e in range(h):
                w[:, k0 + h, past] = (w[:, k0 + h, past]
                                      - w[:, k0 + h, k0 + e:k0 + e + 1]
                                      * w[:, k0 + e, past])
        for e in range(4):  # the rows past the panel, the panel's steps
            w[:, past, past] = (w[:, past, past]
                                - w[:, past, k0 + e:k0 + e + 1]
                                * w[:, k0 + e:k0 + e + 1, past])
    y = (perm[:, :, None] == torch.arange(np_)).to(torch.float32)  # Y = P
    blocks = range(0, np_, rb)
    for r0 in blocks:
        for i in range(r0 + 1, r0 + rb):
            for k in range(r0, i):
                y[:, i] = y[:, i] - w[:, i, k:k + 1] * y[:, k]
        for k in range(r0, r0 + rb):
            y[:, r0 + rb:] = (y[:, r0 + rb:]
                              - w[:, r0 + rb:, k:k + 1] * y[:, k:k + 1])
    for r0 in reversed(blocks):
        for i in reversed(range(r0, r0 + rb)):
            for kk in reversed(range(i + 1, r0 + rb)):
                y[:, i] = y[:, i] - w[:, i, kk:kk + 1] * y[:, kk]
            y[:, i] = y[:, i] / w[:, i, i:i + 1]
        for kk in reversed(range(r0, r0 + rb)):
            y[:, :r0] = y[:, :r0] - w[:, :r0, kk:kk + 1] * y[:, kk:kk + 1]
    return y[:, :n, :n], ipiv[:, :n]


@pytest.mark.parametrize("draw", ["general", "ties"])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 20, 72, 127, 128])
def test_k2_schedule_is_bitwise_the_plain_order(n, draw):
    """K2's schedule against :func:`cuda_lu.lu_inverse_plain`, ``inv`` and
    ``ipiv`` equal (``torch.equal``) on every finite member and the same
    members non-finite: the identity padding to NP, the panels with their
    U12 rows, and the substitutions by blocks keep every element's terms
    in the plain order.  A general draw with one singular member (rank 1,
    or 0 at n = 1), and a draw of small integers in [-2, 2] (exact ties
    decide the pivots; a member may be singular)."""
    rng = np.random.default_rng(4000 + n)
    if draw == "general":
        a = rng.standard_normal((3, n, n)).astype(np.float32)
        a[1] = 1.0 if n > 1 else 0.0
    else:
        a = rng.integers(-2, 3, (3, n, n)).astype(np.float32)
    at = torch.tensor(a)
    x, piv = _k2_schedule_replay(at)
    ref, ref_piv = cuda_lu.lu_inverse_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if draw == "general":
        assert finite.tolist() == [True, False, True]
    assert torch.equal(x[finite], ref[finite])
    assert torch.equal(piv[finite], ref_piv[finite])


def test_k2_probe_patches_match_the_kernel_source():
    """The card probe of K2 (``bench/lu_small_probe.py``) builds its
    stamped variant by patching ``csrc/lu.cu``: every anchor of its patches
    occurs as often as the probe expects, the names its occupancy reader
    and launcher call are the source's, and the probe refuses to run
    without a card."""
    from cuda_matrix_inversion_tpu_torch.bench import lu_small_probe
    from cuda_matrix_inversion_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "lu.cu").read_text()
    for anchor, _, count in lu_small_probe.STAMPS:
        assert src.count(anchor) == count, anchor
    for name in ("const void* lu_kernel_for(int n, bool pair)",
                 "size_t lu_smem(int n)", "int lu_threads(int n, bool pair)"):
        assert src.count(name) == 1, name
    assert len(lu_small_probe.STEPS) <= 16
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            lu_small_probe.main()
