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
import threadpoolctl
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


@pytest.fixture
def one_thread():
    """The replay and the plain version are thousands of small tensor ops, and
    the suite runs in parallel workers: on one thread each op runs at once
    instead of waiting for the worker's other threads.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _k7_schedule_replay(a: torch.Tensor, mutant: str | None = None):
    """K7's schedule (``csrc/gauss_jordan.cu``) in plain PyTorch, float32,
    each step an unfused mul then sub: the batch padded with the identity
    to the kernel's NP (16, 32, 64, 128 or 192); rows never move (a row
    map: each row's position, the pivot by the first maximum of the
    magnitudes by position over the real rows at positions ≥ k, NaN never
    winning); the steps by panels of 4 columns, each column's step taken
    on the panel's columns first (the pivot row scaled by its reciprocal,
    every other row v − f·prow with its own column value as f); at the
    panel's end the 4 pivot rows formed across all columns (row h takes
    the panel's earlier steps in order, then its scaling) and the panel's 4
    steps taken on every row in order, a pivot row taking its scaled row at
    its own step; then the composed unswap: W's row s goes to output row
    pos[s], its column c to output column (the row at position c).  The
    kernel's lookahead instance runs the same operations: its panel
    threads bring the next panel's columns up to date with the same formed
    pivot rows and multipliers as the tiles.

    ``mutant`` breaks the order on purpose: ``"reversed_steps"`` takes a
    panel's steps on the rows outside the panel last first, and
    ``"unordered_pivot_rows"`` forms each pivot row without the panel's
    earlier steps."""
    batch, n, _ = a.shape
    np_ = next(p for p in (16, 32, 64, 128, 192) if n <= p)
    w = torch.eye(np_).repeat(batch, 1, 1)
    w[:, :n, :n] = a
    rows = torch.arange(batch)
    slots = torch.arange(np_)
    pos = slots.repeat(batch, 1)
    nan4 = torch.full((batch, 4), float("nan"))
    for k0 in range(0, n, 4):
        nh = min(4, n - k0)
        pan = slice(k0, k0 + 4)
        v = w[:, :, pan].clone()  # the panel threads' columns
        f = torch.zeros((batch, np_, 4))
        sp, rs = [], []
        for h in range(nh):
            k = k0 + h
            x = v[:, :, h].clone()
            rx = 1.0 / x
            cand = v.clone()
            cand[:, :, h] = 1.0
            cand = cand * rx[:, :, None]
            mag = torch.where((slots < n) & (pos >= k), x.abs(),
                              torch.tensor(float("nan")))
            mag = torch.nan_to_num(mag, nan=-1.0)
            best = mag.max(1).values
            first = torch.where(mag == best[:, None], pos, np_).argmin(1)
            found = best >= 0
            s = torch.where(found, first, (pos == k).int().argmax(1))
            p = pos[rows, s]
            prow = torch.where(found[:, None], cand[rows, s], nan4)
            f[:, :, h] = x
            upd = v.clone()
            upd[:, :, h] = 0.0
            v = upd - x[:, :, None] * prow[:, None, :]
            v[rows, s] = prow
            at_k = pos == k
            pos = torch.where(at_k, p[:, None], pos)
            pos[rows, s] = k
            sp.append(s)
            rs.append(rx[rows, s])
        st = [w[rows, s].clone() for s in sp]  # the pivot rows at the start
        u = []
        for h in range(nh):
            uh = st[h]
            if mutant != "unordered_pivot_rows":
                for e in range(h):
                    uh = uh - f[rows, sp[h], e][:, None] * u[e]
            u.append(uh * rs[h][:, None])
        order = range(nh - 1, -1, -1) if mutant == "reversed_steps" \
            else range(nh)
        for h in order:
            piv = slots[None, :] == sp[h][:, None]
            w = torch.where(piv[:, :, None], u[h][:, None, :],
                            w - f[:, :, h:h + 1] * u[h][:, None, :])
        w[:, :, pan] = v
    row_at = torch.argsort(pos, dim=1)  # the row at each position
    out = torch.empty((batch, n, n))
    for b in range(batch):
        out[b, pos[b, :n, None], row_at[b, None, :n]] = w[b, :n, :n]
    return out


@pytest.mark.parametrize("draw", ["general", "ties"])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 20, 72, 127, 128, 129, 192])
def test_k7_schedule_is_bitwise_the_plain_order(n, draw, one_thread):
    """K7's schedule against :func:`gj.gauss_jordan_plain`, equal
    (``torch.equal``) on every finite member and the same members
    non-finite: the identity padding to NP, the row map, the panels with
    their pivot rows formed first and the composed unswap keep every
    element's operations in the plain order.  A general draw with one
    singular member (rank 1, or 0 at n = 1), and a draw of small integers
    in [-2, 2] (exact ties decide the pivots; a member may be singular)."""
    rng = np.random.default_rng(4000 + n)
    if draw == "general":
        a = rng.standard_normal((3, n, n)).astype(np.float32)
        a[1] = 1.0 if n > 1 else 0.0
    else:
        a = rng.integers(-2, 3, (3, n, n)).astype(np.float32)
    at = torch.tensor(a)
    x = _k7_schedule_replay(at)
    ref = gj.gauss_jordan_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if draw == "general":
        assert finite.tolist() == [True, False, True]
    assert torch.equal(x[finite], ref[finite])


@pytest.mark.parametrize("mutant", ["reversed_steps", "unordered_pivot_rows"])
def test_k7_schedule_replay_catches_a_broken_order(mutant, one_thread):
    """The replay is sharp enough to hold the kernel's order: a panel's
    steps taken last first outside the panel, or pivot rows formed without
    the panel's earlier steps, change bits of the result."""
    a = torch.tensor(np.random.default_rng(4020).standard_normal(
        (3, 20, 20)).astype(np.float32))
    ref = gj.gauss_jordan_plain(a)
    assert torch.equal(_k7_schedule_replay(a), ref)
    assert not torch.equal(_k7_schedule_replay(a, mutant), ref)


def test_k7_probe_patches_match_the_kernel_source():
    """The card probe of K7 (``bench/gj_probe.py``) builds its stamped
    variant by patching ``csrc/gauss_jordan.cu``: the source holds every
    anchor of the current design's patches as often as the probe expects
    (and so is probed as that design), the names its occupancy reader and
    launcher call are the source's, and the probe refuses to run without a
    card."""
    from cuda_matrix_inversion_tpu_torch.bench import gj_probe
    from cuda_matrix_inversion_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "gauss_jordan.cu").read_text()
    for anchor, _, count in gj_probe.DESIGNS["tiles"]["stamps"]:
        assert src.count(anchor) == count, anchor
    assert gj_probe.design_of(cuda_build.CSRC_DIR) == "tiles"
    for name in ("const void* gj_kernel_for(int n)", "size_t gj_smem(int n)",
                 "int gj_threads(int n)"):
        assert src.count(name) == 1, name
    assert all(len(d["steps"]) <= 16 for d in gj_probe.DESIGNS.values())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            gj_probe.main()
