"""K2's cluster instance (``csrc/lu_band.cu``, 129 ≤ n ≤ 256) on the CPU:
its schedule replayed in plain PyTorch against ``lu_inverse_plain`` bit for
bit, the ``lu_pallas`` lane in the band against the JAX package's
``pallas_lu.inverse_lu`` in interpret mode, the routes around the band,
and the card probe's patches.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on).  The replay and the plain version are thousands of small tensor
operations: each test runs PyTorch on one thread (``one_thread``), so
that parallel workers do not oversubscribe the cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu.ops import pallas_lu as jax_pallas_lu
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_lu,
    linalg,
    lu_bign,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

# Port and JAX factor with the same pivots and the same fp32 operations in
# another order (JAX's rows stay in place and are gathered by one-hot
# products; its polish residual is fp32, the port's fp64): both land
# within κ·ε₃₂ of A⁻¹ on the κ = 500 class.
LU_RTOL = 1e-4


@pytest.fixture
def one_thread():
    """The replay runs thousands of small tensor ops on one thread.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _k2_band_replay(a: torch.Tensor, mutant: str | None = None):
    """K2's cluster schedule (``csrc/lu_band.cu``) in plain PyTorch,
    float32, each step an unfused mul then sub.  The batch padded with the
    identity to NP (160, 192, 224, 256); C = NP / 32 slabs, slab c holding
    W's columns [32c, 32c + 32) and the same columns of Y = I, rows by
    position.  Each 4-column panel is factored by its owner in a mirror,
    rows by slot (the first maximum by position, NaN never winning; the
    rows never move in the mirror; each column's step on the panel's
    columns), then pushed (copied) to every slab, which gathers the rows
    the panel's swaps moved (whole rows), takes the factored panel (the
    owner), forms U12 on the quads past the panel (row r taking the
    panel's earlier steps in order) and gives the rows past the panel its
    4 steps in order, on W's columns past the panel and on all of Y.  Then
    U by blocks of 4 columns into a workspace, and each slab's back pass
    by blocks of 4 rows descending: the triangle (each row's terms last
    first, then its quotient), then the block's 4 terms on the rows above,
    last first.  ``mutant`` breaks one order: ``"u12"`` (U12's steps
    reversed) or ``"back"`` (the block's terms on the rows above first
    first).  Returns ``(A⁻¹, ipiv)`` cut to n."""
    batch, n, _ = a.shape
    np_ = cuda_lu.band_np(n)
    rows = torch.arange(batch)
    full = torch.eye(np_).repeat(batch, 1, 1)
    full[:, :n, :n] = a
    eye = torch.eye(np_)
    slabs = [torch.cat([full[:, :, 32 * c:32 * c + 32],
                        eye[:, 32 * c:32 * c + 32].repeat(batch, 1, 1)], 2)
             for c in range(np_ // 32)]
    ipiv = torch.empty((batch, np_), dtype=torch.int32)
    for g in range(np_ // 4):
        k0, owner, pq = 4 * g, g // 8, g % 8
        # the owner's mirror, and which slot sits at each position
        mirror = slabs[owner][:, :, 4 * pq:4 * pq + 4].clone()
        slot_at = torch.arange(np_).repeat(batch, 1)
        for h in range(4):
            j = k0 + h
            col = mirror[rows[:, None], slot_at[:, j:], h]
            mag = torch.nan_to_num(col.abs(), nan=-1.0)
            p = torch.where(mag.max(1).values >= 0, j + mag.argmax(1),
                            torch.full_like(rows, j))
            ipiv[:, j] = p.to(torch.int32)
            sp, sj = slot_at[rows, p].clone(), slot_at[rows, j].clone()
            slot_at[rows, j], slot_at[rows, p] = sp, sj
            past = slot_at[:, j + 1:]
            l = mirror[rows[:, None], past, h] / mirror[rows, sp, h][:, None]
            mirror[rows[:, None], past, h] = l
            for e in range(h + 1, 4):
                mirror[rows[:, None], past, e] = (
                    mirror[rows[:, None], past, e]
                    - l * mirror[rows, sp, e][:, None])
        lpos = mirror[rows[:, None], slot_at]  # the panel by position
        for c, slab in enumerate(slabs):  # each slab applies the push
            slab[:] = slab[rows[:, None], slot_at]
            if c == owner:
                slab[:, k0:, 4 * pq:4 * pq + 4] = lpos[:, k0:]
            act = slice(4 * min(max(g + 1 - 8 * c, 0), 8), 64)
            for r in range(1, 4):
                steps = reversed(range(r)) if mutant == "u12" else range(r)
                for h in steps:
                    slab[:, k0 + r, act] = (slab[:, k0 + r, act]
                                            - lpos[:, k0 + r, h:h + 1]
                                            * slab[:, k0 + h, act])
            for h in range(4):
                slab[:, k0 + 4:, act] = (slab[:, k0 + 4:, act]
                                         - lpos[:, k0 + 4:, h:h + 1]
                                         * slab[:, k0 + h:k0 + h + 1, act])
    ws = torch.cat([slab[:, :, :32] for slab in slabs], 2)  # L\\U
    ys = []
    for slab in slabs:
        y = slab[:, :, 32:].clone()
        for r0 in range(np_ - 4, -1, -4):
            for i in reversed(range(r0, r0 + 4)):
                for kk in reversed(range(i + 1, r0 + 4)):
                    y[:, i] = y[:, i] - ws[:, i, kk:kk + 1] * y[:, kk]
                y[:, i] = y[:, i] / ws[:, i, i:i + 1]
            terms = range(r0, r0 + 4) if mutant == "back" else reversed(
                range(r0, r0 + 4))
            for kk in terms:
                y[:, :r0] = y[:, :r0] - ws[:, :r0, kk:kk + 1] * y[:, kk:kk + 1]
        ys.append(y)
    return torch.cat(ys, 2)[:, :n, :n], ipiv[:, :n]


def _draw(n, draw):
    """A general draw with member 1 singular (rank 1), or small integers in
    [-2, 2] (exact ties decide the pivots; a member may be singular)."""
    rng = np.random.default_rng(5000 + n)
    if draw == "general":
        a = rng.standard_normal((3, n, n)).astype(np.float32)
        a[1] = 1.0
        return a
    return rng.integers(-2, 3, (3, n, n)).astype(np.float32)


@pytest.mark.parametrize("draw", ["general", "ties"])
@pytest.mark.parametrize("n", [129, 160, 200, 224, 256])
def test_k2_band_schedule_is_bitwise_the_plain_order(n, draw, one_thread):
    """The cluster schedule against :func:`cuda_lu.lu_inverse_plain`:
    ``inv`` and ``ipiv`` equal (``torch.equal``) on every finite member
    and the same members non-finite.  The identity padding, the forward
    pass folded into the factor (Y = I taking every swap and step), the
    panels pushed to the slabs and the back pass by blocks keep every
    element's terms in the plain order."""
    at = torch.tensor(_draw(n, draw))
    x, piv = _k2_band_replay(at)
    ref, ref_piv = cuda_lu.lu_inverse_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if draw == "general":
        assert finite.tolist() == [True, False, True]
    assert torch.equal(x[finite], ref[finite])
    assert torch.equal(piv[finite], ref_piv[finite])


@pytest.mark.parametrize("mutant", ["u12", "back"])
def test_k2_band_replay_catches_a_broken_order(mutant, one_thread):
    """The replay's comparison sees one reordered step: U12's steps, or the
    back pass's terms, in the other order change bits."""
    at = torch.tensor(_draw(160, "general"))
    x, _ = _k2_band_replay(at, mutant)
    ref, _ = cuda_lu.lu_inverse_plain(at)
    assert not torch.equal(x[0], ref[0])


@pytest.mark.parametrize("n", [136, 160])
def test_lu_pallas_in_the_band_matches_jax(n, one_thread):
    """``lu_pallas`` at n = 136 (padded to NP = 160) and 160 on the κ = 500
    class against JAX's one-launch kernel in interpret mode: both through
    the gate, and agreement to :data:`LU_RTOL`."""
    a = fixtures.make_nonsym_cond(2, n, 500.0, np.random.default_rng(n + 1))
    ref = np.asarray(jax_pallas_lu.inverse_lu(jnp.asarray(a), block=1,
                                              interpret=True))
    x = get_inverse_algorithm("lu_pallas")(torch.tensor(a)).numpy()
    assert x.dtype == np.float32 and x.shape == a.shape
    assert identity_error_inf(a, ref) < 1e-4
    assert identity_error_inf(a, x) < 1e-4
    assert np.abs(x - ref).max() / np.abs(ref).max() <= LU_RTOL


@pytest.mark.parametrize("n", [129, 256, 257])
def test_lu_pallas_routes_around_the_band(n, one_thread):
    """On a CPU tensor the lane runs K2's plain version and the fp64
    polish at 129 ≤ n ≤ 256, the blocked LU past 256, and launches no
    kernel; float64 takes the library route."""
    a = torch.tensor(fixtures.make_nonsym_cond(2, n, 100.0,
                                               np.random.default_rng(n)))
    counts = (cuda_lu.lu_inverse_cuda.launches,
              cuda_lu.lu_inverse_cuda.band_launches,
              lu_bign.lu_panel_cuda.launches)
    x = cuda_lu.inverse_lu(a)
    if n <= cuda_build.LU_MAX_N:
        x0 = cuda_lu.lu_inverse_plain(a)[0]
        route = x0 + x0 @ linalg.residual_f64(a, x0)
    else:
        route = lu_bign.inverse_lu_big(a)
    assert torch.equal(x, route)
    assert (cuda_lu.lu_inverse_cuda.launches,
            cuda_lu.lu_inverse_cuda.band_launches,
            lu_bign.lu_panel_cuda.launches) == counts
    assert identity_error_inf(a.numpy(), x.numpy()) < 1e-4
    a64 = a.double()
    assert torch.equal(cuda_lu.inverse_lu(a64), linalg.inverse_lu(a64))


def test_lu_hiacc_seeded_in_the_band(one_thread):
    """``lu_hiacc`` at n = 200 (its ``lu_pallas`` seed in the band) holds
    its fp64 contract at κ = 500: max |I − AX| ≤ 1e-11."""
    a = fixtures.make_nonsym_cond(3, 200, 500.0,
                                  np.random.default_rng(2031)).astype(
                                      np.float64)
    x = get_inverse_algorithm("lu_hiacc")(torch.tensor(a)).numpy()
    assert x.dtype == np.float64
    assert np.abs(np.eye(200) - a @ x).max() <= 1e-11


def test_band_kernel_checks_on_the_cpu():
    """The wrapper takes n up to 256 and raises past it; a CPU tensor never
    reaches the library (there is none to build here)."""
    with pytest.raises(ValueError, match="256"):
        cuda_lu.lu_inverse_cuda(torch.zeros(1, 257, 257))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lu.lu_inverse_cuda(torch.zeros(1, 200, 200))
    assert [cuda_lu.band_np(n) for n in (129, 160, 161, 192, 193, 224, 225,
                                         256)] == [160, 160, 192, 192, 224,
                                                   224, 256, 256]
    src = (cuda_build.CSRC_DIR / "lu_band.cu").read_text()
    assert ("return n <= 160 ? 160 : n <= 192 ? 192 : n <= 224 ? 224 : 256;"
            in src)


def test_lu_band_probe_patches_match_the_kernel_source():
    """The card probe of the cluster instance (``bench/lu_band_probe.py``)
    stamps a clock split into a copy of ``csrc/lu_band.cu``: every anchor
    of its patches occurs as often as the probe expects, every stamp id
    has a step name, the names its reader calls are the source's, and the
    probe refuses to run without a card."""
    import re

    from cuda_matrix_inversion_tpu_torch.bench import lu_band_probe

    src = (cuda_build.CSRC_DIR / "lu_band.cu").read_text()
    for anchor, new, count in lu_band_probe.STAMPS:
        assert src.count(anchor) == count, anchor
        for step in re.findall(r"lb_step\((\d+)\)", new):
            assert int(step) < len(lu_band_probe.STEPS)
    for name in ("lu_band_kernel", "struct LuBand", "int lu_band_np(int n)",
                 "cudaError_t launch_lu_band("):
        assert name in src, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            lu_band_probe.main()
