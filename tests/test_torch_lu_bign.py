"""The port's blocked LU (K9's plain version and the blocked LU around it) against the
JAX package's ``ops/lu_bign.py`` in interpret mode, at the shapes of
``tests/test_lu_bign.py``; ``lu_pallas`` past n = 128 (K2's cluster
instance up to 256, the blocked LU past it) against JAX's ``inverse_lu``;
the panel-width rule and the shared-memory ceiling.

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
    # the ceilings of the kernel's source note, one row past each fails
    for pw, ceiling in ((64, 847), (32, 1607), (16, 2899), (8, 6449)):
        assert lu_bign.panel_smem_bytes(ceiling, pw) <= lu_bign.MAX_SMEM
        assert lu_bign.panel_smem_bytes(ceiling + 1, pw) > lu_bign.MAX_SMEM
    assert [lu_bign.panel_ld(pw) for pw in (64, 32, 16, 8)] == [68, 36, 20, 9]


def _old_panel_smem_bytes(n, pw):
    """K9's shared memory before the row-map design: the panel and the
    two pw × pw triangles at an odd stride."""
    ld = pw + 1 if pw % 2 == 0 else pw
    return (n * ld + 2 * pw * ld + 8) * 4 + (8 + pw) * 4


def test_every_n_the_old_ceilings_served_still_runs():
    """The 4·odd stride moved the row ceilings (pw 32 from 1695 to 1607,
    pw 16 from 3384 to 2899); pick_pw must still serve every n that the
    old shared-memory rule served, at a narrower panel where needed."""
    for n in range(16, 6500):
        old = any(2 * pw <= n and _old_panel_smem_bytes(
            -(-n // pw) * pw, pw) <= lu_bign.MAX_SMEM for pw in (64, 32, 16))
        old |= _old_panel_smem_bytes(-(-n // 8) * 8, 8) <= lu_bign.MAX_SMEM
        if old:
            pw = lu_bign.pick_pw(n)
            assert lu_bign.panel_smem_bytes(-(-n // pw) * pw,
                                            pw) <= lu_bign.MAX_SMEM, n


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
    """``lu_pallas`` past n = 128: at 160 K2's cluster instance (on the CPU
    its plain version) and the fp64 polish, at 300 the blocked LU; JAX
    serves 160 with its one-launch kernel and 300 with the XLA LU in
    interpret mode.  The κ = 500 class (the κ ≈ 4n class sits on the fp32
    floor at this n).  The port polishes with an fp64 residual and passes
    the gate; JAX's fp32 residual sits on the floor at n = 300 on the CPU
    (1.1e-4), so only the port is gated there."""
    a = fixtures.make_nonsym_cond(2, n, 500.0, np.random.default_rng(n))
    ref = np.asarray(jax_pallas_lu.inverse_lu(jnp.asarray(a), block=1,
                                              interpret=True))
    before = cuda_lu.lu_inverse_cuda.launches, lu_bign.lu_panel_cuda.launches
    x = get_inverse_algorithm("lu_pallas")(torch.tensor(a)).numpy()
    assert (cuda_lu.lu_inverse_cuda.launches,
            lu_bign.lu_panel_cuda.launches) == before
    if n <= 256:
        x0 = cuda_lu.lu_inverse_plain(torch.tensor(a))[0]
        route = x0 + x0 @ linalg.residual_f64(torch.tensor(a), x0)
    else:
        route = lu_bign.inverse_lu_big(torch.tensor(a))
    np.testing.assert_array_equal(x, route.numpy())
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
    and runs K2's plain version (its cluster instance's on the card) and
    the fp64 polish on the CPU."""
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


def _schedule_replay(work, perm, k0, pw):
    """K9's schedule in plain PyTorch, updating ``work`` and ``perm`` in
    place as :func:`lu_bign.lu_panel_plain` does: rows stay in their slots
    and carry their positions (a pivot swap moves two positions); the
    first maximum by position, NaN never winning; each column's step on
    the rows past it, unfused mul then sub, blocked by 4 columns at the
    templated widths 16, 32 and 64 (the block's columns at once, the
    columns past it at the block's end: its pivot rows first, then the
    other rows), on the whole row at once at any other width (the generic
    instance); the swaps composed into one row
    map (from the pivot slots and the slots that left the block) and
    applied as one gather; the triangles by column, each element's terms
    in the plain order from its warp's first column (the zero terms before
    its own column change nothing).  Returns ``(ipiv, ldi, udi)``."""
    batch, n = work.shape[0], work.shape[-1]
    m = n - k0
    templated = pw in (16, 32, 64)
    b = torch.arange(batch)
    pan = work[:, k0:, k0:k0 + pw].clone()  # slot s = local row s
    pos = torch.arange(m).repeat(batch, 1)
    piv_slot = torch.empty((batch, pw), dtype=torch.long)
    slot_at = torch.arange(pw).repeat(batch, 1)  # the kernel's, j < pw
    ipiv = torch.empty((batch, pw), dtype=torch.int32)
    for j in range(pw):
        mag = torch.nan_to_num(pan[:, :, j].abs(), nan=-1.0)
        mag = torch.where(pos >= j, mag, torch.full_like(mag, -1.0))
        best = mag.max(1).values
        found = best >= 0
        key = torch.where(mag == best[:, None], pos, m)
        sj = (pos == j).int().argmax(1)
        assert torch.equal(slot_at[:, j], sj)
        sp = torch.where(found, key.argmin(1), sj)
        p = torch.where(found, pos[b, sp], j)
        inside = (p != j) & (p < pw)
        slot_at[b[inside], p[inside]] = sj[inside]
        piv_slot[:, j] = sp
        ipiv[:, j] = (k0 + p).int()
        pos[b, sj] = p
        pos[b, sp] = j
        # column j's step on the rest of its block of 4 columns (on the
        # rest of the row at the generic instance's widths)
        b4 = j - j % 4
        prow = pan[b, sp]
        l = pan[:, :, j] / prow[:, j:j + 1]
        blk = slice(j + 1, b4 + 4 if templated else pw)
        new = pan[:, :, blk] - l[:, :, None] * prow[:, None, blk]
        past = pos > j
        pan[:, :, blk] = torch.where(past[:, :, None], new, pan[:, :, blk])
        pan[:, :, j] = torch.where(past, l, pan[:, :, j])
        if templated and j % 4 == 3 and j + 1 < pw:
            # the block's pivot rows past it, each taking the steps of the
            # block's earlier columns in order; then the other rows past the
            # block take its 4 steps in order
            rest = slice(j + 1, pw)
            sps = piv_slot[:, b4:j + 1]
            for i in range(1, 4):
                for h in range(i):
                    pan[b, sps[:, i], rest] = (
                        pan[b, sps[:, i], rest]
                        - pan[b, sps[:, i], b4 + h][:, None]
                        * pan[b, sps[:, h], rest])
            for h in range(4):
                new = (pan[:, :, rest] - pan[:, :, b4 + h, None]
                       * pan[b, sps[:, h], rest][:, None, :])
                pan[:, :, rest] = torch.where(past[:, :, None], new,
                                              pan[:, :, rest])
    # the row map: position i < pw from the pivot slots, a slot s < pw
    # whose position ended at pw or past holds row s there
    sigma = torch.arange(m).repeat(batch, 1)
    sigma[:, :pw] = piv_slot
    for s in range(pw):
        left = pos[:, s] >= pw
        sigma[b[left], pos[left, s]] = s
    assert torch.equal(sigma, torch.argsort(pos, dim=1))
    rows = k0 + sigma
    outside = torch.cat([torch.arange(k0), torch.arange(k0 + pw, n)])
    moved = work[b[:, None, None], rows[:, :, None], outside[None, None, :]]
    work[:, k0:, :k0] = moved[:, :, :k0]
    work[:, k0:, k0 + pw:] = moved[:, :, k0:]
    perm[:, k0:] = perm[b[:, None], rows]
    work[b[:, None], k0 + pos, k0:k0 + pw] = pan  # slot s to its position
    d = work[:, k0:k0 + pw, k0:k0 + pw]
    # the triangles by column: a warp runs its columns' terms from its
    # smallest column down (L11^-1) or its largest up (U11^-1), 32 columns
    # to a warp; each element takes them in the plain order
    c = torch.arange(pw)
    kmin, kmax = c & ~31, torch.clamp(c | 31, max=pw - 1)
    rows = torch.arange(pw)[:, None]
    y = torch.eye(pw).repeat(batch, 1, 1)
    for k in range(pw):  # k ascending: y_i -= d[i][k] y_k for i > k
        take = (rows > k) & (k >= kmin)
        y = torch.where(take, y - d[:, :, k:k + 1] * y[:, k:k + 1, :], y)
    z = torch.eye(pw).repeat(batch, 1, 1)
    for kk in range(pw - 1, -1, -1):  # kk descending: divide, then the rest
        z[:, kk, :] = z[:, kk, :] / d[:, kk, kk:kk + 1]
        take = (rows < kk) & (kk <= kmax)
        z = torch.where(take, z - d[:, :, kk:kk + 1] * z[:, kk:kk + 1, :], z)
    return ipiv, y, z


@pytest.mark.parametrize("pw", [16, 32, 64, 8, 24])
@pytest.mark.parametrize("n", [None, 160, 320])
def test_panel_schedule_is_bitwise_the_plain_order(pw, n):
    """K9's schedule against :func:`lu_bign.lu_panel_plain`, every output
    bitwise, at each panel of the blocked factor (n = 2·pw, 160 padded to
    192 at pw = 64 and to 168 at 24, 320 padded to 336 at 24), at the
    templated widths and at two of the generic instance's (8, the width
    pick_pw takes from n = 2897 on, and 24): a general draw, a draw of
    small integers
    (exact ties decide the pivots), and one member with a zero column in
    the first panel, which alone comes out non-finite."""
    n = n or 2 * pw
    n_pad = -(-n // pw) * pw
    rng = np.random.default_rng(1000 * pw + n)
    draws = [rng.standard_normal((3, n, n)),
             rng.integers(-2, 3, (3, n, n)).astype(np.float64)]
    single = rng.standard_normal((3, n, n))
    single[1, :, 5] = 0.0
    draws.append(single)
    for a in draws:
        work = torch.eye(n_pad).repeat(3, 1, 1)
        work[:, :n, :n] = torch.tensor(a, dtype=torch.float32)
        perm = torch.arange(n_pad, dtype=torch.int32).repeat(3, 1)
        ref_work, ref_perm = work.clone(), perm.clone()
        for k0 in range(0, n_pad, pw):
            got = _schedule_replay(work, perm, k0, pw)
            ref = lu_bign.lu_panel_plain(ref_work, ref_perm, k0, pw)
            good = torch.isfinite(ref_work).all(dim=2).all(dim=1)
            assert torch.equal(good, torch.isfinite(work).all(2).all(1))
            for x, r in zip((work, perm, *got), (ref_work, ref_perm, *ref)):
                assert torch.equal(x[good], r[good])
            if good.all():
                continue
            # the zero column's member: replay and plain both diverge, on
            # their own inputs from here on; keep the finite members' path
            work[~good], perm[~good] = ref_work[~good], ref_perm[~good]
        assert good.tolist() == [True, a is not single, True]


def test_lu_probe_patches_match_the_kernel_source():
    """The card probe of K9 (``bench/lu_probe.py``) builds its stamped
    variant by patching ``csrc/lu_bign.cu``: every anchor of its patches
    occurs as often as the probe expects, the occupancy reader's names are
    the source's, and the probe refuses to run without a card."""
    from cuda_matrix_inversion_tpu_torch.bench import lu_probe
    from cuda_matrix_inversion_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "lu_bign.cu").read_text()
    for anchor, _, count in lu_probe.STAMPS:
        assert src.count(anchor) == count, anchor
    for name in ("panel_kernel_for(int pw)", "size_t panel_smem(int m",
                 "constexpr int kThreads"):
        assert src.count(name) == 1, name
    assert len(lu_probe.STEPS) <= 15  # slot 15: the slowest thread's gather
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            lu_probe.main()
