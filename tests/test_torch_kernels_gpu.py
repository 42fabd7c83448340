"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built for
``sm_90a``) and skip elsewhere.  The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run them there with::

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_nonsym_cond,
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    cuda_gauss_jordan,
    cuda_gp,
    cuda_gp_lml,
    cuda_lu,
    lu_bign,
    newton_schulz,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    LANES,
    get_inverse_algorithm,
)

pytestmark = pytest.mark.gpu

# kernel vs plain version, max-norm relative: both iterate with bf16
# products and differ only in summation order; each lands within its
# residual (~2e-5 at the κ edge) of A⁻¹
K1_RTOL = 2e-4
# K2 repeats the plain version's operations in the same order: its raw
# inverse and pivots are compared with torch.equal (see _check_k2)
# K3/K4: both fp32, the same operations (K3's WᵀW in another summation
# order), on SPD draws with κ ≈ 2–3
CHOL_RTOL = 1e-5
# K5: the same factor and substitution; the two dot products differ in
# summation order
K5_ATOL = 1e-5
# K6: K1's arithmetic (2e-4 relative on K⁻¹-derived values), and the JAX
# test's 1e-4 absolute on mean and var
K6_RTOL = 2e-4
K6_ATOL = 1e-4
# K7 repeats the plain version's operations in the same order: its raw
# inverse is compared with torch.equal (see _check_k7)
# K8 / K11: K1's arithmetic from a warm start, 2e-4 relative as K1
WARM_RTOL = 2e-4
# K10: the same factor and substitution as K5 / K3 (bitwise on the card);
# quad, logdet and α differ only in summation order
LML_RTOL = 1e-5
# K9 repeats its plain version's operations in order (IEEE division, no FMA
# contraction): the factors, pivots and triangle inverses come out equal
# (compared with torch.equal), and so do the two blocked LUs' outputs,
# which run the same cuBLAS products
K9_RTOL = 0.0

_K1_LANES = ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
             "newton_schulz_pallas", "newton_schulz_pan500_pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written sm_90a kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _check_k1(cuda, a, sched):
    """K1 against its plain version on ``a`` (float32 NumPy), in one
    launch, and through the gate."""
    at = torch.tensor(a, device=cuda)
    before = newton_schulz.ns_iterate_cuda.launches
    x = newton_schulz.ns_iterate_cuda(at, sched)
    torch.cuda.synchronize()
    assert newton_schulz.ns_iterate_cuda.launches == before + 1
    ref = newton_schulz.ns_iterate_plain(at, sched, bf16_products=True)
    assert _rel(x.cpu(), ref.cpu()) <= K1_RTOL
    assert identity_error_inf(a, x.cpu().numpy()) < 1e-4


@pytest.mark.parametrize("lane", _K1_LANES)
@pytest.mark.parametrize("n", [8, 20, 64, 128, 1, 40, 72, 127])
def test_k1_matches_plain(cuda, lane, n):
    """Every lane at each tile size (NP = 16, 32, 64, 128: two warps own
    tiles at 16), with zero padding where n is not a multiple of 16."""
    rng = np.random.default_rng(n)
    a = make_spd_batch(7, n, rng).astype(np.float32)
    _check_k1(cuda, a, LANES[lane]["schedule"])


def test_k1_matches_plain_at_1600x128(cuda):
    """Every lane at the main path's largest batch (13 waves of one block
    an SM)."""
    a = make_spd_batch(1600, 128, np.random.default_rng(1601)).astype(
        np.float32)
    for lane in _K1_LANES:
        _check_k1(cuda, a, LANES[lane]["schedule"])


@pytest.mark.parametrize("n", [64, 128])
def test_k1_matches_plain_past_32_lo_rounds(cuda, n):
    """The pan lane at 40 lo rounds: the kernel reads its per-round scalars
    from device memory, so any count runs (it took 32 at most when they
    were kernel parameters)."""
    a = make_spd_batch(7, n, np.random.default_rng(450 + n)).astype(
        np.float32)
    sched = newton_schulz.resolve_schedule(lo_iters=40, init="pan")
    assert len(sched.coeffs) == 40
    _check_k1(cuda, a, sched)


@pytest.mark.parametrize("init", ["spd", "pan"])
@pytest.mark.parametrize("n", [20, 72, 128])
def test_k1_polish_highest_false_matches_plain(cuda, init, n):
    """polish_highest=False: every polish residual is the 3-pass split,
    and the fp32 X still leaves the loop for the write."""
    a = make_spd_batch(7, n, np.random.default_rng(500 + n)).astype(
        np.float32)
    _check_k1(cuda, a, newton_schulz.resolve_schedule(
        init=init, polish_highest=False))


def _check_k2(cuda, a, bad=None, gate=True):
    """K2's raw outputs against :func:`cuda_lu.lu_inverse_plain` on ``a``
    (float32 NumPy), in one launch (past n = 128 counted as a launch of
    the cluster instance): ``inv`` and ``ipiv`` equal (``torch.equal``) on
    every finite member and the same members non-finite (``bad``, where
    given); the ``lu_pallas`` lane on the finite members through the gate,
    without a K9 launch."""
    at = torch.tensor(a, device=cuda)
    fn = cuda_lu.lu_inverse_cuda
    before = (fn.launches, fn.band_launches)
    x, piv = fn(at)
    torch.cuda.synchronize()
    band = int(a.shape[-1] > cuda_build.MAX_N)
    assert (fn.launches, fn.band_launches) == (before[0] + 1,
                                               before[1] + band)
    ref, ref_piv = cuda_lu.lu_inverse_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if bad is not None:
        assert (~finite).nonzero().flatten().tolist() == list(bad)
    assert torch.equal(x[finite], ref[finite])
    assert torch.equal(piv[finite], ref_piv[finite])
    if gate:
        keep = finite.cpu().numpy()
        before = lu_bign.lu_panel_cuda.launches
        polished = get_inverse_algorithm("lu_pallas")(at).cpu().numpy()
        assert lu_bign.lu_panel_cuda.launches == before
        assert identity_error_inf(a[keep], polished[keep]) < 1e-4


@pytest.mark.parametrize("kind", ["general", "permuted", "singular"])
@pytest.mark.parametrize("n", [8, 20, 64, 128, 1, 7, 40, 72, 127])
def test_k2_matches_plain(cuda, kind, n):
    """Every template instance (n ≤ 16, 32, 64, 128), n off a multiple of
    4 (scalar loads and stores) and padded to the instance; one singular
    member (rank 1, or 0 at n = 1) alone non-finite."""
    rng = np.random.default_rng(100 + n)
    a = make_square_batch(7, n, rng).astype(np.float32)
    if kind == "permuted":
        a = a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    if kind == "singular":
        a[3] = 1.0 if n > 1 else 0.0
    _check_k2(cuda, a, bad=[3] if kind == "singular" else [])


@pytest.mark.parametrize("n", [7, 20, 64, 128])
def test_k2_matches_plain_on_ties(cuda, n):
    """Small integers in [-2, 2]: exact ties decide the pivots (the first
    maximum by position), and some members may be singular."""
    a = np.random.default_rng(300 + n).integers(-2, 3, (7, n, n)).astype(
        np.float32)
    _check_k2(cuda, a, gate=False)


def test_k2_matches_plain_at_1600x128(cuda):
    """The main path's largest batch, the general class (13 waves at one
    block an SM)."""
    a = make_square_batch(1600, 128, np.random.default_rng(1602)).astype(
        np.float32)
    _check_k2(cuda, a, bad=[])


@pytest.mark.parametrize("kind", ["general", "singular", "nan"])
@pytest.mark.parametrize("n", [129, 136, 160, 192, 200, 224, 255, 256, 161,
                               193, 225])
def test_k2_band_matches_plain(cuda, kind, n):
    """Every cluster instance (NP = 160, 192, 224, 256: 5 to 8 CTAs), n
    off a multiple of 4 (scalar loads and stores) and padded to NP (161,
    193, 225: 31 rows of padding in the last slab); one singular member
    (rank 1) or one member holding a NaN alone non-finite."""
    rng = np.random.default_rng(900 + n)
    a = make_square_batch(7, n, rng).astype(np.float32)
    if kind == "singular":
        a[3] = 1.0
    if kind == "nan":
        a[3, n // 2, n - 1] = np.nan
    _check_k2(cuda, a, bad=[] if kind == "general" else [3])


@pytest.mark.parametrize("n", [129, 160, 192, 224, 256])
def test_k2_band_matches_plain_on_ties(cuda, n):
    """Small integers in [-2, 2]: exact ties decide the pivots (the first
    maximum by position); a member may be singular."""
    a = np.random.default_rng(950 + n).integers(-2, 3, (7, n, n)).astype(
        np.float32)
    ref = cuda_lu.lu_inverse_plain(torch.tensor(a))[0]
    bad = (~torch.isfinite(ref).all(dim=(1, 2))).nonzero().flatten()
    _check_k2(cuda, a, bad=bad.tolist(), gate=False)


@pytest.mark.parametrize("batch", [1, 37, 1600])
def test_k2_band_matches_plain_at_256(cuda, batch):
    """NP = 256 (clusters of 8 CTAs) on one matrix, on 37 (no multiple of
    the clusters the card holds at once) with member 18 singular, and on
    the main path's largest batch."""
    a = make_square_batch(batch, 256, np.random.default_rng(980 + batch)
                          ).astype(np.float32)
    if batch == 37:
        a[18] = 1.0
    _check_k2(cuda, a, bad=[18] if batch == 37 else [])


def test_k2_band_matches_plain_at_1600x160(cuda):
    """NP = 160 on the main path's largest batch: clusters of 5 CTAs, many
    at once on the card, member 800 singular."""
    a = make_square_batch(1600, 160, np.random.default_rng(1660)).astype(
        np.float32)
    a[800] = 1.0
    _check_k2(cuda, a, bad=[800])


def test_lu_pallas_band_runs_k2(cuda):
    """At 129 ≤ n ≤ 256 the ``lu_pallas`` lane, its engine's 256 bucket
    and the ``lu_hiacc`` seed launch K2's cluster instance once a call,
    never K9."""
    from cuda_matrix_inversion_tpu_torch import InversionEngine

    a = make_nonsym_cond(5, 200, 500.0, np.random.default_rng(201))
    fn = cuda_lu.lu_inverse_cuda
    before = (fn.band_launches, lu_bign.lu_panel_cuda.launches)
    x = get_inverse_algorithm("lu_pallas")(torch.tensor(a, device=cuda))
    eng = InversionEngine(algorithm="lu_pallas", device=cuda)
    y = eng.inverse(a)
    z = get_inverse_algorithm("lu_hiacc")(torch.tensor(
        a.astype(np.float64), device=cuda))
    torch.cuda.synchronize()
    assert (fn.band_launches, lu_bign.lu_panel_cuda.launches) == (
        before[0] + 3, before[1])
    assert eng.compiled_shapes == [(8, 256)]
    assert identity_error_inf(a, x.cpu().numpy()) < 1e-4
    assert identity_error_inf(a, y) < 1e-4
    eye = np.eye(200)
    assert np.abs(eye - a.astype(np.float64) @ z.cpu().numpy()).max() <= 1e-11


def _check_cholesky_kernels(cuda, batch, n, seed):
    """K4 and K3 against their plain versions; member 3 is indefinite and
    is the only non-finite one.  K4's L is bitwise the plain version's on
    every positive definite member: the panel schedule gives each element
    the plain version's operations in the same order."""
    a = make_spd_batch(batch, n, np.random.default_rng(seed)
                       ).astype(np.float32)
    a[3] = -a[3]
    at = torch.tensor(a, device=cuda)
    l = cuda_cholesky.cholesky_cuda(at)
    x = cuda_cholesky.inverse_cholesky_cuda(at)
    torch.cuda.synchronize()
    ok = np.arange(batch) != 3
    l_ref = cuda_cholesky.cholesky_plain(at)
    keep = torch.from_numpy(ok).to(cuda)
    assert torch.equal(l[keep], l_ref[keep])
    for out, ref in ((l, l_ref),
                     (x, cuda_cholesky.inverse_cholesky_plain(at))):
        out, ref = out.cpu().numpy(), ref.cpu().numpy()
        assert (np.isfinite(out).all(axis=(1, 2)) == ok).all()
        assert (np.isfinite(ref).all(axis=(1, 2)) == ok).all()
        assert _rel(out[ok], ref[ok]) <= CHOL_RTOL
    x = x.cpu().numpy()
    assert np.array_equal(x[ok], np.swapaxes(x[ok], 1, 2))
    assert identity_error_inf(a[ok], x[ok]) < 1e-4
    assert (np.triu(l.cpu().numpy()[ok], 1) == 0).all()


@pytest.mark.parametrize("n", [8, 20, 64, 128, 1, 11, 72, 127])
def test_cholesky_kernels_match_plain(cuda, n):
    """K4 and K3 at 7 members; n = 1, 11, 72 and 127 leave a partial last
    panel."""
    _check_cholesky_kernels(cuda, 7, n, 200 + n)


def test_cholesky_kernels_match_plain_at_1600x128(cuda):
    """K4 and K3 at the main path's large batch: three K4 blocks an SM and
    many waves."""
    _check_cholesky_kernels(cuda, 1600, 128, 1600)


@pytest.mark.parametrize("n", [8, 20, 64, 72, 128])
def test_gp_kernels_match_plain(cuda, n):
    """K5 and K6 against their plain versions and the fp64 closed form;
    system 3 is negative definite and is the only non-finite one.  n = 20
    and 72 leave zero padding in K6's 16-multiple tiles."""
    g = make_gp_batch(7, n, np.random.default_rng(300 + n))
    t = {k: torch.tensor(v, dtype=torch.float32, device=cuda)
         for k, v in g.items()}
    t["b"][3] = -t["b"][3]
    flat = cuda_gp._flat(*(t[k] for k in "abcde"))
    ref64 = np.stack([g["means"][:, 0, 0], g["variances"][:, 0, 0]], -1)
    ok = np.arange(7) != 3
    for kernel, plain, atol, rtol in (
            (cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_plain, K5_ATOL, 1.0),
            (cuda_gp.gp_fused_ns_cuda, cuda_gp.gp_fused_ns_plain, K6_ATOL,
             K6_RTOL)):
        out = kernel(*flat)
        torch.cuda.synchronize()
        out, ref = out.cpu().numpy(), plain(*flat).cpu().numpy()
        assert (np.isfinite(out).all(axis=1) == ok).all()
        assert (np.isfinite(ref).all(axis=1) == ok).all()
        assert np.abs(out[ok] - ref[ok]).max() <= atol
        assert _rel(out[ok], ref[ok]) <= rtol
        assert np.abs(out[ok] - ref64[ok]).max() < 1e-4


def test_k6_matches_plain_at_1600x128(cuda):
    """K6 at the main path's largest batch (13 waves of one block an SM)
    against its plain version and the fp64 closed form, in one launch."""
    g = make_gp_batch(1600, 128, np.random.default_rng(1600))
    flat = cuda_gp._flat(*(torch.tensor(g[k], dtype=torch.float32,
                                        device=cuda) for k in "abcde"))
    before = cuda_gp.gp_fused_ns_cuda.launches
    out = cuda_gp.gp_fused_ns_cuda(*flat)
    torch.cuda.synchronize()
    assert cuda_gp.gp_fused_ns_cuda.launches == before + 1
    out, ref = out.cpu().numpy(), cuda_gp.gp_fused_ns_plain(*flat).cpu().numpy()
    ref64 = np.stack([g["means"][:, 0, 0], g["variances"][:, 0, 0]], -1)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= K6_ATOL
    assert _rel(out, ref) <= K6_RTOL
    assert np.abs(out - ref64).max() < 1e-4


def test_kernels_reject_n129_on_cuda(cuda):
    """K3 rejects n = 129 (both packages invert through Schur past 128);
    K1 and K6, which run one thread-block cluster a matrix past 128, reject
    n = 225; K2, whose cluster instance serves up to 256, and K4 and K5,
    whose packed instances do, n = 257."""
    with pytest.raises(ValueError, match="256"):
        cuda_lu.lu_inverse_cuda(torch.eye(257, device=cuda)[None])
    with pytest.raises(ValueError, match="128"):
        cuda_cholesky.inverse_cholesky_cuda(torch.eye(129, device=cuda)[None])
    a = torch.eye(257, device=cuda)[None]
    with pytest.raises(ValueError, match="256"):
        cuda_cholesky.cholesky_cuda(a)
    v = torch.ones(1, 257, device=cuda)
    e = torch.ones(1, device=cuda)
    with pytest.raises(ValueError, match="256"):
        cuda_gp.gp_fused_cuda(v, a, v, v, e)
    a = torch.eye(225, device=cuda)[None]
    v = torch.ones(1, 225, device=cuda)
    with pytest.raises(ValueError, match="224"):
        newton_schulz.ns_iterate_cuda(a, LANES["newton_schulz_pallas"]["schedule"])
    with pytest.raises(ValueError, match="224"):
        cuda_gp.gp_fused_ns_cuda(v, a, v, v, e)


def _check_chol_band(cuda, batch, n, seed):
    """K4, K5 and K10 (with and without W) past 128, on the packed lower
    triangle, against their plain versions on one launch each; for batch >
    1 member batch // 2 is negative definite and is the only non-finite
    one.  K4's L and every output of K10 (quad, logdet, and with W also W
    and α) are bitwise the plain versions' on every positive definite
    member (K10's packed instance sums in the plain version's order); K5
    within K5_ATOL (and the fp64 closed form within 1e-4)."""
    bad = batch // 2 if batch > 1 else None
    ok = np.arange(batch) != (bad if bad is not None else -1)
    keep = torch.from_numpy(ok).to(cuda)
    a = torch.tensor(make_spd_batch(batch, n, np.random.default_rng(seed)),
                     dtype=torch.float32, device=cuda)
    g = make_gp_batch(batch, n, np.random.default_rng(seed + 1))
    t = {k: torch.tensor(v, dtype=torch.float32, device=cuda)
         for k, v in g.items()}
    if bad is not None:
        a[bad] = -a[bad]
        t["b"][bad] = -t["b"][bad]
    flat = cuda_gp._flat(*(t[k] for k in "abcde"),
                         max_n=cuda_build.CHOL_MAX_N)
    counters = ((cuda_cholesky.cholesky_cuda, "band_launches"),
                (cuda_gp.gp_fused_cuda, "band_launches"),
                (cuda_gp_lml.lml_quad_logdet_cuda, "band_launches"),
                (cuda_gp_lml.lml_quad_logdet_cuda, "band_emit_w_launches"))
    before = [getattr(f, k) for f, k in counters]
    l = cuda_cholesky.cholesky_cuda(a)
    out = cuda_gp.gp_fused_cuda(*flat)
    b, c, d = flat[1], flat[2], flat[3]
    lml = cuda_gp_lml.lml_quad_logdet_cuda(b, c, d)
    lml_w = cuda_gp_lml.lml_quad_logdet_cuda(b, c, d, True)
    torch.cuda.synchronize()
    assert [getattr(f, k) for f, k in counters] == [x + 1 for x in before]
    l_ref = cuda_cholesky.cholesky_plain(a)
    assert torch.equal(l[keep], l_ref[keep])
    assert bool(torch.isfinite(l).all(-1).all(-1).eq(keep).all())
    out_ref = cuda_gp.gp_fused_plain(*flat)
    assert bool(torch.isfinite(out).all(-1).eq(keep).all())
    o, r = out[keep].cpu().numpy(), out_ref[keep].cpu().numpy()
    assert np.abs(o - r).max() <= K5_ATOL
    ref64 = np.stack([g["means"][:, 0, 0], g["variances"][:, 0, 0]], -1)
    assert np.abs(o - ref64[ok]).max() < 1e-4
    for got, emit_w in ((lml, False), (lml_w, True)):
        ref = cuda_gp_lml.lml_quad_logdet_plain(b, c, d, emit_w)
        assert len(got) == len(ref) == (4 if emit_w else 2)
        for x, y in zip(got, ref):
            fin = torch.isfinite(x.reshape(batch, -1)).all(-1)
            assert bool(fin.eq(keep).all())
            assert torch.equal(x[keep], y[keep])


@pytest.mark.parametrize("batch", [1, 37, 1600])
@pytest.mark.parametrize("n", [129, 160, 200, 232, 256, 136, 224, 225, 255,
                               209, 216, 131, 233])
def test_chol_band_kernels_match_plain(cuda, n, batch):
    """K4, K5 and K10 past 128 at n = 129 (one row past the square
    instances, n off 4), 136, 160, 200, 224 and 232, 225 and 255 (a
    partial last panel of W and of the factor) and 256 (one block an SM of
    512 threads), at one system, 37 (not a multiple of the blocks the card
    holds at once) and 1600 (many waves); 209, 216 and 224: K10 with W at
    256 threads, two blocks an SM, next to its 512-thread instance; 131: a
    last panel of 3 columns (K5's border takes a 3-column last strip); 224
    and 225, 232 and 233: each side of the 256 / 512-thread switch (K5,
    then K4)."""
    _check_chol_band(cuda, batch, n, 1900 + n + batch)


@pytest.mark.parametrize("batch", [1, 1600])
@pytest.mark.parametrize("n", [129, 224, 225, 256])
def test_k5_band_with_d_equal_to_a(cuda, n, batch):
    """K5's band instance with d = a: both border rows carry the same
    right-hand side through the factor, so y_d and y_a come out equal and
    the two dot products are one sum: var = e − mean exactly; both within
    K5_ATOL of the plain version."""
    g = make_gp_batch(batch, n, np.random.default_rng(2300 + n + batch))
    t = {k: torch.tensor(v, dtype=torch.float32, device=cuda)
         for k, v in g.items()}
    flat = list(cuda_gp._flat(*(t[k] for k in "abcde"),
                              max_n=cuda_build.CHOL_MAX_N))
    flat[3] = flat[0].clone()
    before = cuda_gp.gp_fused_cuda.band_launches
    out = cuda_gp.gp_fused_cuda(*flat)
    torch.cuda.synchronize()
    assert cuda_gp.gp_fused_cuda.band_launches == before + 1
    assert torch.equal(out[:, 1], flat[4] - out[:, 0])
    ref = cuda_gp.gp_fused_plain(*flat)
    assert (out - ref).abs().max().item() <= K5_ATOL


def test_chol_band_paths_run_k5_and_k10(cuda):
    """A ``GPEngine(method="pallas")`` request at n = 200 (the 256 bucket)
    runs K5's packed instance, no K3 and no Schur solve, within 1e-4 of the
    fp64 closed form; ``GPEngine.fit`` at n = 200 runs K10's packed
    instance with W and agrees with the ``torch.linalg`` fit to the CPU
    fit test's bounds; ``cholesky`` at 256 runs K4's."""
    from cuda_matrix_inversion_tpu_torch import GPEngine

    g = make_gp_batch(20, 200, np.random.default_rng(1200))
    before = (cuda_gp.gp_fused_cuda.band_launches,
              cuda_cholesky.inverse_cholesky_cuda.launches)
    mean, var = GPEngine(method="pallas", device=cuda).mean_variance(
        *(g[k].astype(np.float32) for k in "abcde"))
    assert (cuda_gp.gp_fused_cuda.band_launches,
            cuda_cholesky.inverse_cholesky_cuda.launches) == (
                before[0] + 1, before[1])
    assert np.abs(mean - g["means"]).max() < 1e-4
    assert np.abs(var - g["variances"]).max() < 1e-4
    rng = np.random.default_rng(1201)
    w = rng.standard_normal((8, 200, 6))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.05 * np.eye(200)).astype(
        np.float32)
    c = (rng.random((8, 200, 1)) + 0.5).astype(np.float32)
    k = 1.8 ** 2 * b.astype(np.float64) + 0.25 * np.eye(200) * c[:, :, 0][
        :, None, :]
    d = (np.linalg.cholesky(k) @ rng.standard_normal((8, 200, 1))).astype(
        np.float32)
    before = cuda_gp_lml.lml_quad_logdet_cuda.band_emit_w_launches
    res = {m: GPEngine(fit_method=m, device=cuda).fit(b, c, d, steps=30)
           for m in ("pallas", "xla")}
    assert cuda_gp_lml.lml_quad_logdet_cuda.band_emit_w_launches == (
        before + 30)
    k10, ref = res["pallas"], res["xla"]
    np.testing.assert_allclose(k10.lml, ref.lml, rtol=1e-3, atol=1e-2)
    assert np.abs(k10.log_amp - ref.log_amp).max() <= 5e-3
    assert np.abs(k10.log_noise - ref.log_noise).max() <= 5e-3
    a = torch.tensor(make_spd_batch(4, 256, np.random.default_rng(1202)),
                     dtype=torch.float32, device=cuda)
    before = cuda_cholesky.cholesky_cuda.band_launches
    l = cuda_cholesky.cholesky(a)
    assert cuda_cholesky.cholesky_cuda.band_launches == before + 1
    assert torch.equal(l, cuda_cholesky.cholesky_plain(a))


def _check_k7(cuda, a, bad=None, gate=True):
    """K7's raw inverse against :func:`cuda_gauss_jordan.gauss_jordan_plain`
    on ``a`` (float32 NumPy), in one launch: equal (``torch.equal``) on
    every finite member and the same members non-finite (``bad``, where
    given); the polished lane on the finite members through the gate."""
    at = torch.tensor(a, device=cuda)
    before = cuda_gauss_jordan.gauss_jordan_cuda.launches
    x = cuda_gauss_jordan.gauss_jordan_cuda(at)
    torch.cuda.synchronize()
    assert cuda_gauss_jordan.gauss_jordan_cuda.launches == before + 1
    ref = cuda_gauss_jordan.gauss_jordan_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if bad is not None:
        assert (~finite).nonzero().flatten().tolist() == list(bad)
    assert torch.equal(x[finite], ref[finite])
    if gate:
        keep = finite.cpu().numpy()
        polished = cuda_gauss_jordan.inverse_gauss_jordan(at).cpu().numpy()
        assert identity_error_inf(a[keep], polished[keep]) < 1e-4


@pytest.mark.parametrize("kind", ["general", "permuted", "singular", "ties"])
@pytest.mark.parametrize("n", [8, 20, 64, 128, 192, 1, 7, 40, 72, 127, 160])
def test_k7_matches_plain(cuda, kind, n):
    """K7 against its plain version (no polish) at every instance (NP =
    16, 32, 64, 128, 192), with n off a multiple of 4 (scalar loads) and
    padded to the instance: member 3 of the singular batch (rank 1, or 0
    at n = 1) alone comes out non-finite, and the polished lane passes the
    gate; on small integers in [-2, 2] exact ties decide the pivots (the
    first maximum by position) and a member may be singular."""
    rng = np.random.default_rng(500 + n)
    if kind == "ties":
        a = rng.integers(-2, 3, (7, n, n)).astype(np.float32)
        _check_k7(cuda, a, gate=False)
        return
    a = make_square_batch(7, n, rng).astype(np.float32)
    if kind == "permuted":
        a = a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    if kind == "singular":
        a[3] = 1.0 if n > 1 else 0.0
    _check_k7(cuda, a, bad=[3] if kind == "singular" else [])


def test_k7_matches_plain_at_1600x128(cuda):
    """The main path's largest batch, the general class (13 waves of the
    lookahead instance, one block an SM)."""
    a = make_square_batch(1600, 128, np.random.default_rng(1603)).astype(
        np.float32)
    _check_k7(cuda, a, bad=[])


def _drifted(a, delta, rng, symmetric):
    """``a`` plus a Gaussian perturbation of relative 2-norm δ (symmetrised
    for SPD input), float32."""
    noise = rng.standard_normal(a.shape)
    if symmetric:
        noise = (noise + np.transpose(noise, (0, 2, 1))) / 2
    scale = (np.linalg.norm(a, 2, axis=(1, 2))
             / np.linalg.norm(noise, 2, axis=(1, 2)))[:, None, None]
    return (a + delta * scale * noise).astype(np.float32)


def _check_k8(cuda, n, precision, lo, hi, seed, nan_member=None,
              gate=True, batch=7):
    """K8 refines the inverse of a batch (7 matrices) for its drifted
    copy, in one launch: against its plain version and (``gate``) through
    the gate; member ``nan_member`` starts from an X0 holding a NaN and
    alone comes out non-finite."""
    rng = np.random.default_rng(seed)
    split3 = precision == "split3"
    a0 = (make_square_batch if split3 else make_spd_batch)(batch, n, rng)
    x0 = np.linalg.inv(a0).astype(np.float32)
    a = _drifted(a0, 1e-4 if split3 else 1e-3, rng, not split3)
    ok = np.arange(batch) != nan_member
    if nan_member is not None:
        x0[nan_member, 0, 0] = np.nan
    at, x0t = torch.tensor(a, device=cuda), torch.tensor(x0, device=cuda)
    before = newton_schulz.ns_refine_cuda.launches
    x = newton_schulz.ns_refine_cuda(at, x0t, lo, hi, split3)
    torch.cuda.synchronize()
    assert newton_schulz.ns_refine_cuda.launches == before + 1
    ref = newton_schulz.ns_refine_plain(at, x0t, lo, hi, split3)
    x, ref = x.cpu().numpy(), ref.cpu().numpy()
    assert (np.isfinite(x).all(axis=(1, 2)) == ok).all()
    assert (np.isfinite(ref).all(axis=(1, 2)) == ok).all()
    assert _rel(x[ok], ref[ok]) <= WARM_RTOL
    if gate:
        assert identity_error_inf(a[ok], x[ok]) < 1e-4


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [8, 20, 64, 128, 1, 40, 72, 127])
def test_k8_matches_plain(cuda, precision, n):
    """K8 at its default 2 + 1 rounds at each tile size, with zero
    padding where n is not a multiple of 16."""
    _check_k8(cuda, n, precision, 2, 1, 600 + n)


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("n", [20, 128])
def test_k8_matches_plain_off_its_default_schedule(cuda, precision, lo, hi,
                                                   n):
    """(0, 1) is the fp32 polish round alone; (1, 2) and (3, 2) put a
    split-residual polish round before it.  Member 3's X0 holds a NaN."""
    _check_k8(cuda, n, precision, lo, hi, 700 + 10 * lo + hi + n,
              nan_member=3)


@pytest.mark.parametrize("emit_w", [False, True])
@pytest.mark.parametrize("n", [8, 11, 64, 128, 1, 20, 72, 127])
def test_k10_matches_plain(cuda, emit_w, n):
    """K10 against its plain version; system 3 is negative definite and is
    the only non-finite one.  With emit_w, W is bitwise the plain
    version's, forward_substitution_plain(cholesky_plain(K), I), on every
    positive definite member."""
    g = make_gp_batch(7, n, np.random.default_rng(700 + n))
    b, c, d = (torch.tensor(g[k], dtype=torch.float32, device=cuda)
               for k in "bcd")
    b[3] = -b[3]
    c, d = c[..., 0].contiguous(), d[..., 0].contiguous()
    before = cuda_gp_lml.lml_quad_logdet_cuda.launches
    got = cuda_gp_lml.lml_quad_logdet_cuda(b, c, d, emit_w)
    torch.cuda.synchronize()
    assert cuda_gp_lml.lml_quad_logdet_cuda.launches == before + 1
    ref = cuda_gp_lml.lml_quad_logdet_plain(b, c, d, emit_w)
    ok = np.arange(7) != 3
    assert len(got) == (4 if emit_w else 2)
    if emit_w:
        keep = torch.from_numpy(ok).to(cuda)
        assert torch.equal(got[2][keep], ref[2][keep])
    for x, r in zip(got, ref):
        x, r = x.cpu().numpy(), r.cpu().numpy()
        flat = x.reshape(7, -1)
        assert (np.isfinite(flat).all(axis=1) == ok).all()
        assert _rel(x[ok], r[ok]) <= LML_RTOL


def _check_k11(cuda, batch, n, lo, hi, seed, nan_member=None):
    """K11 from the previous timestep's K⁻¹ on a drifted system: mean, var
    and the refined K⁻¹ against the plain version and the fp64 closed
    form.  A NaN in ``nan_member``'s X0 makes that member alone
    non-finite."""
    rng = np.random.default_rng(seed)
    g = make_gp_batch(batch, n, rng)
    k0 = g["b"] + np.eye(n) * g["c"][:, :, 0][:, None, :]
    x0 = np.linalg.inv(k0).astype(np.float32)
    ok = np.ones(batch, bool)
    if nan_member is not None:
        x0[nan_member, n // 2, n - 1] = np.nan
        ok[nan_member] = False
    g["b"] = _drifted(g["b"], 1e-3, rng, True)
    t = {k: torch.tensor(g[k], dtype=torch.float32, device=cuda)
         for k in "abcde"}
    flat = cuda_gp._flat(*(t[k] for k in "abcde"),
                         max_n=cuda_build.WARM_MAX_N)
    x0t = torch.tensor(x0, device=cuda)
    before = cuda_gp.gp_fused_warm_cuda.launches
    out, kinv = cuda_gp.gp_fused_warm_cuda(*flat, x0t, lo, hi)
    torch.cuda.synchronize()
    assert cuda_gp.gp_fused_warm_cuda.launches == before + 1
    ref, ref_kinv = cuda_gp.gp_fused_warm_plain(*flat, x0t, lo, hi)
    out, kinv = out.cpu().numpy(), kinv.cpu().numpy()
    ref, ref_kinv = ref.cpu().numpy(), ref_kinv.cpu().numpy()
    for x, r in ((out, ref), (kinv.reshape(batch, -1),
                              ref_kinv.reshape(batch, -1))):
        assert (np.isfinite(x).all(axis=1) == ok).all()
        assert (np.isfinite(r).all(axis=1) == ok).all()
    assert np.abs(out[ok] - ref[ok]).max() <= K6_ATOL
    assert _rel(kinv[ok], ref_kinv[ok]) <= WARM_RTOL
    k = g["b"].astype(np.float32).astype(np.float64) + np.eye(n) * g["c"][
        :, :, 0].astype(np.float32)[:, None, :]
    kinv64 = np.linalg.inv(k)
    a64 = g["a"].astype(np.float32).astype(np.float64)
    d64 = g["d"].astype(np.float32).astype(np.float64)
    mean = (np.transpose(a64, (0, 2, 1)) @ kinv64 @ d64)[:, 0, 0]
    assert np.abs(out[ok, 0] - mean[ok]).max() < 1e-4
    assert identity_error_inf(k[ok].astype(np.float32), kinv[ok]) < 1e-4


@pytest.mark.parametrize("n,lo,hi", [
    *(pytest.param(n, 2, 1, id=str(n)) for n in (8, 20, 64, 72, 128)),
    *(pytest.param(n, lo, hi, id=f"{n}-lo{lo}-hi{hi}")
      for n in (20, 128) for lo, hi in ((0, 1), (1, 2), (3, 2)))])
def test_k11_matches_plain(cuda, n, lo, hi):
    """K11 against its plain version at the default schedule (2, 1), with
    zero padding in the 16-multiple tiles at n = 20 and 72, and at other
    (lo, hi): (0, 1) is the fp32 polish round alone, (1, 2) and (3, 2) put
    a split-residual polish round before it.  Member 3's X0 holds a NaN."""
    _check_k11(cuda, 7, n, lo, hi, 800 + n, nan_member=3)


def test_k11_matches_plain_at_1600x128(cuda):
    """K11 at the main path's largest batch (13 waves of one block an SM)
    in one launch."""
    _check_k11(cuda, 1600, 128, 2, 1, 1600)


def test_new_kernels_reject_past_their_ceiling(cuda):
    a = torch.eye(257, device=cuda)[None]
    v = torch.ones(1, 257, device=cuda)
    before = cuda_gp_lml.lml_quad_logdet_cuda.launches
    for emit_w in (False, True):
        with pytest.raises(ValueError, match="256"):
            cuda_gp_lml.lml_quad_logdet_cuda(a, v, v, emit_w)
    assert cuda_gp_lml.lml_quad_logdet_cuda.launches == before
    with pytest.raises(ValueError, match="192"):
        cuda_gauss_jordan.gauss_jordan_cuda(torch.eye(193, device=cuda)[None])
    # the warm kernels serve n <= 224 (one cluster a matrix past 128)
    a = torch.eye(225, device=cuda)[None]
    v = torch.ones(1, 225, device=cuda)
    before = (newton_schulz.ns_refine_cuda.launches,
              cuda_gp.gp_fused_warm_cuda.launches)
    with pytest.raises(ValueError, match="224"):
        newton_schulz.ns_refine_cuda(a, a, 2, 1, False)
    with pytest.raises(ValueError, match="224"):
        cuda_gp.gp_fused_warm_cuda(v, a, v, v, torch.ones(1, device=cuda), a)
    assert (newton_schulz.ns_refine_cuda.launches,
            cuda_gp.gp_fused_warm_cuda.launches) == before


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [129, 160, 224])
def test_k8_band_matches_plain(cuda, precision, n):
    """K8's cluster instance (NP = 160 with 31 rows of zero padding at
    n = 129, 160 exactly, 224 at seven CTAs a cluster) against its plain
    version at 2 + 1 rounds; member 3's X0 holds a NaN and alone comes out
    non-finite (no CTA reads another matrix)."""
    _check_k8(cuda, n, precision, 2, 1, 900 + n, nan_member=3)


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("lo,hi", [(0, 1), (3, 2)])
def test_k8_band_matches_plain_off_its_default_schedule(cuda, precision, lo,
                                                        hi):
    """(0, 1) is the fp32 (split3: fp64) polish round alone, (3, 2) puts
    a split-residual polish round before it.  (0, 1) is held to its plain
    version only: one polish round from the general class's drift
    (δ·κ up to 0.06 at κ ≤ 4n) leaves ~3e-4 in the kernel and the plain
    version alike, over the gate that the default 2 + 1 rounds hold."""
    _check_k8(cuda, 160, precision, lo, hi, 950 + 10 * lo + hi,
              nan_member=3, gate=(lo, hi) != (0, 1))


@pytest.mark.parametrize("n,lo,hi", [(129, 2, 1), (160, 2, 1), (224, 2, 1),
                                     (160, 0, 1), (160, 3, 2)])
def test_k11_band_matches_plain(cuda, n, lo, hi):
    """K11's cluster instance against its plain version and the fp64
    closed form: mean and var from the C CTAs' partial sums, K⁻¹ from each
    slab; member 3's X0 holds a NaN and alone comes out non-finite."""
    _check_k11(cuda, 7, n, lo, hi, 980 + n + lo, nan_member=3)


@pytest.mark.parametrize("n", [64, 160])
@pytest.mark.parametrize("kernel", ["k8_bf16", "k8_split3", "k11"])
def test_warm_kernels_match_plain_past_32_lo_rounds(cuda, kernel, n):
    """K8 (both precisions) and K11 at 33 lo rounds, on one block (n =
    64) and on a cluster (n = 160): the warm kernels take any count (32 at
    most when the round scalars were kernel parameters); member 3's X0
    holds a NaN."""
    if kernel == "k11":
        _check_k11(cuda, 7, n, 33, 1, 1030 + n, nan_member=3)
    else:
        _check_k8(cuda, n, kernel[3:], 33, 1, 1040 + n, nan_member=3)


@pytest.mark.parametrize("n", [129, 161, 193, 224])
@pytest.mark.parametrize("kernel", ["k8_bf16", "k8_split3", "k11", "k1",
                                    "k6"])
def test_band_kernels_match_plain_at_37(cuda, kernel, n):
    """The cluster instances at each NP (160, 192, 224) with 31 rows of
    zero padding in the last slab at 129, 161 and 193, on a batch of 37,
    which is no multiple of the clusters the card holds at once (15 - 47);
    member 18's X0 (K1: A; K6: B) holds a NaN.  K1 in each lane."""
    if kernel == "k11":
        _check_k11(cuda, 37, n, 2, 1, 1100 + n, nan_member=18)
    elif kernel == "k1":
        for lane in _K1_LANES:
            _check_k1_band(cuda, LANES[lane]["schedule"], n, 1300 + n,
                           batch=37, nan_member=18)
    elif kernel == "k6":
        _check_k6_band(cuda, 37, n, 1400 + n, nan_member=18)
    else:
        _check_k8(cuda, n, kernel[3:], 2, 1, 1200 + n, nan_member=18,
                  batch=37)


def _check_k1_band(cuda, sched, n, seed, batch=7, nan_member=None,
                   rtol=K1_RTOL):
    """K1's cluster instance against its plain version in one launch
    (counted as a band launch): the split3 schedule on the κ = 500
    nonsymmetric class, the others on the SPD class; member
    ``nan_member``'s A holds a NaN and alone comes out non-finite; the
    others through the gate, or with no polish round (``hi_iters=0``)
    within twice the plain version's max‖AX − I‖∞."""
    rng = np.random.default_rng(seed)
    a = (make_nonsym_cond(batch, n, 500.0, rng) if sched.split3
         else make_spd_batch(batch, n, rng).astype(np.float32))
    ok = np.arange(batch) != nan_member
    if nan_member is not None:
        a[nan_member, n // 2, n - 1] = np.nan
    at = torch.tensor(a, device=cuda)
    fn = newton_schulz.ns_iterate_cuda
    before = (fn.launches, fn.band_launches)
    x = fn(at, sched)
    torch.cuda.synchronize()
    assert (fn.launches, fn.band_launches) == (before[0] + 1, before[1] + 1)
    ref = newton_schulz.ns_iterate_plain(at, sched, bf16_products=True)
    x, ref = x.cpu().numpy(), ref.cpu().numpy()
    assert (np.isfinite(x).all(axis=(1, 2)) == ok).all()
    assert (np.isfinite(ref).all(axis=(1, 2)) == ok).all()
    assert _rel(x[ok], ref[ok]) <= rtol
    if sched.hi_iters:
        assert identity_error_inf(a[ok], x[ok]) < 1e-4
    else:
        assert (identity_error_inf(a[ok], x[ok])
                <= 2 * identity_error_inf(a[ok], ref[ok]))


@pytest.mark.parametrize("lane", _K1_LANES)
@pytest.mark.parametrize("n", [129, 160, 224])
def test_k1_band_matches_plain(cuda, lane, n):
    """K1's cluster instance in each lane (NP = 160 with 31 rows of zero
    padding at n = 129, 160 exactly, 224 in quadrants of 112): the seed's
    norms over the 2 × 2 cluster (each row and column sum the two halves
    of its quadrants), the schedule's rounds; member 3's A holds a NaN and
    alone comes out non-finite (no CTA reads another matrix)."""
    _check_k1_band(cuda, LANES[lane]["schedule"], n, 1500 + n,
                   nan_member=3)


@pytest.mark.parametrize("precision", ["bf16", "split3"])
def test_k1_band_matches_plain_past_32_lo_rounds(cuda, precision):
    """The pan schedule at 33 lo rounds on K1's cluster instance (n = 160):
    the round scalars come from device memory, any count."""
    sched = newton_schulz.resolve_schedule(lo_iters=33, init="pan",
                                           precision=precision)
    assert len(sched.coeffs) == 33
    _check_k1_band(cuda, sched, 160, 1533, nan_member=3)


def _check_k6_band(cuda, batch, n, seed, nan_member=None):
    """K6's cluster instance against its plain version and the fp64 closed
    form in one launch (counted as a band launch); member ``nan_member``'s
    B holds a NaN and alone comes out non-finite."""
    g = make_gp_batch(batch, n, np.random.default_rng(seed))
    t = {k: torch.tensor(g[k], dtype=torch.float32, device=cuda)
         for k in "abcde"}
    ok = np.arange(batch) != nan_member
    if nan_member is not None:
        t["b"][nan_member, n // 2, n - 1] = float("nan")
    flat = cuda_gp._flat(*(t[k] for k in "abcde"),
                         max_n=cuda_build.WARM_MAX_N)
    fn = cuda_gp.gp_fused_ns_cuda
    before = (fn.launches, fn.band_launches)
    out = fn(*flat)
    torch.cuda.synchronize()
    assert (fn.launches, fn.band_launches) == (before[0] + 1, before[1] + 1)
    out, ref = out.cpu().numpy(), cuda_gp.gp_fused_ns_plain(*flat).cpu().numpy()
    ref64 = np.stack([g["means"][:, 0, 0], g["variances"][:, 0, 0]], -1)
    assert (np.isfinite(out).all(axis=1) == ok).all()
    assert (np.isfinite(ref).all(axis=1) == ok).all()
    assert np.abs(out[ok] - ref[ok]).max() <= K6_ATOL
    assert _rel(out[ok], ref[ok]) <= K6_RTOL
    assert np.abs(out[ok] - ref64[ok]).max() < 1e-4


@pytest.mark.parametrize("n", [129, 160, 224])
def test_k6_band_matches_plain(cuda, n):
    """K6's cluster instance: K1's spd seed on K = B + diag(c) over the
    2 × 2 cluster (c added to the diagonal of each quadrant that holds
    one), the spd schedule, and the quadrant epilogue (partial sums a
    quadrant, added in rank order by rank 0); member 3's B holds a NaN."""
    _check_k6_band(cuda, 7, n, 1600 + n, nan_member=3)


# the padded size of the quadrant instance each n takes
_QUAD_NP = {129: 160, 161: 192, 193: 224, 224: 224}


@pytest.mark.parametrize("n", [129, 161, 193, 224])
def test_quad_instances_run_at_each_np(cuda, n):
    """K1's and K6's quadrant instances (``csrc/ns_quad_rounds.cuh``) at
    each padded size: n = 129, 161 and 193 carry 31 rows of zero padding
    into the last quadrants of NP = 160, 192 and 224, 224 none; a batch of
    37, no multiple of the clusters the card holds at once.  K1 in each
    lane and at 33 lo rounds of the pan schedule in bf16 and split3 (the
    split's three windows a product, 66 products), K6 with a NaN member;
    each launch counts once at the NP its entry point reports
    (``band_launches_<NP>``)."""
    key = f"band_launches_{_QUAD_NP[n]}"
    scheds = [LANES[lane]["schedule"] for lane in _K1_LANES] + [
        newton_schulz.resolve_schedule(lo_iters=33, init="pan",
                                       precision=precision)
        for precision in ("bf16", "split3")]
    for i, sched in enumerate(scheds):
        before = getattr(newton_schulz.ns_iterate_cuda, key)
        _check_k1_band(cuda, sched, n, 1700 + 10 * n + i, batch=37,
                       nan_member=18)
        assert getattr(newton_schulz.ns_iterate_cuda, key) == before + 1
    before = getattr(cuda_gp.gp_fused_ns_cuda, key)
    _check_k6_band(cuda, 37, n, 1800 + n, nan_member=18)
    assert getattr(cuda_gp.gp_fused_ns_cuda, key) == before + 1


# K1's lo rounds alone (hi = 0) end on X from one-pass bf16 products in
# the bf16 schedules, with no polish round to absorb the rounding: the
# kernel and its plain version sum in another order, so the last round
# may round an operand entry of one to the neighbouring bf16 value, a
# change of up to 2⁻⁷ of it (T ≈ I carries it to X whole).  Two such
# units of the largest entry; split3's 3-pass products keep K1_RTOL.
K1_LO_ONLY_BF16_RTOL = 2.0 ** -6


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [129, 161, 193, 224])
def test_quad_lo_rounds_alone(cuda, n, precision):
    """K1's quadrant instance with no polish round (``hi_iters=0``, the
    fp32 polish flag left set): every lo round publishes X in bf16 and
    only the result in fp32 (whose quadrant lies over X's bf16 slots);
    the spd schedule in bf16 and pan500's in split3, at each padded size
    with a batch of 37, member 18's A holding a NaN."""
    sched = newton_schulz.resolve_schedule(
        hi_iters=0, init="spd" if precision == "bf16" else "pan",
        precision=precision)
    key = f"band_launches_{_QUAD_NP[n]}"
    before = getattr(newton_schulz.ns_iterate_cuda, key)
    _check_k1_band(cuda, sched, n, 1900 + n, batch=37, nan_member=18,
                   rtol=K1_RTOL if sched.split3 else K1_LO_ONLY_BF16_RTOL)
    assert getattr(newton_schulz.ns_iterate_cuda, key) == before + 1


def test_band_launch_error_raises(cuda):
    """A cluster launch the card refuses (a grid of batch × 7 CTAs past
    2³¹ − 1 at n = 224) returns its CUDA error, which the wrappers' check
    raises; the next launch runs."""
    a = torch.eye(224, device=cuda)[None].contiguous()
    x = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)
    err = cuda_build.library().cmi_ns_warm(
        a.data_ptr(), a.data_ptr(), x.data_ptr(), (1 << 31) // 7 + 1, 224,
        2, 1, 0, device, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_build.check(err, "newton_schulz warm kernel")
    out = newton_schulz.ns_refine_cuda(a, a, 2, 1, False)
    torch.cuda.synchronize()
    assert torch.equal(out, a)


def _check_k9(cuda, a, pw, bad, gate=True):
    """The blocked factor with K9 against the same routine with K9's
    plain version: the factor, perm, every panel's pivots, L11⁻¹ and U11⁻¹
    bitwise equal on the finite members; member ``bad`` (a zero column)
    alone non-finite; then the whole polished inverse of both, and the
    gate on the finite members."""
    batch, n = a.shape[0], a.shape[-1]
    ok = np.arange(batch) != bad
    at = torch.tensor(a, device=cuda)
    n_pad = -(-n // pw) * pw
    work = torch.eye(n_pad, device=cuda).repeat(batch, 1, 1)
    work[:, :n, :n] = at
    before = lu_bign.lu_panel_cuda.launches
    got = lu_bign.lu_factor_big(work, pw, panel=lu_bign.lu_panel_cuda)
    torch.cuda.synchronize()
    assert lu_bign.lu_panel_cuda.launches == before + n_pad // pw
    ref = lu_bign.lu_factor_big(work, pw, panel=lu_bign.lu_panel_plain)
    keep = torch.from_numpy(ok).to(cuda)
    lu, ref_lu = got[0].cpu().numpy(), ref[0].cpu().numpy()
    assert (np.isfinite(lu).all(axis=(1, 2)) == ok).all()
    assert (np.isfinite(ref_lu).all(axis=(1, 2)) == ok).all()
    assert torch.equal(got[0][keep], ref[0][keep])
    assert torch.equal(got[1][keep], ref[1][keep])
    for part in (2, 3, 4):
        for x, r in zip(got[part], ref[part]):
            assert torch.equal(x[keep], r[keep])
    x = lu_bign.inverse_lu_big(at, pw=pw).cpu().numpy()
    ref_x = lu_bign.inverse_lu_big_plain(at, pw=pw).cpu().numpy()
    assert (np.isfinite(x).all(axis=(1, 2)) == ok).all()
    assert _rel(x[ok], ref_x[ok]) <= K9_RTOL
    if gate:
        assert identity_error_inf(a[ok], x[ok]) < 1e-4


@pytest.mark.parametrize("n,pw", [(160, 64), (256, 32), (300, 16),
                                  (512, 64), (160, 8), (160, 24)])
def test_k9_matches_plain(cuda, n, pw):
    """K9 against its plain version (n = 160 at pw = 64 and 24, and 300 at
    16, pad a ragged last panel; pw = 8, the width pick_pw takes from
    n = 2897 on, and 24 run the kernel's generic instance); member 3 has a
    zero column and alone comes out non-finite; the lanes pass the gate on
    the κ = 500 class."""
    a = make_nonsym_cond(7, n, 500.0, np.random.default_rng(900 + n))
    a[3, :, 5] = 0.0
    _check_k9(cuda, a, pw, 3)


@pytest.mark.parametrize("n,pw", [(256, 64), (512, 32), (160, 16)])
def test_k9_matches_plain_on_ties(cuda, n, pw):
    """Small integers in [-2, 2], so exact ties between magnitudes decide
    the pivots (the first maximum by position after the earlier swaps);
    such draws are badly conditioned, so no gate."""
    rng = np.random.default_rng(910 + n)
    a = rng.integers(-2, 3, (7, n, n)).astype(np.float32)
    a[3, :, 5] = 0.0
    _check_k9(cuda, a, pw, 3, gate=False)


def test_k9_matches_plain_at_1600x256(cuda):
    """The big-n path's largest batch at its default panel width."""
    a = make_square_batch(1600, 256, np.random.default_rng(920)
                          ).astype(np.float32)
    a[800, :, 100] = 0.0
    _check_k9(cuda, a, lu_bign.pick_pw(256), 800, gate=False)


def test_k9_matches_plain_at_its_ceiling(cuda):
    """The largest n pw = 64 takes in the blocked factor (832) and one
    first panel at the row ceiling of the source note (847)."""
    a = make_nonsym_cond(3, 832, 500.0, np.random.default_rng(930))
    a[1, :, 7] = 0.0
    assert lu_bign.pick_pw(832) == 64
    _check_k9(cuda, a, 64, 1)
    work = torch.tensor(make_square_batch(2, 847, np.random.default_rng(931)),
                        dtype=torch.float32, device=cuda)
    perm = torch.arange(847, dtype=torch.int32, device=cuda).repeat(2, 1)
    ref_work, ref_perm = work.clone(), perm.clone()
    got = lu_bign.lu_panel_cuda(work, perm, 0, 64)
    ref = lu_bign.lu_panel_plain(ref_work, ref_perm, 0, 64)
    for x, r in zip((work, perm, *got), (ref_work, ref_perm, *ref)):
        assert torch.equal(x, r)


@pytest.mark.parametrize("pw", [16, 32, 64, 24])
def test_k9_matches_plain_off_16_byte_rows(cuda, pw):
    """Panels of a matrix whose rows are not 16-byte aligned (n = 203):
    the templated widths take 4-byte loads, write-back and gather there,
    as the generic instance (pw = 24) always does; each panel in turn, on
    the same input as the plain version's, every output bitwise equal."""
    n = 203
    work = torch.tensor(make_square_batch(5, n, np.random.default_rng(940)),
                        dtype=torch.float32, device=cuda)
    perm = torch.arange(n, dtype=torch.int32, device=cuda).repeat(5, 1)
    ref_work, ref_perm = work.clone(), perm.clone()
    for k0 in range(0, n - pw + 1, pw):
        got = lu_bign.lu_panel_cuda(work, perm, k0, pw)
        ref = lu_bign.lu_panel_plain(ref_work, ref_perm, k0, pw)
        for x, r in zip((work, perm, *got), (ref_work, ref_perm, *ref)):
            assert torch.equal(x, r), k0


@pytest.mark.parametrize("lane", ["lu_pallas", "lu_bign_pallas"])
def test_big_n_lanes_run_k9(cuda, lane):
    """Past 256 ``lu_pallas`` runs the blocked LU on K9, never K2."""
    a = make_nonsym_cond(5, 300, 500.0, np.random.default_rng(200))
    before = (cuda_lu.lu_inverse_cuda.launches,
              lu_bign.lu_panel_cuda.launches)
    x = get_inverse_algorithm(lane)(torch.tensor(a, device=cuda))
    torch.cuda.synchronize()
    assert cuda_lu.lu_inverse_cuda.launches == before[0]
    assert lu_bign.lu_panel_cuda.launches > before[1]
    assert identity_error_inf(a, x.cpu().numpy()) < 1e-4


def test_k9_rejects_past_its_ceiling(cuda):
    """The first panel must fit one block's shared memory (n = 1608 at
    pw = 32 does not); the wrapper also checks perm's type and layout."""
    work = torch.zeros(1, 1608, 1608, device=cuda)
    perm = torch.arange(1608, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(ValueError, match="shared memory"):
        lu_bign.lu_panel_cuda(work, perm, 0, 32)
    with pytest.raises(ValueError, match="shared memory"):
        lu_bign.inverse_lu_big(torch.zeros(0, 7000, 7000, device=cuda))
    with pytest.raises(ValueError, match="perm"):
        lu_bign.lu_panel_cuda(work, perm.long(), 0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        lu_bign.lu_panel_cuda(work.mT, perm, 0, 16)
