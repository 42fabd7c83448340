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
# K2 repeats the plain version's operations in the same order
K2_RTOL = 1e-5
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
# K7 repeats the plain version's operations in order (IEEE division, no FMA
# contraction); the raw inverse carries κ·ε₃₂ forward error on both sides
K7_RTOL = 1e-5
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


@pytest.mark.parametrize("init", ["spd", "pan"])
@pytest.mark.parametrize("n", [20, 72, 128])
def test_k1_polish_highest_false_matches_plain(cuda, init, n):
    """polish_highest=False: every polish residual is the 3-pass split,
    and the fp32 X still leaves the loop for the write."""
    a = make_spd_batch(7, n, np.random.default_rng(500 + n)).astype(
        np.float32)
    _check_k1(cuda, a, newton_schulz.resolve_schedule(
        init=init, polish_highest=False))


@pytest.mark.parametrize("kind", ["general", "permuted", "singular"])
@pytest.mark.parametrize("n", [8, 20, 64, 128])
def test_k2_matches_plain(cuda, kind, n):
    rng = np.random.default_rng(100 + n)
    a = make_square_batch(7, n, rng).astype(np.float32)
    if kind == "permuted":
        a = a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    if kind == "singular":
        a[3] = 1.0
    at = torch.tensor(a, device=cuda)
    x, piv = cuda_lu.lu_inverse_cuda(at)
    torch.cuda.synchronize()
    ref, ref_piv = cuda_lu.lu_inverse_plain(at)
    x, ref = x.cpu().numpy(), ref.cpu().numpy()
    finite = np.isfinite(ref).all(axis=(1, 2))
    assert (np.isfinite(x).all(axis=(1, 2)) == finite).all()
    assert finite.sum() == (6 if kind == "singular" else 7)
    assert _rel(x[finite], ref[finite]) <= K2_RTOL
    keep = torch.from_numpy(finite)
    assert torch.equal(piv.cpu()[keep], ref_piv.cpu()[keep])
    polished = cuda_lu.inverse_lu(at).cpu().numpy()
    assert identity_error_inf(a[finite], polished[finite]) < 1e-4


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
    a = torch.eye(129, device=cuda)[None]
    with pytest.raises(ValueError, match="128"):
        newton_schulz.ns_iterate_cuda(a, LANES["newton_schulz_pallas"]["schedule"])
    with pytest.raises(ValueError, match="128"):
        cuda_lu.lu_inverse_cuda(a)
    with pytest.raises(ValueError, match="128"):
        cuda_cholesky.cholesky_cuda(a)
    with pytest.raises(ValueError, match="128"):
        cuda_cholesky.inverse_cholesky_cuda(a)
    v = torch.ones(1, 129, device=cuda)
    e = torch.ones(1, device=cuda)
    for kernel in (cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_ns_cuda):
        with pytest.raises(ValueError, match="128"):
            kernel(v, a, v, v, e)


@pytest.mark.parametrize("kind", ["general", "permuted", "singular"])
@pytest.mark.parametrize("n", [8, 20, 64, 128, 192])
def test_k7_matches_plain(cuda, kind, n):
    """K7 against its plain version (no polish); member 3 of the singular
    batch is all ones and alone comes out non-finite; the polished lane
    passes the gate."""
    rng = np.random.default_rng(500 + n)
    a = make_square_batch(7, n, rng).astype(np.float32)
    if kind == "permuted":
        a = a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    if kind == "singular":
        a[3] = 1.0
    at = torch.tensor(a, device=cuda)
    before = cuda_gauss_jordan.gauss_jordan_cuda.launches
    x = cuda_gauss_jordan.gauss_jordan_cuda(at)
    torch.cuda.synchronize()
    assert cuda_gauss_jordan.gauss_jordan_cuda.launches == before + 1
    ref = cuda_gauss_jordan.gauss_jordan_plain(at)
    x, ref = x.cpu().numpy(), ref.cpu().numpy()
    ok = np.arange(7) != 3 if kind == "singular" else np.ones(7, bool)
    assert (np.isfinite(x).all(axis=(1, 2)) == ok).all()
    assert (np.isfinite(ref).all(axis=(1, 2)) == ok).all()
    assert _rel(x[ok], ref[ok]) <= K7_RTOL
    polished = cuda_gauss_jordan.inverse_gauss_jordan(at).cpu().numpy()
    assert identity_error_inf(a[ok], polished[ok]) < 1e-4


def _drifted(a, delta, rng, symmetric):
    """``a`` plus a Gaussian perturbation of relative 2-norm δ (symmetrised
    for SPD input), float32."""
    noise = rng.standard_normal(a.shape)
    if symmetric:
        noise = (noise + np.transpose(noise, (0, 2, 1))) / 2
    scale = (np.linalg.norm(a, 2, axis=(1, 2))
             / np.linalg.norm(noise, 2, axis=(1, 2)))[:, None, None]
    return (a + delta * scale * noise).astype(np.float32)


def _check_k8(cuda, n, precision, lo, hi, seed, nan_member=None):
    """K8 refines the inverse of a batch of 7 for its drifted copy, in one
    launch: against its plain version and through the gate; member
    ``nan_member`` starts from an X0 holding a NaN and alone comes out
    non-finite."""
    rng = np.random.default_rng(seed)
    split3 = precision == "split3"
    a0 = (make_square_batch if split3 else make_spd_batch)(7, n, rng)
    x0 = np.linalg.inv(a0).astype(np.float32)
    a = _drifted(a0, 1e-4 if split3 else 1e-3, rng, not split3)
    ok = np.arange(7) != nan_member
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
    flat = cuda_gp._flat(*(t[k] for k in "abcde"))
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
    a = torch.eye(129, device=cuda)[None]
    with pytest.raises(ValueError, match="128"):
        newton_schulz.ns_refine_cuda(a, a, 2, 1, False)
    v = torch.ones(1, 129, device=cuda)
    with pytest.raises(ValueError, match="128"):
        cuda_gp_lml.lml_quad_logdet_cuda(a, v, v)
    with pytest.raises(ValueError, match="128"):
        cuda_gp.gp_fused_warm_cuda(v, a, v, v, torch.ones(1, device=cuda), a)
    with pytest.raises(ValueError, match="192"):
        cuda_gauss_jordan.gauss_jordan_cuda(torch.eye(193, device=cuda)[None])


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
    """Past 128 ``lu_pallas`` runs the blocked LU on K9, never K2."""
    a = make_nonsym_cond(5, 200, 500.0, np.random.default_rng(200))
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
