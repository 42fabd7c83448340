"""The port's Cholesky kernels (K3, K4 plain versions), its Schur recursion
and its kernel build hash, against the JAX package.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on; float64 would take the JAX f64 routes).  The JAX kernels run in
interpret mode, as the JAX package's own tests run them on the CPU, with a
batch block of one matrix (the block only sets how many matrices one
interpreted grid step unrolls).  Tolerances are max-norm relative
differences unless stated.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.io.mats import read_mats as jax_read_mats
from cuda_matrix_inversion_tpu.ops import pallas_cholesky
from cuda_matrix_inversion_tpu.ops import schur as jax_schur
from cuda_matrix_inversion_tpu.ops import xla
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.mats import read_mats
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    linalg,
    schur,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

HAND = os.path.join(os.path.dirname(__file__), "hand_fixtures")


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _spd(batch, n, seed):
    return make_spd_batch(batch, n, np.random.default_rng(seed)
                          ).astype(np.float32)


@pytest.mark.parametrize("n", [8, 12, 32, 64])
def test_k4_plain_matches_jax(n):
    """The factor: fp32 on both sides, same right-looking order (the JAX
    kernel is rank-1 at every n) — 1e-5."""
    a = _spd(4, n, n)
    ref = np.asarray(pallas_cholesky.cholesky(a, block=1))
    l = cuda_cholesky.cholesky(torch.tensor(a)).numpy()
    assert l.dtype == np.float32 and l.shape == a.shape
    assert (np.triu(l, 1) == 0).all()
    assert _rel(l, ref) <= 1e-5
    assert _rel(l, np.linalg.cholesky(a.astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("n", [8, 12, 32, 64])
def test_k3_plain_matches_jax(n):
    """The SPD inverse: fp32 throughout on both sides; n = 64 is the JAX
    package's blocked (pw = 32) kernel, a different summation order — 1e-5
    on κ ≈ 2–3 draws."""
    a = _spd(4, n, 100 + n)
    ref = np.asarray(pallas_cholesky.inverse_cholesky(a, block=1))
    x = cuda_cholesky.inverse_cholesky(torch.tensor(a)).numpy()
    assert x.dtype == np.float32 and x.shape == a.shape
    assert _rel(x, ref) <= 1e-5
    assert identity_error_inf(a, x) < 1e-4
    assert identity_error_inf(a, ref) < 1e-4


@pytest.mark.parametrize("chain", ["", "5"])
def test_hand_fixtures_through_port(chain):
    """The exact integer chains (A = LLᵀ, A⁻¹ exact) read by the port's
    ``read_mats``: K4's plain version against L and the cholesky_pallas
    lane against A⁻¹, at the JAX test's atol = 1e-5."""
    a, l, ainv = (read_mats(os.path.join(HAND, f"{name}{chain}.mats"),
                            dtype=np.float64)[0]
                  for name in ("a", "cholL", "aInv"))
    for got, name in ((a, "a"), (l, "cholL"), (ainv, "aInv")):
        path = os.path.join(HAND, f"{name}{chain}.mats")
        np.testing.assert_array_equal(got, jax_read_mats(path,
                                                         dtype=np.float64)[0])
    a32 = torch.tensor(a[None].astype(np.float32))
    np.testing.assert_allclose(cuda_cholesky.cholesky(a32).numpy()[0], l,
                               atol=1e-5)
    inv = get_inverse_algorithm("cholesky_pallas")(a32).numpy()[0]
    np.testing.assert_allclose(inv, ainv, atol=1e-5)


# The register tile of the kernels' trailing updates
# (csrc/cholesky_common.cuh: kTileRows x kTileCols).
TILE_ROWS, TILE_COLS = 64, 8


def _sub_mul(x, y, z):
    """x − y·z as the kernels spell it: a rounded product, then a rounded
    difference (``__fsub_rn(x, __fmul_rn(y, z))``), never fused."""
    return torch.sub(x, torch.mul(y, z))


def _panel_cholesky(a, nb):
    """The panel schedule of ``cholesky_common.cuh::chol_factor`` in plain
    PyTorch.  Each diagonal block is first updated by the previous panel's
    columns, then factored column by column; each panel's strip is solved
    right-looking; the panel's update of the rest of the trailing triangle
    (rows below the next diagonal block) goes in the kernel's 64 × 8
    tiles, the panel's columns in increasing order."""
    w = a.clone()
    n = a.shape[-1]

    def diag_block(k0, kp):
        k1 = min(k0 + nb, n)
        for k in range(kp, k0):
            s = w[:, k0:k1, k]
            w[:, k0:k1, k0:k1] = _sub_mul(w[:, k0:k1, k0:k1],
                                          s[:, :, None], s[:, None, :])
        inv = {}
        for c in range(k0, k1):
            akk = w[:, c, c].clone()
            inv[c] = torch.reciprocal(torch.sqrt(akk))
            w[:, c:k1, c] = torch.mul(w[:, c:k1, c], inv[c][:, None])
            col = w[:, c + 1:k1, c]
            w[:, c + 1:k1, c + 1:k1] = _sub_mul(
                w[:, c + 1:k1, c + 1:k1], col[:, :, None], col[:, None, :])
        return inv

    inv = diag_block(0, 0)
    for k0 in range(0, n - nb, nb):
        k1, k2 = k0 + nb, min(k0 + 2 * nb, n)
        for c in range(k0, k1):
            w[:, k1:, c] = torch.mul(w[:, k1:, c], inv[c][:, None])
            w[:, k1:, c + 1:k1] = _sub_mul(w[:, k1:, c + 1:k1],
                                           w[:, k1:, c:c + 1],
                                           w[:, c + 1:k1, c][:, None, :])
        inv = diag_block(k1, k0)
        for i0 in range(k2, n, TILE_ROWS):
            i1 = min(i0 + TILE_ROWS, n)
            for j0 in range(k1, i1, TILE_COLS):
                j1 = min(j0 + TILE_COLS, n)
                t = w[:, i0:i1, j0:j1].clone()
                for k in range(k0, k1):
                    t = _sub_mul(t, w[:, i0:i1, k:k + 1],
                                 w[:, j0:j1, k][:, None, :])
                w[:, i0:i1, j0:j1] = t
    return torch.tril(w)


def _panel_tri_inverse(l, nb):
    """The row-panel schedule of ``cholesky_common.cuh::chol_tri_inverse``
    in plain PyTorch: each of a panel's rows k, in turn, takes the previous
    panel's rows, then the panel's rows above it, then is divided by Lₖₖ
    (columns j ≤ the row applied only, as the kernel's owners skip the
    zeros above W's diagonal); then the rows below the panel take the
    previous panel's rows in the kernel's 64 × 8 tiles, k in increasing
    order."""
    n = l.shape[-1]
    w = torch.eye(n, dtype=l.dtype).expand_as(l).clone()
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        for k in range(k0, k1):
            for c in range(max(k0 - nb, 0), k):
                w[:, k, :c + 1] = _sub_mul(w[:, k, :c + 1], l[:, k, c:c + 1],
                                           w[:, c, :c + 1])
            w[:, k, :k + 1] = torch.div(w[:, k, :k + 1], l[:, k, k:k + 1])
        for i0 in range(k1, n, TILE_ROWS) if k0 > 0 else ():
            i1 = min(i0 + TILE_ROWS, n)
            for j0 in range(0, k0, TILE_COLS):
                t = w[:, i0:i1, j0:j0 + TILE_COLS].clone()
                for k in range(k0 - nb, k0):
                    t = _sub_mul(t, l[:, i0:i1, k:k + 1],
                                 w[:, k:k + 1, j0:j0 + TILE_COLS])
                w[:, i0:i1, j0:j0 + TILE_COLS] = t
    return w


def test_panel_tiles_are_the_kernels():
    """The emulated tiles and the default panel width are the header's."""
    src = (cuda_build.CSRC_DIR / "cholesky_common.cuh").read_text()
    assert f"constexpr int kTileRows = {TILE_ROWS};" in src
    assert f"constexpr int kTileCols = {TILE_COLS};" in src
    assert "constexpr int kCholPanel = 8;" in src


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("n", [1, 11, 20, 72, 128])
def test_panel_schedule_is_bitwise_the_plain_order(n, nb):
    """The kernels' panel schedules give every element the plain versions'
    operations in the same order, so L and W = L⁻¹ come out bit for bit
    the plain versions' (ragged last panels at n = 11, 20, 72; one partial
    panel at n = 1)."""
    a = torch.tensor(_spd(3, n, 900 + n))
    l = _panel_cholesky(a, nb)
    l_ref = cuda_cholesky.cholesky_plain(a)
    assert torch.equal(l, l_ref)
    eye = torch.eye(n).expand_as(a)
    assert torch.equal(_panel_tri_inverse(l_ref, nb),
                       cuda_cholesky.forward_substitution_plain(l_ref, eye))


def test_chol_probe_patches_match_the_kernel_source():
    """The card probe of K3, K4, K5 and K10 (``bench/chol_probe.py``)
    builds its variants by patching ``csrc/``: every anchor must still
    occur as often as the probe expects, and the probe refuses to run
    without a card."""
    from cuda_matrix_inversion_tpu_torch.bench import chol_probe

    src = (cuda_build.CSRC_DIR / "cholesky.cu").read_text()
    for anchor, _, count in chol_probe.STAMPS:
        assert src.count(anchor) == count, anchor
    header = (cuda_build.CSRC_DIR / "cholesky_common.cuh").read_text()
    assert header.count(chol_probe.PANEL) == 1
    for anchor, _, count in chol_probe.STEPS:
        assert header.count(anchor) == count, anchor
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            chol_probe.main()


def test_indefinite_member_is_confined():
    """A negated member comes out non-finite in both entry points; the
    others equal the same batch without it."""
    a = _spd(5, 20, 3)
    bad = a.copy()
    bad[2] = -bad[2]
    for fn in (cuda_cholesky.cholesky, cuda_cholesky.inverse_cholesky):
        good = fn(torch.tensor(a)).numpy()
        got = fn(torch.tensor(bad)).numpy()
        finite = np.isfinite(got).all(axis=(1, 2))
        assert finite.tolist() == [True, True, False, True, True]
        np.testing.assert_array_equal(got[finite], good[finite])


def test_f64_and_big_n_routes():
    """float64 takes the library routes; n > 128 inverts through Schur onto
    the kernel's plain version (n = 160 splits 80/80); the factor runs K4's
    plain version up to 256 (n = 160 here) and takes the library route
    past it (n = 264), as JAX takes XLA's past its kernel."""
    a64 = torch.tensor(make_spd_batch(2, 24, np.random.default_rng(4)))
    assert torch.equal(cuda_cholesky.inverse_cholesky(a64),
                       linalg.inverse_cholesky(a64))
    assert torch.equal(cuda_cholesky.cholesky(a64), linalg.cholesky(a64))
    a = _spd(2, 160, 5)
    x = cuda_cholesky.inverse_cholesky(torch.tensor(a)).numpy()
    assert x.shape == a.shape and identity_error_inf(a, x) < 1e-4
    before = cuda_cholesky.cholesky_cuda.launches
    l = cuda_cholesky.cholesky(torch.tensor(a))
    assert cuda_cholesky.cholesky_cuda.launches == before
    assert torch.equal(l, cuda_cholesky.cholesky_plain(torch.tensor(a)))
    assert l.dtype == torch.float32
    np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(
        a.astype(np.float64)), rtol=0, atol=1e-4 * np.abs(l.numpy()).max())
    big = torch.tensor(_spd(1, 264, 6))
    assert torch.equal(cuda_cholesky.cholesky(big), linalg.cholesky(big))
    assert cuda_cholesky.cholesky_cuda.launches == before


@pytest.mark.parametrize("n", [8, 24, 100, 150, 160, 256, 272, 304, 512,
                               608])
def test_schur_split_and_pad_are_the_jax_packages(n):
    assert schur._split_point(n) == jax_schur._split_point(n)
    a = np.arange(n * n, dtype=np.float32).reshape(1, n, n)
    got, n_got = schur._pad_even(torch.tensor(a))
    ref, n_ref = jax_schur._pad_even(a)
    assert n_got == n_ref
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,base_n", [(40, 16), (150, 64)])
def test_schur_matches_jax_schur(n, base_n):
    """Both recursions on the library base (no interpreted kernel), split
    for split: the inverse and a 3-column solve, 1e-5."""
    rng = np.random.default_rng(n)
    a = _spd(3, n, n)
    rhs = rng.random((3, n, 3)).astype(np.float32)
    ref = np.asarray(jax_schur.spd_blocked_inverse(a, xla.inverse_cholesky,
                                                   max_base_n=base_n))
    x = schur.spd_blocked_inverse(torch.tensor(a), linalg.inverse_cholesky,
                                  max_base_n=base_n).numpy()
    assert _rel(x, ref) <= 1e-5 and identity_error_inf(a, x) < 1e-4
    ref = np.asarray(jax_schur.spd_schur_solve(a, rhs, xla.inverse_cholesky,
                                               max_base_n=base_n))
    y = schur.spd_schur_solve(torch.tensor(a), torch.tensor(rhs),
                              linalg.inverse_cholesky,
                              max_base_n=base_n).numpy()
    assert y.shape == rhs.shape and _rel(y, ref) <= 1e-5


def test_library_path_hashes_headers(monkeypatch, tmp_path):
    """An edited header (which no .cu names on the nvcc line) must give a
    new library path, or a stale build would be loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = cuda_build.library_path()
    assert cuda_build.library_path() == before
    assert [p.name for p in cuda_build._sources()] == [
        "cholesky.cu", "gauss_jordan.cu", "gp.cu", "lu.cu", "lu_band.cu",
        "lu_bign.cu", "newton_schulz.cu"]
    for header in ("cholesky_common.cuh", "ns_common.cuh", "ns_mma.cuh",
                   "lu_common.cuh", "cluster_common.cuh"):
        path = csrc / header
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert cuda_build.library_path() != before
        path.write_text(text)
        assert cuda_build.library_path() == before
