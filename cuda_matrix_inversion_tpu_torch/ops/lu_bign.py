"""Batched pivoted LU inversion past the one-block kernels: kernel K9.

Counterpart of ``cuda_matrix_inversion_tpu/ops/lu_bign.py`` (lane
``lu_bign_pallas``, and ``lu_pallas`` past K2's n = 256), the analog of
cuBLAS ``getrf`` + ``getri`` at any n.  The ``(batch, n, n)`` work matrix
stays in device memory; the only hand-written kernel is the part that a
batched product cannot do, the latency-bound per-column pivot chain of one
``pw``-wide block column (K9, ``csrc/lu_bign.cu``: :func:`lu_panel_cuda` on
a CUDA tensor, its plain PyTorch version :func:`lu_panel_plain` on a CPU
tensor).  Every O(n³) term is a batched fp32 product (:func:`linalg.matmul`,
never TF32), as the JAX package leaves them to XLA at ``HIGHEST``:

* per panel: K9, then U12 = L11⁻¹·A12 and the trailing update
  A22 −= L21·U12 over the rows below the panel;
* getri: M = L⁻¹ by block forward substitution, X = U⁻¹M by block back
  substitution, then A⁻¹ = X·P as one column gather;
* one Newton polish X ← X + X·R with the residual R = I − AX in float64
  (:func:`linalg.residual_f64`) and the update in fp32.  The JAX package's
  residual is fp32; on the card an fp32 residual leaves the κ = 500 class
  at n = 512 over the 1e-4 gate, where the TPU's passed.

Unlike the TPU kernel, rows move: K9 swaps them physically (LAPACK's
``laswp``), so the work matrix holds PA and no destination vector or
one-hot contraction is needed.  n is padded to a multiple of ``pw`` with an
identity block and the result un-sliced.  A singular member comes out
non-finite and the others are unaffected.
"""

from __future__ import annotations

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, linalg

# Shared memory one thread block may use on Hopper.
MAX_SMEM = 232448
# The panel width :func:`pick_pw` tries first: the fastest of 16, 32 and 64
# at 100×512 on the card (PERF.md, the pw ladder of chip_smoke.py).
DEFAULT_PW = 64


def panel_ld(pw: int) -> int:
    """K9's row stride in shared memory (``panel_ld`` in the source): 4·odd
    floats for the kernel's templated widths 16, 32 and 64 (68, 36, 20:
    16-byte rows, float4 reads down 8 rows on distinct banks), an odd
    stride for any other width; always past pw (the spare column holds the
    row's position)."""
    if pw in (16, 32, 64):
        q = (pw + 3) // 4
        return 4 * (q if q % 2 else q + 1)
    return pw + 2 if pw % 2 else pw + 1


def panel_smem_bytes(m: int, pw: int) -> int:
    """K9's shared memory for a panel over m rows (the first panel of an
    (n, n) matrix has m = n): max(m, 3·pw) rows at :func:`panel_ld` (the
    free rows stage the gather and hold the triangles' columns), three
    64-bit pivot candidates, the pivots, the row map and the gather's rows
    (``panel_smem`` in the source)."""
    return (max(m, 3 * pw) * panel_ld(pw) + 8 + 7 * pw + 4) * 4


def pick_pw(n: int) -> int:
    """Panel width for n: the widest of :data:`DEFAULT_PW` and its halvings
    down to 8 that keeps at least two panels (the JAX rule: a single panel
    has no trailing update) and whose first panel, at n padded to a
    multiple of it, fits one block's shared memory; 8 when none does
    (then :func:`inverse_lu_big` raises).  The ceilings at n padded to pw:
    832 at pw 64, 1600 at 32, 2896 at 16, 6448 at 8."""
    pw = DEFAULT_PW
    while pw > 8:
        n_pad = -(-n // pw) * pw
        if 2 * pw <= max(n, 16) and panel_smem_bytes(n_pad, pw) <= MAX_SMEM:
            return pw
        pw //= 2
    return 8


def _check_panel(n: int, pw: int) -> None:
    """Raise ``ValueError`` when a panel over n rows at width pw needs more
    shared memory than one block may use (:func:`panel_smem_bytes`)."""
    if panel_smem_bytes(n, pw) > MAX_SMEM:
        raise ValueError(
            f"lu_bign: the (n={n}, pw={pw}) panel needs "
            f"{panel_smem_bytes(n, pw)} bytes of shared memory, over the "
            f"{MAX_SMEM} one block may use; pass a smaller pw")


def _swap_rows(t: torch.Tensor, rows: torch.Tensor, r: int,
               p: torch.Tensor) -> None:
    """Swap row ``r`` with row ``p[b]`` of each member ``b`` of ``t``."""
    row_r, row_p = t[rows, r].clone(), t[rows, p].clone()
    t[rows, r] = row_p
    t[rows, p] = row_r


def lu_panel_plain(work: torch.Tensor, perm: torch.Tensor, k0: int,
                   pw: int):
    """Plain PyTorch version of K9, updating ``work`` (batch, n, n) fp32
    and ``perm`` (batch, n) int32 in place: getf2 on columns k0..k0+pw−1
    over rows k0..n−1, the panel's row swaps on the other columns and on
    ``perm``.  Returns ``(ipiv, ldi, udi)``: the pivot rows (batch, pw)
    int32 (LAPACK's, 0-based), L11⁻¹ and U11⁻¹ (batch, pw, pw)."""
    batch = work.shape[0]
    rows = torch.arange(batch, device=work.device)
    pan = work[:, k0:, k0:k0 + pw].clone()
    ipiv = torch.empty((batch, pw), dtype=torch.int32, device=work.device)
    for j in range(pw):
        p = j + torch.argmax(pan[:, j:, j].abs(), dim=1)  # first maximum
        ipiv[:, j] = (k0 + p).to(torch.int32)
        _swap_rows(pan, rows, j, p)
        l = pan[:, j + 1:, j] / pan[:, j, j:j + 1]
        pan[:, j + 1:, j + 1:] -= l[:, :, None] * pan[:, j:j + 1, j + 1:]
        pan[:, j + 1:, j] = l
    for s in range(pw):
        p = ipiv[:, s].long()
        _swap_rows(work, rows, k0 + s, p)
        _swap_rows(perm, rows, k0 + s, p)
    work[:, k0:, k0:k0 + pw] = pan
    d = pan[:, :pw, :]
    eye = torch.eye(pw, dtype=work.dtype, device=work.device)
    y, z = eye.repeat(batch, 1, 1), eye.repeat(batch, 1, 1)
    for k in range(pw):
        kk = pw - 1 - k
        z[:, kk, :] = z[:, kk, :] / d[:, kk, kk:kk + 1]
        y[:, k + 1:, :] -= d[:, k + 1:, k:k + 1] * y[:, k:k + 1, :]
        z[:, :kk, :] -= d[:, :kk, kk:kk + 1] * z[:, kk:kk + 1, :]
    return ipiv, y, z


def lu_panel_cuda(work: torch.Tensor, perm: torch.Tensor, k0: int, pw: int):
    """Launch K9 (``csrc/lu_bign.cu``) on a CUDA batch, with
    :func:`lu_panel_plain`'s arguments, results and in-place updates.

    ``lu_panel_cuda.launches`` counts the launches."""
    cuda_build.check_cuda_f32("lu_bign kernel", work)
    batch, n = work.shape[0], work.shape[-1]
    if work.shape != (batch, n, n) or not work.is_contiguous():
        raise ValueError(f"lu_bign kernel: work must be a contiguous "
                         f"(batch, n, n) tensor, got {tuple(work.shape)}")
    if (perm.shape != (batch, n) or perm.dtype != torch.int32
            or perm.device != work.device or not perm.is_contiguous()):
        raise ValueError("lu_bign kernel: perm must be a contiguous "
                         "(batch, n) int32 tensor on work's device")
    if not (pw >= 1 and 0 <= k0 and k0 + pw <= n):
        raise ValueError(f"lu_bign kernel: panel {k0}..{k0 + pw} outside "
                         f"n = {n}")
    _check_panel(n - k0, pw)
    ipiv = torch.empty((batch, pw), dtype=torch.int32, device=work.device)
    ldi = torch.empty((batch, pw, pw), dtype=torch.float32,
                      device=work.device)
    udi = torch.empty_like(ldi)
    device, stream = cuda_build.launch_args(work)
    err = cuda_build.library().cmi_lu_panel(
        work.data_ptr(), perm.data_ptr(), ipiv.data_ptr(), ldi.data_ptr(),
        udi.data_ptr(), batch, n, k0, pw, device, stream)
    cuda_build.check(err, "lu_bign kernel")
    lu_panel_cuda.launches += 1
    return ipiv, ldi, udi


lu_panel_cuda.launches = 0


def _panel_on_device(work, perm, k0, pw):
    return cuda_build.on_device(work, "lu_bign", lu_panel_cuda,
                                lu_panel_plain, work, perm, k0, pw)


def lu_factor_big(a: torch.Tensor, pw: int, panel=_panel_on_device):
    """Blocked getrf of an fp32 (batch, n, n) batch with n a multiple of
    ``pw``: ``(lu, perm, ipivs, ldis, udis)``, the compact factors of PA
    (unit L below the diagonal, U on and above), the row permutation (row
    i of PA is row ``perm[:, i]`` of A), and per panel its pivot rows,
    L11⁻¹ and U11⁻¹.  ``panel`` is K9 (or its plain version)."""
    batch, n = a.shape[0], a.shape[-1]
    work = a.clone(memory_format=torch.contiguous_format)
    perm = torch.arange(n, dtype=torch.int32, device=a.device).repeat(
        batch, 1)
    ipivs, ldis, udis = [], [], []
    for k0 in range(0, n, pw):
        k1 = k0 + pw
        ipiv, ldi, udi = panel(work, perm, k0, pw)
        if k1 < n:
            u12 = linalg.matmul(ldi, work[:, k0:k1, k1:])
            work[:, k0:k1, k1:] = u12
            work[:, k1:, k1:] -= linalg.matmul(work[:, k1:, k0:k1], u12)
        ipivs.append(ipiv)
        ldis.append(ldi)
        udis.append(udi)
    return work, perm, ipivs, ldis, udis


def _getri(lu: torch.Tensor, perm: torch.Tensor, ldis, udis,
           pw: int) -> torch.Tensor:
    """A⁻¹ = U⁻¹L⁻¹P from the blocked factors: M = L⁻¹ by block forward
    substitution (row block p of M has columns 0..k1 only), X = U⁻¹M by
    block back substitution, then the column permutation as a gather."""
    batch, n = lu.shape[0], lu.shape[-1]
    m = torch.zeros_like(lu)
    for p, ldi in enumerate(ldis):
        k0, k1 = p * pw, (p + 1) * pw
        m[:, k0:k1, k0:k1] = ldi
        if k0:
            s = linalg.matmul(lu[:, k0:k1, :k0], m[:, :k0, :k0])
            m[:, k0:k1, :k0] = -linalg.matmul(ldi, s)
    x = torch.zeros_like(lu)
    for p in range(len(udis) - 1, -1, -1):
        k0, k1 = p * pw, (p + 1) * pw
        rhs = m[:, k0:k1, :]
        if k1 < n:
            rhs = rhs - linalg.matmul(lu[:, k0:k1, k1:], x[:, k1:, :])
        x[:, k0:k1, :] = linalg.matmul(udis[p], rhs)
    # A⁻¹[:, perm[i]] = X[:, i]: gather the columns by the inverse permutation
    inv = torch.empty_like(perm, dtype=torch.int64)
    inv.scatter_(1, perm.long(), torch.arange(n, device=lu.device).expand(
        batch, n))
    return x.gather(2, inv[:, None, :].expand(batch, n, n))


def _inverse(a: torch.Tensor, pw: int | None, polish: bool,
             panel) -> torch.Tensor:
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"lu_bign: expected (batch, n, n), got "
                         f"{tuple(a.shape)}")
    n0 = a.shape[-1]
    if pw is None:
        pw = pick_pw(max(n0, 8))
    n = -(-n0 // pw) * pw
    _check_panel(n, pw)
    a32 = a.to(torch.float32)
    work = a32
    if n != n0:  # identity block: blockdiag(A, I)⁻¹ = blockdiag(A⁻¹, I)
        work = torch.zeros((a.shape[0], n, n), dtype=torch.float32,
                           device=a.device)
        work[:, :n0, :n0] = a32
        work[:, n0:, n0:] = torch.eye(n - n0, device=a.device)
    lu, perm, _, ldis, udis = lu_factor_big(work, pw, panel)
    x = _getri(lu, perm, ldis, udis, pw)[:, :n0, :n0]
    if polish:
        x = x + linalg.matmul(x, linalg.residual_f64(a, x))
    return x.to(a.dtype)


def inverse_lu_big(a: torch.Tensor, pw: int | None = None,
                   polish: bool = True) -> torch.Tensor:
    """Batched general-matrix inverse with partial pivoting at any n whose
    first panel fits one block (lane ``lu_bign_pallas``; ``lu_pallas``
    past n = 256).

    ``pw`` is the panel width (:func:`pick_pw` when None).  Runs in fp32
    (the polish residual in fp64) and returns ``a``'s dtype (float64
    callers get fp32 accuracy, as in the JAX package; ``lu_pallas`` keeps
    float64 on the library route).  A panel past the shared-memory ceiling
    raises ``ValueError``."""
    return _inverse(a, pw, polish, _panel_on_device)


def inverse_lu_big_plain(a: torch.Tensor, pw: int | None = None,
                         polish: bool = True) -> torch.Tensor:
    """:func:`inverse_lu_big` with K9's plain version on any device: the
    reference the kernel's whole blocked-LU output is held against."""
    return _inverse(a, pw, polish, lu_panel_plain)
