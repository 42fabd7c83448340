"""Newton-Schulz batched inversion: kernel K1 and the adaptive loop.

Counterpart of ``cuda_matrix_inversion_tpu/ops/newton_schulz.py``.  The
iteration X ← X(2I − AX) is pure batched matrix products and converges
quadratically once ‖I − AX‖ < 1.

* :func:`inverse_newton_schulz_fixed` — the fixed-schedule speed path
  (lanes ``newton_schulz{,_spd,_spd10,_pan500}_pallas``), counterpart of
  ``inverse_newton_schulz_pallas``.  On a CUDA tensor it runs the
  hand-written kernel ``csrc/newton_schulz.cu`` (K1, n ≤ 224: one thread
  block a matrix up to 128, one thread-block cluster past it); on a CPU
  tensor its plain PyTorch version :func:`ns_iterate_plain`.  Past the
  JAX kernel's n = 224 it takes the JAX package's routes past that
  ceiling (Schur, :func:`inverse_newton_schulz_pan500_batched`,
  adaptive).
* :func:`inverse_newton_schulz` — the adaptive, residual-monitored loop
  (lanes ``newton_schulz``, ``newton_schulz_spd``), plain PyTorch.
* :func:`inverse_newton_schulz_warm` — warm-start refinement of a previous
  inverse of a nearby batch, counterpart of ``inverse_newton_schulz_warm``:
  the hand-written kernel K8 (``csrc/newton_schulz.cu``, n ≤ 224) on a
  CUDA tensor, its plain version :func:`ns_refine_plain` on a CPU tensor.

The schedule constants and :func:`scaled_round_coeffs` are copies of the
JAX package's (the port cannot import it where JAX is missing); the CPU
tests pin them bit for bit.  Products that the TPU ran at
``Precision.DEFAULT`` (one bf16 pass) round both operands to bf16 and
accumulate in fp32; ``HIGHEST`` is full fp32.  Never TF32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import warnings

import torch

from cuda_matrix_inversion_tpu_torch.ops import cuda_build, schur
from cuda_matrix_inversion_tpu_torch.ops.linalg import (
    inverse_lu,
    matmul,
    residual_f64,
)

# Default (lo_iters, hi_iters) schedules, calibrated on the TPU to hold the
# 1e-4 gate to kappa <= 30 (spd, pan) and kappa <= 500 (split3).
SPD_SCHEDULE = (6, 2)
PAN_SCHEDULE = (12, 2)
PAN500_SCHEDULE = (14, 2)
MU_MIN_PAN500 = 3e-8
# split3 round noise is ~2⁻¹⁷; this floor keeps the squashed bottom edge
# 100× above it.
SPLIT3_NOISE_FLOOR = 2e-4
# Assumed lower edge of spec(A·X_start): spd µ ≥ ~2λmin/‖A‖∞,
# pan µ = σ²/(‖A‖₁‖A‖∞).
MU_MIN_SPD = 0.01
MU_MIN_PAN = 2e-5


def scaled_round_coeffs(mu_min: float, rounds: int,
                        noise_floor: float = 5e-3):
    """Per-round recentering scalars for scaled Newton-Schulz.

    Each round maps the tracked interval [t, 1] ⊇ spec(AX) through
    c = 2/(1 + max(t, noise_floor)); the clamp keeps eigenvalues at the
    top of the interval from being squashed below the bf16 round noise,
    which made near-identity inputs diverge.  Deterministic in
    ``mu_min``, so the sequence is a constant of the lane.
    """
    t = mu_min  # tracked true lower edge
    cs = []
    for _ in range(rounds):
        c = 2.0 / (1.0 + max(t, noise_floor))
        cs.append(c)
        t = min(1.0, c * t * (2.0 - c * t))
    return tuple(cs)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A resolved fixed schedule: everything K1 needs besides A."""

    init: str             # "spd" or "pan"
    split3: bool          # every product as the 3-pass bf16 split
    lo_iters: int
    hi_iters: int
    polish_highest: bool  # last polish residual in fp32 (bf16 lanes)
    coeffs: tuple         # scaled_round_coeffs, one per lo round


def resolve_schedule(lo_iters: int | None = None, hi_iters: int | None = None,
                     init: str = "pan", polish_highest: bool = True,
                     mu_min: float | None = None,
                     precision: str = "bf16") -> Schedule:
    """Validate a lane's keyword arguments and fill in its defaults, as
    ``inverse_newton_schulz_pallas`` does."""
    if init not in ("pan", "spd"):
        raise ValueError(f"init must be 'pan' or 'spd', got {init!r}")
    if precision not in ("bf16", "split3"):
        raise ValueError(
            f"precision must be 'bf16' or 'split3', got {precision!r}")
    split3 = precision == "split3"
    if split3 and not polish_highest:
        raise ValueError("polish_highest=False is not supported with "
                         "precision='split3'")
    if split3 and init != "pan":
        raise ValueError("precision='split3' supports init='pan' only")
    schedule = (PAN500_SCHEDULE if split3
                else SPD_SCHEDULE if init == "spd" else PAN_SCHEDULE)
    lo = schedule[0] if lo_iters is None else int(lo_iters)
    hi = schedule[1] if hi_iters is None else int(hi_iters)
    if mu_min is None:
        mu_min = (MU_MIN_PAN500 if split3
                  else MU_MIN_SPD if init == "spd" else MU_MIN_PAN)
    noise_floor = SPLIT3_NOISE_FLOOR if split3 else 5e-3
    return Schedule(init=init, split3=split3, lo_iters=lo, hi_iters=hi,
                    polish_highest=bool(polish_highest),
                    coeffs=scaled_round_coeffs(float(mu_min), lo,
                                               noise_floor=noise_floor))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mm_bf16(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One-pass product: bf16 operands, fp32 accumulation."""
    return matmul(_bf16(x), _bf16(y))


def _mm_split3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3-pass bf16 error split hi(x)hi(y) + lo(x)hi(y) + hi(x)lo(y)."""
    xh, yh = _bf16(x), _bf16(y)
    return (matmul(xh, yh) + matmul(_bf16(x - xh), yh)
            + matmul(xh, _bf16(y - yh)))


def _seed(a: torch.Tensor, init: str) -> torch.Tensor:
    """spd: X₁ = 2sI − s²A, s = 1/‖A‖∞; pan: X₀ = Aᵀ/(‖A‖₁‖A‖∞)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    r_inf = a.abs().sum(dim=2).amax(dim=1)
    if init == "spd":
        s = (1.0 / r_inf)[:, None, None]
        return (2.0 * s) * eye - (s * s) * a
    c_1 = a.abs().sum(dim=1).amax(dim=1)
    return a.transpose(1, 2) * (1.0 / (r_inf * c_1))[:, None, None]


def _rounds(a: torch.Tensor, x: torch.Tensor, coeffs, hi_iters: int,
            split3: bool, polish_highest: bool,
            bf16_products: bool, residual64: bool = False) -> torch.Tensor:
    """The lo rounds X ← X·(2cI − c²AX), one per scalar c of ``coeffs``,
    then ``hi_iters`` polish rounds X ← X + X(I − AX), from ``x`` (the
    kernels' round loops).

    ``bf16_products=True`` is the kernels' (compiled-TPU) arithmetic:
    one-pass products on bf16-rounded operands, the 3-pass split where the
    TPU kernel used it.  ``False`` is what the JAX reference computes in
    interpret mode on the CPU (``mid_split=False``): every product full
    fp32, and every polish round counts as final.  ``residual64`` computes
    the split3 polish residuals in float64 (:func:`linalg.residual_f64`),
    as K1's and K8's cluster instances past n = 128 do."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    if bf16_products:
        one, dot3 = _mm_bf16, _mm_split3
    else:
        one = dot3 = matmul
    contract = dot3 if split3 else one
    for c in coeffs:
        t = (2.0 * c) * eye - (c * c) * contract(a, x)
        x = contract(x, t)
    for i in range(hi_iters):
        if split3:
            r = residual_f64(a, x) if residual64 else eye - matmul(a, x)
            x = x + dot3(x, r)
            continue
        final = ((i == hi_iters - 1) and polish_highest) or not bf16_products
        r = eye - (matmul(a, x) if final else dot3(a, x))
        x = x + one(x, r)
    return x


def ns_iterate_plain(a: torch.Tensor, sched: Schedule,
                     bf16_products: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1 on an fp32 ``(batch, n, n)`` tensor:
    the seed, then the schedule's rounds (``bf16_products`` as in
    :func:`_rounds`).  Past n = 128 (K1's cluster instance) the split3
    polish residuals are float64, as K8's there: an fp32 one leaves the
    κ = 500 class at 1.05e-4 at n = 224."""
    residual64 = (bf16_products and sched.split3
                  and a.shape[-1] > cuda_build.MAX_N)
    return _rounds(a, _seed(a, sched.init), sched.coeffs, sched.hi_iters,
                   sched.split3, sched.polish_highest, bf16_products,
                   residual64)


def ns_refine_plain(a: torch.Tensor, x0: torch.Tensor, lo: int, hi: int,
                    split3: bool, bf16_products: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K8 on fp32 ``(batch, n, n)`` tensors:
    ``lo`` rounds X ← X(2I − AX) from X0 with no recentering scalar (c = 1:
    the start is already converged), then ``hi`` polish rounds, the last
    residual in fp32 (``bf16_products`` as in :func:`_rounds`).  Past
    n = 128 (K8's cluster instance) the split3 residuals are float64: an
    fp32 one leaves the κ = 500 class over the 1e-4 gate at n = 224."""
    residual64 = (bf16_products and split3
                  and a.shape[-1] > cuda_build.MAX_N)
    return _rounds(a, x0, (1.0,) * lo, hi, split3, True, bf16_products,
                   residual64)


# round_scalars' buffers by (coeffs, device), filled once each.
_ROUND_SCALARS: dict = {}


def round_scalars(coeffs: tuple, device: torch.device) -> tuple:
    """The per-round scalars K1 and K6 read from device memory, for a
    schedule's ``coeffs`` (:func:`scaled_round_coeffs`): the addresses of
    fp32(2c) and fp32(c²) a lo round, each computed in double and rounded
    once to fp32, in a ``(2, lo)`` tensor on ``device``; ``(None, None)``
    for no lo round.  Any number of rounds.  The buffer is filled once a
    schedule and device and kept, so a launch copies nothing."""
    if not coeffs:
        return None, None
    key = (coeffs, device)
    if key not in _ROUND_SCALARS:
        buf = torch.empty((2, len(coeffs)), dtype=torch.float32,
                          device=device)
        buf.copy_(torch.tensor([[2.0 * c for c in coeffs],
                                [c * c for c in coeffs]],
                               dtype=torch.float32))
        _ROUND_SCALARS[key] = buf
    buf = _ROUND_SCALARS[key]
    return buf[0].data_ptr(), buf[1].data_ptr()


def ns_iterate_cuda(a: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """Launch K1 (``csrc/newton_schulz.cu``) on a CUDA fp32 batch, n ≤
    :data:`cuda_build.WARM_MAX_N` (one thread block a matrix up to 128,
    one 2 × 2 thread-block cluster past it), any number of lo rounds.

    ``ns_iterate_cuda.launches`` counts the launches,
    ``ns_iterate_cuda.band_launches`` those of the cluster instance and
    ``ns_iterate_cuda.band_launches_<NP>`` those at each padded size NP
    (160, 192, 224), as the launch reports it."""
    cuda_build.check_kernel_input(a, "newton_schulz kernel",
                                  max_n=cuda_build.WARM_MAX_N)
    cuda_build.check_cuda_f32("newton_schulz kernel", a)
    a = a.contiguous()
    x = torch.empty_like(a)
    two_c, c_sq = round_scalars(sched.coeffs, a.device)
    device, stream = cuda_build.launch_args(a)
    quad_np = ctypes.c_int(0)
    err = cuda_build.library().cmi_ns_inverse(
        a.data_ptr(), x.data_ptr(), a.shape[0], a.shape[-1],
        int(sched.init == "spd"), sched.lo_iters, sched.hi_iters,
        int(sched.split3), int(sched.polish_highest), two_c, c_sq, device,
        stream, ctypes.byref(quad_np))
    cuda_build.check(err, "newton_schulz kernel")
    ns_iterate_cuda.launches += 1
    if quad_np.value:
        ns_iterate_cuda.band_launches += 1
        key = f"band_launches_{quad_np.value}"
        setattr(ns_iterate_cuda, key, getattr(ns_iterate_cuda, key) + 1)
    return x


ns_iterate_cuda.launches = 0
ns_iterate_cuda.band_launches = 0
for _np in cuda_build.NS_BAND_NP:
    setattr(ns_iterate_cuda, f"band_launches_{_np}", 0)


def inverse_newton_schulz_fixed(
    a: torch.Tensor,
    lo_iters: int | None = None,
    hi_iters: int | None = None,
    init: str = "pan",
    polish_highest: bool = True,
    mu_min: float | None = None,
    precision: str = "bf16",
) -> torch.Tensor:
    """Fixed-schedule scaled Newton-Schulz inverse, one K1 launch.

    Counterpart of the JAX package's
    ``ops.newton_schulz.inverse_newton_schulz_pallas``, with the same
    keyword arguments and domains: ``init="pan"`` any nonsingular A with
    κ ≲ 30; ``init="spd"`` SPD A (caller-asserted) with κ ≲ 30;
    ``precision="split3"`` (pan only) any nonsingular A with κ ≲ 500.
    float64 input goes to the adaptive :func:`inverse_newton_schulz`
    (which takes the LU route), with a warning for split3.

    K1 serves n ≤ 224, the JAX kernel's ceiling: one thread block a
    matrix up to n = 128, one thread-block cluster past it, where the
    split3 residuals are float64 (:func:`ns_iterate_plain`).  n > 224
    takes the JAX package's routes past its ceiling: ``init="spd"`` the
    Schur recursion (:func:`schur.spd_blocked_inverse`) down to this lane
    at a base of 224, with every schedule keyword forwarded; split3
    :func:`inverse_newton_schulz_pan500_batched`; bf16 ``init="pan"`` the
    adaptive :func:`inverse_newton_schulz`.
    """
    sched = resolve_schedule(lo_iters, hi_iters, init, polish_highest,
                             mu_min, precision)
    if a.dtype == torch.float64:
        if sched.split3:
            warnings.warn(
                "precision='split3' with float64 input: serving via the "
                "adaptive f64 Newton-Schulz path (f64 arithmetic already "
                "exceeds the split-precision floor)", stacklevel=2)
        return inverse_newton_schulz(a, init=init)
    if a.ndim == 3 and a.shape[-1] > cuda_build.WARM_MAX_N:
        if init == "spd":
            # κ(A11), κ(S) ≤ κ(A) for SPD A, so the lane's κ domain carries
            base = functools.partial(
                inverse_newton_schulz_fixed, lo_iters=lo_iters,
                hi_iters=hi_iters, init="spd", polish_highest=polish_highest,
                mu_min=mu_min)
            return schur.spd_blocked_inverse(
                a, base, max_base_n=cuda_build.WARM_MAX_N)
        if sched.split3:
            return inverse_newton_schulz_pan500_batched(a, lo_iters, hi_iters,
                                                        mu_min)
        return inverse_newton_schulz(a, init=init)
    cuda_build.check_kernel_input(a, "newton_schulz kernel",
                                  max_n=cuda_build.WARM_MAX_N)
    a32 = a.to(torch.float32)
    # the plain version with bf16 products, the kernel's arithmetic
    x = cuda_build.on_device(a32, "newton_schulz", ns_iterate_cuda,
                             ns_iterate_plain, a32, sched)
    return x.to(a.dtype)


def inverse_newton_schulz_pan500_batched(
    a: torch.Tensor,
    lo_iters: int | None = None,
    hi_iters: int | None = None,
    mu_min: float | None = None,
) -> torch.Tensor:
    """The split3 (pan500) lane as batched products, any n: the
    counterpart of the JAX package's ``inverse_newton_schulz_pan500_xla``,
    which serves κ ≲ 500 general matrices past its kernel's ceiling.

    The pan seed, ``lo_iters`` scaled rounds with both products the 3-pass
    bf16 split (XLA ``HIGH``) and the recentering scalars of
    ``scaled_round_coeffs(MU_MIN_PAN500, …, SPLIT3_NOISE_FLOOR)``: K1's
    split3 rounds, outside any kernel.  Then ``hi_iters`` rounds with the
    update split and the residual in float64
    (:func:`linalg.residual_f64`), where JAX's is fp32 at ``HIGHEST``: an
    fp32 residual on the card leaves κ = 500 at n = 256 over the gate.
    float64 takes the LU route."""
    if a.dtype == torch.float64:
        return inverse_lu(a)
    sched = resolve_schedule(lo_iters, hi_iters, "pan", True, mu_min,
                             "split3")
    a32 = a.to(torch.float32)
    x = _rounds(a32, _seed(a32, "pan"), sched.coeffs, 0, True, True, True)
    for _ in range(sched.hi_iters):
        x = x + _mm_split3(x, residual_f64(a32, x))
    return x.to(a.dtype)


def ns_refine_cuda(a: torch.Tensor, x0: torch.Tensor, lo: int, hi: int,
                   split3: bool) -> torch.Tensor:
    """Launch K8 (``csrc/newton_schulz.cu``) on CUDA fp32 batches, n ≤
    :data:`cuda_build.WARM_MAX_N` (one thread block a matrix up to 128, one
    thread-block cluster past it), any number of rounds.

    ``ns_refine_cuda.launches`` counts the launches and
    ``ns_refine_cuda.band_launches`` those of the cluster instance."""
    cuda_build.check_kernel_input(a, "newton_schulz warm kernel",
                                  max_n=cuda_build.WARM_MAX_N)
    cuda_build.check_cuda_f32("newton_schulz warm kernel", a, x0)
    if x0.shape != a.shape:
        raise ValueError(f"newton_schulz warm kernel: x0 {tuple(x0.shape)} "
                         f"must match a {tuple(a.shape)}")
    a, x0 = a.contiguous(), x0.contiguous()
    x = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)
    err = cuda_build.library().cmi_ns_warm(
        a.data_ptr(), x0.data_ptr(), x.data_ptr(), a.shape[0], a.shape[-1],
        lo, hi, int(split3), device, stream)
    cuda_build.check(err, "newton_schulz warm kernel")
    ns_refine_cuda.launches += 1
    if a.shape[-1] > cuda_build.MAX_N:
        ns_refine_cuda.band_launches += 1
    return x


ns_refine_cuda.launches = 0
ns_refine_cuda.band_launches = 0


def _warm_refine_split(a: torch.Tensor, x0: torch.Tensor, lo: int,
                       hi: int) -> torch.Tensor:
    """The warm rounds past the kernel's n = 224, as batched products:
    the counterpart of the JAX package's ``_warm_refine_split_xla`` (which
    JAX computes outside any Pallas kernel).  Every product the 3-pass bf16
    split (XLA ``HIGH``); the polish residual in float64
    (:func:`linalg.residual_f64`), where JAX's is fp32 at ``HIGHEST``: an
    fp32 residual leaves κ = 500 at n = 256 over the gate, as on the cold
    routes past 128."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    x = x0
    for _ in range(lo):
        x = _mm_split3(x, 2.0 * eye - _mm_split3(a, x))
    for _ in range(hi):
        x = x + _mm_split3(x, residual_f64(a, x))
    return x


def inverse_newton_schulz_warm(a: torch.Tensor, x0: torch.Tensor,
                               lo_iters: int = 2, hi_iters: int = 1,
                               precision: str = "bf16") -> torch.Tensor:
    """Warm-start batched inversion: refine ``x0``, an inverse of a
    nearby batch, for ``a`` in one K8 launch.

    Counterpart of the JAX package's ``inverse_newton_schulz_warm`` (its
    ``block`` and ``interpret`` are TPU knobs).  When A drifts by a relative
    δ, the old inverse has residual ≈ δ·κ(A); ``lo_iters`` unscaled rounds
    and ``hi_iters`` polish rounds (the last residual fp32) recover the 1e-4
    gate while δ·κ ≲ 0.3, and for ``precision="bf16"`` also κ ≲ 30 (the
    one-pass X·R update carries 2⁻⁹·κ·‖R‖).  ``precision="split3"`` runs
    every product as the 3-pass split, for κ ≲ 500.

    K8 serves n ≤ 224, the JAX kernel's ceiling, in both precisions: one
    thread block a matrix up to n = 128, one thread-block cluster past it,
    where the split3 residuals are float64 (:func:`ns_refine_plain`).
    Routes, the JAX package's own past its ceiling: float64 takes the
    adaptive :func:`inverse_newton_schulz` (its LU route).  n above 224
    takes, for split3, :func:`_warm_refine_split` with one extra polish
    round; for bf16 a cold adaptive solve, which discards ``x0`` and warns.
    """
    if precision not in ("bf16", "split3"):
        raise ValueError(
            f"precision must be 'bf16' or 'split3', got {precision!r}")
    if x0.shape != a.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} must match a "
                         f"{tuple(a.shape)}")
    if a.dtype == torch.float64:
        return inverse_newton_schulz(a)
    split3 = precision == "split3"
    if a.shape[-1] > cuda_build.WARM_MAX_N:
        if split3:
            out = _warm_refine_split(a.to(torch.float32),
                                     x0.to(torch.float32), lo_iters,
                                     hi_iters + 1)
            return out.to(a.dtype)
        warnings.warn(
            f"the warm kernel serves n <= {cuda_build.WARM_MAX_N}; "
            f"n={a.shape[-1]} runs a cold adaptive solve (prev inverse "
            f"discarded)", stacklevel=2)
        return inverse_newton_schulz(a)
    cuda_build.check_kernel_input(a, "newton_schulz warm kernel",
                                  max_n=cuda_build.WARM_MAX_N)
    a32, x32 = a.to(torch.float32), x0.to(torch.float32)
    x = cuda_build.on_device(a32, "newton_schulz warm", ns_refine_cuda,
                             ns_refine_plain, a32, x32, lo_iters, hi_iters,
                             split3)
    return x.to(a.dtype)


def _residual_inf(eye: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """‖I − AX‖∞, max over the batch (a 0-dim fp32 tensor)."""
    return (eye - ax).abs().sum(dim=-1).amax()


def inverse_newton_schulz(
    a: torch.Tensor,
    max_iters: int = 48,
    polish_iters: int = 1,
    tol: float = 1e-2,
    init: str = "pan",
) -> torch.Tensor:
    """Batched inverse by adaptive Newton-Schulz (plain PyTorch, no kernel).

    Counterpart of ``ops.newton_schulz.inverse_newton_schulz``: a bf16
    contraction phase while the batch residual strictly improves and
    exceeds ``tol``, a restart from the seed if it failed to get below 1,
    an fp32 phase to the fp32 floor, then ``polish_iters`` fp32 steps.
    ``init="pan"`` takes any nonsingular A, ``"spd"`` SPD A only.
    Singular input gives non-finite entries.  float64 goes to the LU route.
    """
    if init not in ("pan", "spd"):
        raise ValueError(f"init must be 'pan' or 'spd', got {init!r}")
    if a.dtype == torch.float64:
        return inverse_lu(a)
    orig_dtype = a.dtype
    a = a.to(torch.float32)
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    x0 = _seed(a, init)

    def phase(x, mm, tol_phase, iters_left):
        """Iterate while the residual strictly improves (once below 1),
        exceeds ``tol_phase`` and stays under the divergence cap.  A NaN
        residual fails every comparison and ends the loop."""
        ax = mm(a, x)
        res = _residual_inf(eye, ax)
        prev = torch.tensor(float("inf"))
        i = 0
        while (i < iters_left and bool(res > tol_phase) and bool(res < 1e4)
               and (bool(res < prev) or bool(res >= 1.0))):
            x = mm(x, 2.0 * eye - ax)
            ax = mm(a, x)
            prev, res = res, _residual_inf(eye, ax)
            i += 1
        return x, res

    x, res = phase(x0, _mm_bf16, tol, max_iters)
    if not bool(res < 1.0):
        x = x0  # bf16 did not contract: restart the fp32 phase from the seed
    x, _ = phase(x, matmul, 0.0, max_iters)
    for _ in range(polish_iters):
        x = matmul(x, 2.0 * eye - matmul(a, x))
    return x.to(orig_dtype)
