#!/usr/bin/env python3
"""Drive the PyTorch / H100 port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the hand-written kernels (``csrc/*.cu``, sm_90a);
3. kernels: each kernel (K1–K8, K10, K11) against its plain PyTorch
   version on the card, at n ∈ {8, 20, 64, 128} and batch ∈ {1, 7, 100}
   (and 1600 at n = 128; K1 and K8 also at n ∈ {1, 40, 72, 127}, K1 with
   ``polish_highest=False`` at n ∈ {20, 72, 128}; K6 and K11 also at n =
   72; K8 and K11 at n ∈ {20, 128} with (lo, hi) ∈ {(0, 1), (1, 2), (3,
   2)}; K2 also at n ∈ {1, 2, 7, 40, 72, 127} and on draws of small
   integers, where exact ties decide the pivots, its raw ``inv`` and
   ``ipiv`` equal to the plain version's (``torch.equal``) on every finite
   member; K7 likewise at n ∈ {1, 7, 40, 72, 127, 160, 192} and on ties,
   its raw inverse equal to the plain version's); K2–K7 and K10 with one
   singular or indefinite
   member per batch, K8 and K11 with one member whose previous inverse
   holds a NaN, which alone must come out non-finite; K9 in the blocked factor and the whole polished blocked LU
   against the same routine on its plain version, n ∈ {160, 256, 512} ×
   batch ∈ {1, 7, 100}, 1600×256, 7×160 at pw = 8 and 24 (the generic
   instance) and draws of small integers (exact ties decide the pivots),
   one member with a zero column; the factor, pivots,
   perm and triangle inverses bitwise;
4. main path: every registry lane through ``inverse_batched_device`` on
   ``make_spd_batch(100, 128, default_rng(2026))`` and a 1600×128 batch,
   ``lu_pallas`` and pan500 also on ``make_square_batch(100, 128)``, and
   ``inverse_batched`` once NumPy in, NumPy out; every result must pass
   max‖AA⁻¹−I‖∞ < 1e-4 (fp64).  Then the GP pipeline: every
   ``gp_mean_variance`` method on GP systems drawn as
   ``generate_gaussian_fixtures`` draws them at 100×128 and 1600×128,
   ``gp_mean``/``gp_variance`` with the kernel methods, ``entry()``'s
   forward step (batch 64, n = 128, ``solve``) through
   ``gp_mean_variance_host(..., device="cuda")``, and the Cholesky factor
   entry point; every mean and variance within 1e-4 of the fp64 closed
   form.  K1–K6's launch counters must move in this path.  Then the
   serving and fitting path, with the counters reset: the engines
   (``InversionEngine`` on ``gauss_pallas``, ``lu_pallas`` and the spd10
   lane at 100×128 and 1600×128, its bf16 ``inverse_warm`` with and
   without ``check``, a pan500 engine's split3 ``inverse_warm``;
   ``GPEngine.mean_variance``, ``mean_variance_warm`` chained over 3
   drifting timesteps, ``fit`` at 1600×128 for 150 steps, and the K10 fit
   against the ``torch.linalg`` fit at 100×128), every result through the
   gate or within 1e-4 of the fp64 closed form; K7, K8, K10 and K11's
   counters must move in this path.  Then the big-n and fp64 path, with the
   counters reset: ``lu_pallas`` and ``lu_bign_pallas`` at 100×512 (JAX's
   κ = 500 ``lu_bign_512_gate`` draw), ``lu_pallas`` at 1600×256, the
   pan500, spd10 and spd lanes at n = 256, an ``lu_pallas`` engine in its
   256 and 512 buckets, ``bucketed_inverse`` on a ragged list (5 … 512)
   with ``lu_pallas`` and ``cholesky_pallas``, the warm split3 route at
   100×256 (κ = 500, drifted by 1e-4 from its exact inverse), all through
   the gate; and
   ``lu_hiacc`` against JAX's fp64 contracts (≤ 1e-11 at κ = 500, n = 128,
   also beside a singular member; ≤ 1e-8 at κ = 2e4 adaptive and on the
   κ ≈ 4n class at n = 512); K2 and K9's counters must move in this path;
5. timing: CUDA events, median of 20 calls after warm-up, for each lane,
   each GP method, and each kernel beside its plain version and the
   library (``torch.linalg.inv``; ``torch.linalg.cholesky``; the GP
   ``solve`` method on cuSOLVER), K1, K8, K6 and K11 also beside their
   CUDA-core times before their tensor-core redesign, K3, K4, K5 and K10 beside
   theirs before the panel-blocked factor and L⁻¹, K2 beside its time
   before its Hopper redesign and on the general class too, K7 beside its
   time before its Hopper redesign; the warm lanes against
   the cold ones, one fit step of each method, and one engine request NumPy
   in and out;
   at 100×512 and 1600×256 K9 alone (its launches in one call, summed)
   beside its time before the Hopper redesign, the port's blocked factor
   ``lu_factor_big`` and ``torch.linalg.lu_factor_ex`` (the library
   factor, a yardstick the port never calls), the ``lu_bign_pallas`` lane
   beside its bound, ``torch.linalg.inv``, the plain routine, ``lu_hiacc``
   and the panel-width ladder;
6. reference harness, with the counters reset: the port's fixture tree
   (``generate_all`` at n ∈ {8, 32, 128}, 100 matrices), the native
   LAPACK oracle's build (optional: its rows register when it loads), the
   ``inverse_bench`` CLI on the default roster at 100×128 and 1600×128 and
   on the general roster at 100×128 (every requested row present, every
   row through the gate on its returned inverse), ``gauss_bench`` with
   each method at 100×128 and 1600×128 and its fit rows at 1600×128
   (every mean and variance row within 1e-4 a matrix of the fp64 truth),
   ``stream_inverse`` over the written ``a.mats`` files (the same bits as
   the lane called directly on the same batches) and the autodiff backward
   through K2 against its fp64 closed form; K1, K2, K3, K5, K6, K7, K9
   and K10's counters must move.  Each CLI device row's mean ms is printed
   beside phase 5's time for the same lane and shape.

The line before the last is ``{"kernels": [...]}`` with each kernel's
bound (the larger of its bytes over the HBM rate and its operations over
the peak rate of their type, for this run's shapes) and library time; the
last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

GATE = 1e-4
# K1 kernel vs its plain version, max-norm relative: the two differ only in
# summation order; each lands within its residual (≲ 2e-5 at the lanes'
# κ edges) of A⁻¹, so the difference is bounded by their sum.
K1_RTOL = 2e-4
# K2 after the polish: SPD draws (κ ≈ 2–3) and general draws (κ ≤ 4n = 512,
# κ·ε₃₂ ≈ 3e-5).  The kernel repeats the plain version's operations in
# order, so the measured difference is far below either bound.
K2_RTOL_SPD = 1e-5
K2_RTOL_GENERAL = 1e-4
# K2 before its Hopper redesign (whole-row swaps and four barriers a pivot
# column, column-serial substitutions), through its
# wrapper on the SPD draws, in ms (phase 5 of this script on an NVIDIA H100
# 80GB HBM3 at 700 W).
K2_BEFORE_MS = {"spd_100x128": 0.639, "spd_1600x128": 7.759}
# K3/K4 vs plain, max-norm relative: both fp32 with the same operations in
# the same order (K3's WᵀW in another summation order), κ ≈ 2–3 draws.
CHOL_RTOL = 1e-5
# K5 vs plain, absolute on mean and var (order 0.1–1): the same factor and
# substitution; the two dot products sum in another order.
K5_ATOL = 1e-5
# K6 vs plain: K1's arithmetic — 2e-4 relative on the K⁻¹-derived values,
# and the JAX test's 1e-4 absolute on mean and var.
K6_RTOL = 2e-4
K6_ATOL = 1e-4
# K6 on CUDA-core FMAs before its tensor-core redesign, in ms (phase 5 of
# this script on an NVIDIA H100 80GB HBM3 at 700 W): kept beside the new
# time so the kernel's row keeps its history.
K6_BEFORE_MS = {"gp_100x128": 0.565, "gp_1600x128": 6.750}
# K1 (each lane) and K8 (each precision) with every round on CUDA cores,
# before they moved onto the tensor-core round loop they now share with K6
# and K11, in ms (through their wrappers, bench/ns_probe.py, on an NVIDIA
# H100 80GB HBM3 at 700 W).
K1_BEFORE_MS = {
    "newton_schulz_spd10_pallas": {"spd_100x128": 0.403,
                                   "spd_1600x128": 4.893},
    "newton_schulz_spd_pallas": {"spd_100x128": 0.528,
                                 "spd_1600x128": 6.365},
    "newton_schulz_pallas": {"spd_100x128": 0.851, "spd_1600x128": 10.691},
    "newton_schulz_pan500_pallas": {"spd_100x128": 1.820,
                                    "spd_1600x128": 23.007}}
K8_BEFORE_MS = {"k8": {"spd_100x128": 0.195, "spd_1600x128": 2.298},
                "k8_split3": {"spd_100x128": 0.349, "spd_1600x128": 4.207}}
# K11 with its rounds emulating bf16 on CUDA cores, before it moved onto
# K6's tensor-core round loop, in ms (the same script and card).
K11_BEFORE_MS = {"gp_100x128": 0.221, "gp_1600x128": 2.794}
# K3, K4, K5 and K10 on the column-walk Cholesky factor and the
# column-owned L^-1, before both moved to panels (cholesky_common.cuh), in
# ms (the same script and card).
K3_BEFORE_MS = {"spd_100x128": 0.402, "spd_1600x128": 5.018}
K4_BEFORE_MS = {"spd_100x128": 0.174, "spd_1600x128": 0.968}
K5_BEFORE_MS = {"gp_100x128": 0.213, "gp_1600x128": 1.040}
K10_BEFORE_MS = {"k10": {"fit_100x128": 0.187, "fit_1600x128": 1.018},
                 "k10_emit_w": {"fit_100x128": 0.385, "fit_1600x128": 4.664}}
# GP main path: mean and var against the fp64 closed form (the JAX test's
# bound, tests/test_gauss_jordan_gp.py).
GP_ATOL = 1e-4
GP_METHODS = ("solve", "inverse", "lu", "newton_schulz", "pallas",
              "pallas_ns")
TIMED_CALLS = 20
# K7 repeats the plain version's operations in order (IEEE division, no FMA
# contraction): its raw inverse is compared with torch.equal (_k7_vs_plain).
# K7 before its Hopper redesign (one warp's pivot search, whole-row swaps
# and three block barriers a step on a shared-memory matrix), through its
# wrapper on the general class, in ms (phase 5 of this script on an NVIDIA
# H100 80GB HBM3 at 700 W).
K7_BEFORE_MS = {"square_100x128": 0.502, "square_1600x128": 2.801}
# K8 and K11 vs plain: K1's arithmetic from a warm start, K1's bound.
WARM_RTOL = 2e-4
# K10 vs plain: K5's factor and substitution and K3's W; the sums and
# logarithms differ in order only.
LML_RTOL = 1e-5
# The K10 fit against the torch.linalg fit: the CPU test's bounds
# (tests/test_torch_gp_fit.py), lml rtol / atol and θ atol.
FIT_RTOL, FIT_ATOL, FIT_THETA_ATOL = 1e-3, 1e-2, 5e-3
# Relative 2-norm drift between timesteps: SPD batches (the bf16 warm
# lane's domain is the reference's SPD class, κ ≈ 2–3), general batches
# (split3, κ ≤ 4n, δ·κ ≤ 0.05).
WARM_DELTA, SPLIT3_DELTA = 1e-3, 1e-4
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): fp32
# outside the tensor cores, dense bf16 tensor cores, HBM3.
PEAK_FP32, PEAK_BF16, PEAK_HBM = 67e12, 989e12, 3.35e12
# K9 repeats the plain version's operations in order (IEEE division, no FMA
# contraction): its factor, pivots, perm and triangle inverses are compared
# bitwise.  The two whole polished blocked LUs run the same cuBLAS products,
# max-norm relative: 1e-6 leaves room for cuBLAS picking another algorithm
# for one of the two routines' products.
K9_RTOL = 1e-6
# K9 before its Hopper redesign (three barriers a column, laswp one thread
# a column, barriered triangles), all panel launches of one call summed, in
# ms (phase 5 of this script on an NVIDIA H100 80GB HBM3 at 700 W).
K9_BEFORE_MS = {"nonsym500_100x512": 2.499, "square_1600x256": 6.324}
# The fp64-class lane (lu_hiacc): JAX's contracts (bench/chip_tests.py),
# max |I − AX| in fp64: κ = 500 at n = 128, and a batch with one singular
# member; κ = 2e4 adaptive; the κ ≈ 4n class at n = 512.
HIACC_TIGHT, HIACC_LOOSE = 1e-11, 1e-8


def _rel(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def _k2_vs_plain(a, label, rtol, err, torch, singular=None):
    """K2's raw outputs against its plain version on ``a``: ``inv`` and
    ``ipiv`` equal (``torch.equal``) on every finite member and the same
    members non-finite (only ``singular``, where given); then, unless
    ``rtol`` is None, both inverses after the fp32 polish within ``rtol``
    (max-norm relative)."""
    from cuda_matrix_inversion_tpu_torch.ops import cuda_lu

    batch, n = a.shape[0], a.shape[-1]
    x, piv = cuda_lu.lu_inverse_cuda(a)
    torch.cuda.synchronize()
    ref, ref_piv = cuda_lu.lu_inverse_plain(a)
    ok = torch.isfinite(ref).all(dim=(1, 2))
    what = f"K2 {label} {batch}x{n}"
    if not torch.equal(torch.isfinite(x).all(dim=(1, 2)), ok):
        raise AssertionError(f"{what}: non-finite members differ from the "
                             f"plain version")
    if singular is not None and (~ok).nonzero().flatten().tolist() != [
            singular]:
        raise AssertionError(f"{what}: the singular member alone must come "
                             f"out non-finite")
    if not (torch.equal(x[ok], ref[ok]) and torch.equal(piv[ok], ref_piv[ok])):
        raise AssertionError(f"{what}: inv or ipiv differ from the plain "
                             f"version's bits")
    err["raw_equal_members"] += int(ok.sum())
    if rtol is None or int(ok.sum()) == 0:
        return
    eye = torch.eye(n, device=a.device)
    x = x + x @ (eye - a @ x)
    ref = ref + ref @ (eye - a @ ref)
    rel = _rel(x[ok], ref[ok])
    err["abs"] = max(err["abs"], float((x[ok] - ref[ok]).abs().max()))
    key = "rel_spd" if label == "spd" else "rel_general"
    err[key] = max(err[key], rel)
    if not rel <= rtol:
        raise AssertionError(f"{what}: polished kernel vs plain {rel:.3e} > "
                             f"{rtol:g}")


def _k7_vs_plain(a, label, err, torch, singular=None):
    """K7's raw inverse against its plain version on ``a``: equal
    (``torch.equal``) on every finite member and the same members
    non-finite (only ``singular``, where given)."""
    from cuda_matrix_inversion_tpu_torch.ops import cuda_gauss_jordan

    x = cuda_gauss_jordan.gauss_jordan_cuda(a)
    torch.cuda.synchronize()
    ref = cuda_gauss_jordan.gauss_jordan_plain(a)
    what = f"K7 {label} {a.shape[0]}x{a.shape[-1]}"
    ok = torch.isfinite(ref).all(dim=(1, 2))
    if not torch.equal(torch.isfinite(x).all(dim=(1, 2)), ok):
        raise AssertionError(f"{what}: non-finite members differ from the "
                             f"plain version")
    if singular is not None and (~ok).nonzero().flatten().tolist() != [
            singular]:
        raise AssertionError(f"{what}: the singular member alone must come "
                             f"out non-finite")
    if not torch.equal(x[ok], ref[ok]):
        raise AssertionError(f"{what}: differs from the plain version's "
                             f"bits")
    entry = err.setdefault("k7", {"abs": 0.0, "rel": 0.0,
                                  "raw_equal_members": 0})
    entry["raw_equal_members"] += int(ok.sum())


def _median_ms(fn, torch, calls: int = TIMED_CALLS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gp_ref64(g):
    """fp64 closed-form (mean, var) of float32 GP inputs, each (batch,)."""
    a, b, c, d, e = (np.asarray(g[k], np.float64) for k in "abcde")
    n = b.shape[-1]
    kinv = np.linalg.inv(b + np.eye(n) * c[:, :, 0][:, None, :])
    at = np.transpose(a, (0, 2, 1))
    return (at @ kinv @ d)[:, 0, 0], (e - at @ kinv @ a)[:, 0, 0]


def _confined(out, bad: int | None, what: str, torch):
    """Mask of finite members; raises unless exactly member ``bad`` (when
    given) is non-finite."""
    finite = torch.isfinite(out.reshape(out.shape[0], -1)).all(dim=1)
    want = torch.ones_like(finite)
    if bad is not None:
        want[bad] = False
    if not torch.equal(finite, want):
        raise AssertionError(f"{what}: non-finite members "
                             f"{(~finite).nonzero().flatten().tolist()}, "
                             f"expected {[] if bad is None else [bad]}")
    return finite


def _drift(a, delta: float, seed: int, symmetric: bool, torch):
    """``a`` plus Gaussian noise of relative 2-norm ``delta`` per member
    (symmetrised for SPD input), drawn on ``a``'s device from ``seed``."""
    gen = torch.Generator(device=a.device).manual_seed(seed)
    noise = torch.randn(a.shape, generator=gen, device=a.device,
                        dtype=torch.float64)
    if symmetric:
        noise = (noise + noise.mT) / 2
    a64 = a.double()
    scale = (torch.linalg.matrix_norm(a64, ord=2)
             / torch.linalg.matrix_norm(noise, ord=2))
    return (a64 + delta * scale[:, None, None] * noise).float()


def _compare(key, kernel, plain, args, bad, rtol, err, torch, atols=()):
    """Kernel against plain on the same inputs: member ``bad`` alone
    non-finite in both, and every output within ``rtol`` (max-norm
    relative, over the finite members) of the plain version's, output i
    also within ``atols[i]`` absolute where given.  Records the worst abs
    and rel error under ``err[key]``."""
    got = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    entry = err.setdefault(key, {"abs": 0.0, "rel": 0.0})
    for i, (x, r) in enumerate(zip(got, ref)):
        what = f"{key.upper()} output {i} {tuple(x.shape)}"
        ok = _confined(x, bad, what, torch)
        _confined(r, bad, f"{what} plain", torch)
        diff = float((x[ok] - r[ok]).abs().max())
        rel = diff / float(r[ok].abs().max())
        entry["abs"] = max(entry["abs"], diff)
        entry["rel"] = max(entry["rel"], rel)
        if not rel <= rtol:
            raise AssertionError(f"{what}: kernel vs plain {rel:.3e} > "
                                 f"{rtol:g}")
        if i < len(atols) and not diff <= atols[i]:
            raise AssertionError(f"{what}: kernel vs plain {diff:.3e} abs > "
                                 f"{atols[i]:g}")


def _new_kernels_vs_plain(batch, n, rng, dev, err, torch, k7_only=False):
    """Phase 3 for K7, K8 (bf16 and split3), K10 (plain and emit_w) and
    K11 at one (batch, n): for batch > 1, member batch // 2 is singular
    (K7: all ones), negative definite (K10), or starts from a previous
    inverse holding a NaN (K8, K11), and alone must come out non-finite."""
    from cuda_matrix_inversion_tpu_torch.io.fixtures import (
        make_gp_batch,
        make_spd_batch,
        make_square_batch,
    )
    from cuda_matrix_inversion_tpu_torch.ops import cuda_gp_lml

    bad = batch // 2 if batch > 1 else None
    seed = 1000 * n + batch
    gen = torch.tensor(make_square_batch(batch, n, rng), dtype=torch.float32,
                       device=dev)
    sing = gen.clone()
    if bad is not None:
        sing[bad] = 1.0 if n > 1 else 0.0
    _k7_vs_plain(sing, "singular" if bad is not None else "general", err,
                 torch, singular=bad)
    if k7_only:
        return
    spd = torch.tensor(make_spd_batch(batch, n, rng), dtype=torch.float32,
                       device=dev)
    _k8_vs_plain(spd, gen, bad, seed, err, torch)
    g = make_gp_batch(batch, n, rng)
    t = {k: torch.tensor(g[k], dtype=torch.float32, device=dev)
         for k in "abcde"}
    b_bad = t["b"].clone()
    if bad is not None:
        b_bad[bad] = -b_bad[bad]
    c, d = t["c"][..., 0].contiguous(), t["d"][..., 0].contiguous()
    for key, emit_w in (("k10", False), ("k10_emit_w", True)):
        _compare(key, cuda_gp_lml.lml_quad_logdet_cuda,
                 cuda_gp_lml.lml_quad_logdet_plain, (b_bad, c, d, emit_w),
                 bad, LML_RTOL, err, torch)
    _k11_vs_plain(t, bad, seed, err, torch)


def _k1_vs_plain(a, sched, what, err, torch):
    """K1 against its plain version on ``a``: the same members non-finite
    in both (a schedule can diverge on a member outside its domain: the pan
    lane on a 1×1 member whose bf16-rounded A·X₀ exceeds 2/c), and the
    others max-norm relative within K1_RTOL; records the worst abs and rel
    error and the count of non-finite members in ``err``."""
    from cuda_matrix_inversion_tpu_torch.ops import newton_schulz

    x = newton_schulz.ns_iterate_cuda(a, sched)
    torch.cuda.synchronize()
    ref = newton_schulz.ns_iterate_plain(a, sched, bf16_products=True)
    ok = torch.isfinite(ref).flatten(1).all(dim=1)
    if not torch.equal(torch.isfinite(x).flatten(1).all(dim=1), ok):
        raise AssertionError(f"K1 {what}: non-finite members differ from "
                             f"the plain version's")
    err["nonfinite_members"] = err.get("nonfinite_members", 0) + int(
        (~ok).sum())
    if not bool(ok.any()):
        return
    x, ref = x[ok], ref[ok]
    rel = _rel(x, ref)
    err["abs"] = max(err["abs"], float((x - ref).abs().max()))
    err["rel"] = max(err["rel"], rel)
    if not rel <= K1_RTOL:
        raise AssertionError(f"K1 {what}: kernel vs plain {rel:.3e} > "
                             f"{K1_RTOL:g}")


def _k8_vs_plain(spd, gen, bad, seed, err, torch, lo=2, hi=1):
    """K8 at ``lo`` + ``hi`` rounds against its plain version: bf16 on the
    SPD batch drifted by WARM_DELTA, split3 on the general batch drifted by
    SPLIT3_DELTA, each from its exact inverse; member ``bad`` (if any)
    starts from an X0 holding a NaN and alone must come out non-finite."""
    from cuda_matrix_inversion_tpu_torch.ops import newton_schulz

    for key, a0, delta, split3 in (("k8", spd, WARM_DELTA, False),
                                   ("k8_split3", gen, SPLIT3_DELTA, True)):
        x0 = torch.linalg.inv(a0.double()).float()
        if bad is not None:
            x0[bad, 0, 0] = float("nan")
        a = _drift(a0, delta, seed, not split3, torch)
        _compare(key, newton_schulz.ns_refine_cuda,
                 newton_schulz.ns_refine_plain, (a, x0, lo, hi, split3), bad,
                 WARM_RTOL, err, torch)


def _k11_vs_plain(g, bad, seed, err, torch, lo=2, hi=1):
    """K11 against its plain version at `lo` + `hi` rounds on the GP batch
    ``g`` (float32 tensors a … e on the card, B drifted by WARM_DELTA from
    the one X0 inverts): WARM_RTOL on every output, K6_ATOL on mean and
    var; member ``bad``'s X0 holds a NaN and alone must come out
    non-finite."""
    from cuda_matrix_inversion_tpu_torch.ops import cuda_gp, linalg

    x0 = torch.linalg.inv(linalg.add_diagonal(g["b"], g["c"]).double()
                          ).float()
    if bad is not None:
        x0[bad, 0, 0] = float("nan")
    flat = cuda_gp._flat(g["a"], _drift(g["b"], WARM_DELTA, seed, True,
                                        torch), g["c"], g["d"], g["e"])
    _compare("k11", cuda_gp.gp_fused_warm_cuda, cuda_gp.gp_fused_warm_plain,
             (*flat, x0, lo, hi), bad, WARM_RTOL, err, torch,
             atols=(K6_ATOL,))


def _fit_data(batch, n, seed):
    """A fit batch as the CPU fit test draws it (tests/test_torch_gp_fit.py
    ``_synth``): B = W Wᵀ + 0.05 I with rank 6, c ∈ [0.5, 1.5), d drawn from
    K* = 1.8²·B + diag(0.5²·c)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((batch, n, 6))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.05 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    k = 1.8 ** 2 * b.astype(np.float64) + 0.5 ** 2 * np.eye(n) * c[:, :, 0][
        :, None, :]
    d = (np.linalg.cholesky(k) @ rng.standard_normal((batch, n, 1))
         ).astype(np.float32)
    return b, c, d


def _engine_path(dev, cases, gp_host, gp_ref, torch):
    """Phase 4's second path: the serving engines and the fit, NumPy in
    and out, as a user calls them.  Returns one result line per check."""
    from cuda_matrix_inversion_tpu_torch import GPEngine, InversionEngine
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )

    lines = []

    def gate(what, a, x):
        err = identity_error_inf(a, x)
        lines.append({"phase": "engine_path", "check": what, "gate": err})
        if not (x.shape == a.shape and x.dtype == np.float32
                and np.isfinite(x).all() and err < GATE):
            raise AssertionError(f"{what}: gate {err:.3e} ({x.shape} "
                                 f"{x.dtype})")

    def closed_form(what, got, ref):
        errs = [float(np.abs(x[:, 0, 0] - r).max()) for x, r in zip(got, ref)]
        lines.append({"phase": "engine_path", "check": what,
                      "mean_abs_err": errs[0], "var_abs_err": errs[1]})
        if not max(errs) < GP_ATOL:
            raise AssertionError(f"{what}: off the fp64 closed form {errs}")

    eng = InversionEngine(algorithm="gauss_pallas", device=dev)
    gate("gauss_pallas square_100x128", cases["square_100x128"],
         eng.inverse(cases["square_100x128"]))
    for algorithm in ("lu_pallas", "newton_schulz_spd10_pallas"):
        eng = InversionEngine(algorithm=algorithm, device=dev)
        for case in ("spd_100x128", "spd_1600x128"):
            gate(f"{algorithm} {case}", cases[case],
                 eng.inverse(cases[case]))
    # warm serving: the spd10 engine's bf16 refinement (K8) of its own cold
    # inverse after a drift, and a pan500 engine's split3 refinement
    eng = InversionEngine(algorithm="newton_schulz_spd10_pallas", device=dev)
    a = cases["spd_100x128"]
    prev = eng.inverse(a)
    a2 = _drift(torch.tensor(a), WARM_DELTA, 1, True, torch).numpy()
    gate("spd10 inverse_warm bf16", a2, eng.inverse_warm(a2, prev))
    gate("spd10 inverse_warm bf16 check", a2,
         eng.inverse_warm(a2, prev, check=True))
    eng = InversionEngine(algorithm="newton_schulz_pan500_pallas",
                          device=dev)
    sq = cases["square_100x128"]
    prev = eng.inverse(sq)
    sq2 = _drift(torch.tensor(sq), SPLIT3_DELTA, 2, False, torch).numpy()
    gate("pan500 inverse_warm split3 check", sq2,
         eng.inverse_warm(sq2, prev, check=True))

    g = gp_host["gp_100x128"]
    args = [g[k] for k in "abcde"]
    closed_form("GPEngine pallas mean_variance gp_100x128",
                GPEngine(method="pallas", device=dev).mean_variance(*args),
                gp_ref["gp_100x128"])
    # three drifting timesteps, the chain started from a cold K⁻¹
    geng = GPEngine(device=dev)
    n = g["b"].shape[-1]
    kinv = np.linalg.inv(g["b"].astype(np.float64)
                         + np.eye(n) * g["c"][:, :, 0][:, None, :]
                         ).astype(np.float32)
    b = g["b"]
    for step in range(3):
        b = _drift(torch.tensor(b), WARM_DELTA, 10 + step, True,
                   torch).numpy()
        mean, var, kinv = geng.mean_variance_warm(g["a"], b, g["c"], g["d"],
                                                  g["e"], kinv)
        closed_form(f"GPEngine mean_variance_warm step {step}", (mean, var),
                    _gp_ref64(dict(g, b=b)))
        k = b.astype(np.float64) + np.eye(n) * g["c"][:, :, 0][:, None, :]
        gate(f"GPEngine mean_variance_warm step {step} kinv",
             k.astype(np.float32), kinv)

    fit = GPEngine(device=dev).fit(*_fit_data(1600, 128, 3), steps=150)
    path = fit.lml_path
    lines.append({"phase": "engine_path", "check": "GPEngine.fit 1600x128 "
                  "150 steps", "lml_path_first": float(path[0]),
                  "lml_path_last": float(path[-1])})
    if not (np.isfinite(path).all() and np.isfinite(fit.lml).all()
            and path[-1] > path[0] + 1.0):
        raise AssertionError(f"GPEngine.fit: lml_path {path[0]} -> "
                             f"{path[-1]}")
    data = _fit_data(100, 128, 4)
    res = {m: GPEngine(fit_method=m, device=dev).fit(*data, steps=60)
           for m in ("pallas", "xla")}
    k10, ref = res["pallas"], res["xla"]
    diffs = {"lml": float(np.abs(k10.lml - ref.lml).max()),
             "theta": float(max(np.abs(k10.log_amp - ref.log_amp).max(),
                                np.abs(k10.log_noise - ref.log_noise).max()))}
    lines.append({"phase": "engine_path", "check": "fit pallas vs xla "
                  "100x128 60 steps", **diffs})
    if not (np.allclose(k10.lml, ref.lml, rtol=FIT_RTOL, atol=FIT_ATOL)
            and diffs["theta"] <= FIT_THETA_ATOL):
        raise AssertionError(f"fit pallas vs xla: {diffs}")
    return lines


def _ns_products(lo: int, hi: int, split3: bool, polish_highest: bool = True):
    """(fp32, bf16) matrix products of a Newton-Schulz schedule, as the
    kernels run it: a one-pass product is 1 bf16 product, the 3-pass split
    3, an fp32 residual 1 fp32 product."""
    one = 3 if split3 else 1
    fp32, bf16 = 0, 2 * lo * one
    for i in range(hi):
        final = (i == hi - 1) and polish_highest
        if split3 or final:
            fp32 += 1
        else:
            bf16 += 3
        bf16 += one
    return fp32, bf16


def _bound(fp32_flops: float, bf16_flops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of the operations at the peak rate of their type and the
    bytes at the HBM rate."""
    ops = fp32_flops / PEAK_FP32 + bf16_flops / PEAK_BF16
    mem = nbytes / PEAK_HBM
    return (1e3 * max(ops, mem), "operations" if ops >= mem else "bytes")


def _kernel_bounds(batch: int, n: int, sched_spd10, sched_spd):
    """The bound of each kernel at (batch, n) fp32, counting each input
    read once and each output written once."""
    mat, vec = 4.0 * n * n, 4.0 * n
    cube = 2.0 * n ** 3  # one n×n product

    def ns(sched):
        return _ns_products(sched.lo_iters, sched.hi_iters, sched.split3,
                            sched.polish_highest)

    f1, b1 = ns(sched_spd10)
    f6, b6 = ns(sched_spd)
    f8, b8 = _ns_products(2, 1, False)
    per = {
        "k1": (f1 * cube, b1 * cube, 2 * mat),
        "k2": (cube, 0.0, 2 * mat + vec),
        "k3": (n ** 3, 0.0, 2 * mat),
        "k4": (n ** 3 / 3, 0.0, 2 * mat),
        "k5": (n ** 3 / 3 + 4 * n * n, 0.0, mat + 3 * vec + 12),
        "k6": (f6 * cube + 4 * n * n, b6 * cube, mat + 3 * vec + 12),
        "k7": (cube, 0.0, 2 * mat),
        "k8": (f8 * cube, b8 * cube, 3 * mat),
        "k10": (2 * n ** 3 / 3 + 4 * n * n, 0.0, 2 * mat + 3 * vec + 8),
        "k11": (f8 * cube + 4 * n * n, b8 * cube, 3 * mat + 3 * vec + 12),
    }
    return {k: _bound(batch * f, batch * b, batch * m)
            for k, (f, b, m) in per.items()}


def _time_new_kernels(dev, dev_cases, gp_dev, timing, library, card, torch):
    """Phase 5 for K7, K8, K10 and K11 at 100×128 and 1600×128: each
    kernel beside its plain version and the library call, the warm lanes
    beside the cold ones, one fit step of each method, and one engine
    request NumPy in and out.  Fills ``timing`` and ``library`` under
    (key, case) with case the SPD inversion case of the same batch."""
    from cuda_matrix_inversion_tpu_torch import GPEngine, InversionEngine
    from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
    from cuda_matrix_inversion_tpu_torch.models import gp, gp_fit
    from cuda_matrix_inversion_tpu_torch.ops import (
        cuda_gauss_jordan,
        cuda_gp,
        cuda_gp_lml,
        linalg,
        newton_schulz,
    )

    def show(what, case, **ms):
        print(json.dumps({"timing": what, "case": case, **ms, **card}),
              flush=True)

    squares = {"spd_100x128": dev_cases["square_100x128"],
               "spd_1600x128": torch.tensor(make_square_batch(
                   1600, 128, np.random.default_rng(2028)),
                   dtype=torch.float32, device=dev)}
    for batch, case, gp_case in ((100, "spd_100x128", "gp_100x128"),
                                 (1600, "spd_1600x128", "gp_1600x128")):
        sq = squares[case]
        inv_ms = _median_ms(lambda: torch.linalg.inv(sq), torch)
        ms = _median_ms(lambda: cuda_gauss_jordan.gauss_jordan_cuda(sq),
                        torch)
        plain_ms = _median_ms(
            lambda: cuda_gauss_jordan.gauss_jordan_plain(sq), torch)
        lane_ms = _median_ms(
            lambda: cuda_gauss_jordan.inverse_gauss_jordan(sq), torch)
        sq_case = case.replace("spd", "square")
        timing[("k7", sq_case)] = (ms, plain_ms)
        library[("k7", sq_case)] = inv_ms
        show("K7", sq_case, kernel_ms=ms, k7_before_ms=K7_BEFORE_MS[sq_case],
             plain_ms=plain_ms, lane_gauss_pallas_ms=lane_ms,
             torch_linalg_inv_ms=inv_ms)

        a0 = dev_cases[case]
        for key, base, delta, split3, cold_kw in (
                ("k8", a0, WARM_DELTA, False, {"init": "spd"}),
                ("k8_split3", sq, SPLIT3_DELTA, True,
                 {"precision": "split3"})):
            # contiguous: torch.linalg.inv returns column-major batches,
            # which the wrapper would copy on every timed call
            x0 = torch.linalg.inv(base.double()).float().contiguous()
            a = _drift(base, delta, batch, not split3, torch)
            precision = "split3" if split3 else "bf16"
            ms = _median_ms(lambda: newton_schulz.ns_refine_cuda(
                a, x0, 2, 1, split3), torch)
            plain_ms = _median_ms(lambda: newton_schulz.ns_refine_plain(
                a, x0, 2, 1, split3), torch)
            warm_ms = _median_ms(
                lambda: newton_schulz.inverse_newton_schulz_warm(
                    a, x0, precision=precision), torch)
            cold_ms = _median_ms(
                lambda: newton_schulz.inverse_newton_schulz_fixed(
                    a, **cold_kw), torch)
            inv_ms = _median_ms(lambda: torch.linalg.inv(a), torch)
            timing[(key, case)], library[(key, case)] = (ms, plain_ms), inv_ms
            show(key.upper(), case if not split3 else
                 case.replace("spd", "square"), kernel_ms=ms,
                 plain_ms=plain_ms, k8_before_ms=K8_BEFORE_MS[key][case],
                 warm_lane_ms=warm_ms, cold_lane_ms=cold_ms, cold_lane=cold_kw,
                 torch_linalg_inv_ms=inv_ms)

        b, c, d = (torch.tensor(x, device=dev)
                   for x in _fit_data(batch, 128, 5))
        c2, d2 = c[..., 0].contiguous(), d[..., 0].contiguous()
        for key, emit_w in (("k10", False), ("k10_emit_w", True)):
            ms = _median_ms(lambda: cuda_gp_lml.lml_quad_logdet_cuda(
                b, c2, d2, emit_w), torch)
            plain_ms = _median_ms(lambda: cuda_gp_lml.lml_quad_logdet_plain(
                b, c2, d2, emit_w), torch)
            timing[(key, case)], library[(key, case)] = (ms, plain_ms), None
            show(key.upper(), f"fit_{batch}x128", kernel_ms=ms,
                 plain_ms=plain_ms,
                 before_ms=K10_BEFORE_MS[key][f"fit_{batch}x128"])
        step_ms = {}
        for method in ("pallas", "xla"):
            theta = torch.zeros((batch, 2), device=dev, requires_grad=True)
            opt = torch.optim.Adam([theta], lr=0.05)

            def step():
                opt.zero_grad(set_to_none=True)
                loss = -gp_fit._batch_lml(theta, b, c, d,
                                          method=method).mean()
                loss.backward()
                opt.step()

            step_ms[method] = _median_ms(step, torch)
        lml_xla_ms = _median_ms(lambda: gp.gp_log_marginal_likelihood(
            b, c, d), torch)
        show("fit_step", f"fit_{batch}x128", pallas_ms=step_ms["pallas"],
             xla_ms=step_ms["xla"], lml_forward_xla_ms=lml_xla_ms)

        ga, gb, gc, gd, ge = gp_dev[gp_case]
        x0 = torch.linalg.inv(linalg.add_diagonal(gb, gc).double()
                              ).float().contiguous()
        flat = cuda_gp._flat(ga, _drift(gb, WARM_DELTA, batch, True, torch),
                             gc, gd, ge)
        ms = _median_ms(lambda: cuda_gp.gp_fused_warm_cuda(*flat, x0), torch)
        plain_ms = _median_ms(lambda: cuda_gp.gp_fused_warm_plain(*flat, x0),
                              torch)
        k6_ms = _median_ms(lambda: cuda_gp.gp_fused_ns_cuda(*flat), torch)
        solve_ms = _median_ms(lambda: gp.gp_mean_variance(
            ga, gb, gc, gd, ge, method="solve"), torch)
        timing[("k11", gp_case)] = (ms, plain_ms)
        library[("k11", gp_case)] = solve_ms
        show("K11", gp_case, kernel_ms=ms, plain_ms=plain_ms,
             k11_before_ms=K11_BEFORE_MS[gp_case], k6_cold_kernel_ms=k6_ms,
             solve_method_ms=solve_ms)

    # one engine request, NumPy in and out, host clock (ends in the copy
    # back, which waits for the device)
    a = dev_cases["spd_100x128"].cpu().numpy()
    eng = InversionEngine(algorithm="newton_schulz_spd10_pallas", device=dev)
    eng.warmup([a.shape[:2]])
    g = [x.cpu().numpy() for x in gp_dev["gp_100x128"]]
    geng = GPEngine(method="pallas", device=dev)
    geng.warmup([(100, 128)])
    for what, fn in (("InversionEngine spd10 inverse",
                      lambda: eng.inverse(a)),
                     ("GPEngine pallas mean_variance",
                      lambda: geng.mean_variance(*g))):
        times = []
        for _ in range(TIMED_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        show("engine_request", "100x128 numpy in/out", request=what,
             ms=statistics.median(times))


def _k9_vs_plain(dev, err, torch):
    """Phase 3 for K9 at n ∈ {160, 256, 512} × batch ∈ {1, 7, 100} and
    1600×256, each at its default panel width (n = 160 pads to 192 at
    pw = 64: a ragged last panel) and 512 also at pw = 32, 7×160 at pw = 8
    and 24 (the kernel's generic instance), and on draws of small integers
    in [-2, 2] (exact ties decide the pivots) at 100×256 and 7×512: the
    blocked factor with K9 against the same routine with the
    plain version (factor, perm, pivots and triangle inverses bitwise),
    then the whole polished output of both.  For batch > 1 member
    batch // 2 has a zero column and alone must come out non-finite."""
    from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
    from cuda_matrix_inversion_tpu_torch.ops import lu_bign

    cases = [(b, n, None, False) for n in (160, 256, 512) for b in (1, 7, 100)]
    cases += [(100, 512, 32, False), (1600, 256, None, False),
              (100, 256, None, True), (7, 512, None, True),
              (7, 160, 8, False), (7, 160, 24, False)]
    entry = err.setdefault("k9", {"abs": 0.0, "rel": 0.0})
    for batch, n, pw, ties in cases:
        pw = pw or lu_bign.pick_pw(n)
        bad = batch // 2 if batch > 1 else None
        rng = np.random.default_rng(9000 + n + batch)
        a_np = (rng.integers(-2, 3, (batch, n, n)) if ties
                else make_square_batch(batch, n, rng))
        a = torch.tensor(a_np, dtype=torch.float32, device=dev)
        if bad is not None:
            a[bad, :, n // 3] = 0.0
        n_pad = -(-n // pw) * pw
        work = torch.eye(n_pad, device=dev).repeat(batch, 1, 1)
        work[:, :n, :n] = a
        what = f"K9 {batch}x{n} pw={pw}{' ties' if ties else ''}"
        got = lu_bign.lu_factor_big(work, pw, panel=lu_bign.lu_panel_cuda)
        torch.cuda.synchronize()
        ref = lu_bign.lu_factor_big(work, pw, panel=lu_bign.lu_panel_plain)
        ok = _confined(got[0], bad, what, torch)
        _confined(ref[0], bad, f"{what} plain", torch)
        # the factor, perm, every panel's pivots and triangle inverses:
        # bitwise on the finite members
        parts = [(got[0], ref[0], "factor"), (got[1], ref[1], "perm")]
        parts += [(x, r, "pivots") for x, r in zip(got[2], ref[2])]
        parts += [(x, r, "L11^-1 / U11^-1")
                  for x, r in zip(got[3] + got[4], ref[3] + ref[4])]
        for x, r, name in parts:
            if x.is_floating_point():
                diff = float((x[ok] - r[ok]).abs().max())
                entry["abs"] = max(entry["abs"], diff)
                entry["rel"] = max(entry["rel"],
                                   diff / float(r[ok].abs().max()))
            if not torch.equal(x[ok], r[ok]):
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"plain version")
        # the polished inverse: member bad alone non-finite
        whole = (lu_bign.inverse_lu_big(a, pw=pw),
                 lu_bign.inverse_lu_big_plain(a, pw=pw))
        _confined(whole[0], bad, what, torch)
        _confined(whole[1], bad, f"{what} plain", torch)
        diff = float((whole[0][ok] - whole[1][ok]).abs().max())
        rel = diff / float(whole[1][ok].abs().max())
        entry["abs"] = max(entry["abs"], diff)
        entry["rel"] = max(entry["rel"], rel)
        if not rel <= K9_RTOL:
            raise AssertionError(f"{what}: polished inverse, kernel vs plain "
                                 f"{rel:.3e} > {K9_RTOL:g}")


def _max_resid64(a, x, torch) -> float:
    """max |I − AX| over the batch in fp64 (JAX's ``residual_inf_ds``)."""
    a64, x64 = a.double(), x.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    return float((eye - a64 @ x64).abs().max())


def _big_n_cases():
    """The big-n path's inputs, NumPy float32 (fp64 where the lane's
    contract is fp64), each as JAX's chip test draws it."""
    from cuda_matrix_inversion_tpu_torch.io.fixtures import (
        make_nonsym_cond,
        make_spd_batch,
        make_square_batch,
    )

    cases = {
        # JAX's lu_bign_512_gate draw (κ = 500: the κ ≈ 4n class sits on
        # the fp32 floor at n = 512, ROADMAP W3)
        "nonsym500_100x512": make_nonsym_cond(
            100, 512, 500.0, np.random.default_rng(63)),
        "square_1600x256": make_square_batch(
            1600, 256, np.random.default_rng(2029)).astype(np.float32),
        # JAX's ns_pan500_xla_n256_kappa500
        "nonsym500_4x256": make_nonsym_cond(
            4, 256, 500.0, np.random.default_rng(41)),
        # the warm split3 route past 128 (its polish residual in fp64)
        "nonsym500_100x256": make_nonsym_cond(
            100, 256, 500.0, np.random.default_rng(42)),
        "spd_100x256": make_spd_batch(
            100, 256, np.random.default_rng(2030)).astype(np.float32),
        "request_100x200": make_nonsym_cond(
            100, 200, 500.0, np.random.default_rng(2031)),
        # lu_hiacc's contracts (chip_tests.py lu_hiacc_*, hiacc_rescues_*)
        "hiacc_kappa500_2x128": make_nonsym_cond(
            2, 128, 500.0, np.random.default_rng(61)).astype(np.float64),
        "hiacc_kappa2e4_2x32": make_nonsym_cond(
            2, 32, 2e4, np.random.default_rng(62)).astype(np.float64),
        "hiacc_square_8x512": make_square_batch(
            8, 512, np.random.default_rng(65)).astype(np.float32).astype(
                np.float64),
    }
    singular = make_nonsym_cond(3, 128, 500.0, np.random.default_rng(64)
                                ).astype(np.float64)
    singular[1, :, 7] = 0.0
    cases["hiacc_singular_3x128"] = singular
    rng = np.random.default_rng(2032)
    cases["ragged_general"] = [make_nonsym_cond(1, n, 500.0, rng)[0]
                               for n in (5, 20, 100, 300, 512)]
    cases["ragged_spd"] = [make_spd_batch(1, n, rng)[0].astype(np.float32)
                           for n in (5, 20, 100, 300, 512)]
    return cases


def _big_n_path(dev, cases, torch):
    """Phase 4's third path, through the entry points a user calls: the
    lanes past n = 128, an ``lu_pallas`` engine in its 256 and 512 buckets,
    ``bucketed_inverse`` on a ragged list, and the fp64-class lane.  Every
    fp32 result through the gate, every fp64 one through its contract.
    Returns one result line per check."""
    from cuda_matrix_inversion_tpu_torch import InversionEngine
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )
    from cuda_matrix_inversion_tpu_torch.ops import (
        double_single,
        host_api,
        newton_schulz,
    )
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )
    from cuda_matrix_inversion_tpu_torch.parallel import bucketing

    lines = []

    def gate(what, a, x):
        err = identity_error_inf(a, x)
        lines.append({"phase": "big_n_path", "check": what, "gate": err})
        if not (x.shape == a.shape and x.dtype == np.float32
                and np.isfinite(x).all() and err < GATE):
            raise AssertionError(f"{what}: gate {err:.3e} ({x.shape} "
                                 f"{x.dtype})")

    def contract(what, err, bound):
        lines.append({"phase": "big_n_path", "check": what,
                      "max_abs_resid_fp64": err, "bound": bound})
        if not err <= bound:
            raise AssertionError(f"{what}: {err:.3e} > {bound:g}")

    runs = [("lu_pallas", "nonsym500_100x512"),
            ("lu_bign_pallas", "nonsym500_100x512"),
            ("lu_pallas", "square_1600x256"),
            ("newton_schulz_pan500_pallas", "nonsym500_4x256"),
            ("newton_schulz_spd10_pallas", "spd_100x256"),
            ("newton_schulz_spd_pallas", "spd_100x256")]
    outs = [(lane, case, host_api.inverse_batched_device(
        torch.tensor(cases[case], device=dev), lane)) for lane, case in runs]
    for lane, case, x in outs:
        gate(f"{lane} {case}", cases[case], x.cpu().numpy())

    a, x0 = _warm_split3_case(dev, cases, torch)
    x = newton_schulz.inverse_newton_schulz_warm(a, x0, precision="split3")
    gate("inverse_newton_schulz_warm split3 nonsym500_100x256 drifted 1e-4",
         a.cpu().numpy(), x.cpu().numpy())

    eng = InversionEngine(algorithm="lu_pallas", device=dev)
    for case, a in (("request_100x200", cases["request_100x200"]),
                    ("request_100x512", cases["nonsym500_100x512"])):
        gate(f"InversionEngine lu_pallas {case}", a, eng.inverse(a))
    if [dim for _, dim in eng.compiled_shapes] != [256, 512]:
        raise AssertionError(f"engine buckets {eng.compiled_shapes}")

    for algorithm, ms in (("lu_pallas", cases["ragged_general"]),
                          ("cholesky_pallas", cases["ragged_spd"])):
        got = bucketing.bucketed_inverse(ms, algorithm=algorithm, device=dev)
        for m, x in zip(ms, got):
            gate(f"bucketed_inverse {algorithm} n={m.shape[0]}", m[None],
                 x[None])

    hiacc = get_inverse_algorithm("lu_hiacc")
    for case, fn, bound in (
            ("hiacc_kappa500_2x128", hiacc, HIACC_TIGHT),
            ("hiacc_kappa2e4_2x32", double_single.inverse_hiacc,
             HIACC_LOOSE),
            ("hiacc_square_8x512", hiacc, HIACC_LOOSE)):
        a = torch.tensor(cases[case], device=dev)
        x = fn(a)
        if x.dtype != torch.float64:
            raise AssertionError(f"lu_hiacc {case}: dtype {x.dtype}")
        contract(f"lu_hiacc {case}", _max_resid64(a, x, torch), bound)
    a = torch.tensor(cases["hiacc_singular_3x128"], device=dev)
    x = double_single.inverse_hiacc(a)
    _confined(x, 1, "lu_hiacc adaptive singular member", torch)
    keep = torch.tensor([0, 2], device=dev)
    contract("lu_hiacc adaptive, singular member 1, members 0 and 2",
             _max_resid64(a[keep], x[keep], torch), HIACC_TIGHT)
    return lines


def _warm_split3_case(dev, cases, torch):
    """(a, x0) on the device: the κ = 500 batch at 100×256 drifted by a
    relative 2-norm of 1e-4, and the exact inverse of the batch before the
    drift."""
    a0 = torch.tensor(cases["nonsym500_100x256"], device=dev)
    x0 = torch.linalg.inv(a0.double()).float()
    return _drift(a0, SPLIT3_DELTA, 256, False, torch), x0


def _fp32_residual_floor(dev, cases, torch):
    """What the fp32-residual polish of the JAX package would give on the
    card (informational): the blocked LU, the split3 batched lane and the
    warm split3 route with their polish residual in fp32 instead of
    fp64."""
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )
    from cuda_matrix_inversion_tpu_torch.ops import lu_bign, newton_schulz
    from cuda_matrix_inversion_tpu_torch.ops.registry import LANES

    a_np = cases["nonsym500_100x512"]
    a = torch.tensor(a_np, device=dev)
    x = lu_bign.inverse_lu_big(a, polish=False)
    eye = torch.eye(a.shape[-1], device=dev)
    fp32 = x + x @ (eye - a @ x)
    b_np = cases["nonsym500_4x256"]
    b = torch.tensor(b_np, device=dev)
    ns = newton_schulz.ns_iterate_plain(
        b, LANES["newton_schulz_pan500_pallas"]["schedule"])
    w, w0 = _warm_split3_case(dev, cases, torch)
    w_eye = torch.eye(w.shape[-1], device=dev)
    xw = w0
    for _ in range(2):  # the route's lo rounds
        xw = newton_schulz._mm_split3(
            xw, 2.0 * w_eye - newton_schulz._mm_split3(w, xw))
    for _ in range(2):  # its polish rounds, the residual in fp32
        xw = xw + newton_schulz._mm_split3(xw, w_eye - w @ xw)
    return {"phase": "big_n_path", "check": "fp32-residual polish "
            "(informational)", "lu_bign_nonsym500_100x512_unpolished":
            identity_error_inf(a_np, x.cpu().numpy()),
            "lu_bign_nonsym500_100x512_fp32_polish":
            identity_error_inf(a_np, fp32.cpu().numpy()),
            "pan500_nonsym500_4x256_fp32_residual":
            identity_error_inf(b_np, ns.cpu().numpy()),
            "warm_split3_nonsym500_100x256_fp32_residual":
            identity_error_inf(w.cpu().numpy(), xw.cpu().numpy())}


def _k9_work(batch: int, n: int, pw: int, ipivs):
    """(fp32 flops, bytes) of K9's launches in one blocked factor: per
    panel over m = n − k0 rows, getf2 (the multipliers and the rank-1
    updates, ~Σ_j 2(m−j−1)(pw−j−1) + (m−j−1)) and the two pw×pw triangle
    inverses (pw³/3 each); bytes the panel read and written, the two
    triangles and the pivots written, and outside the panel each row that
    this run's pivots displace, read once and written once (n − pw words):
    the panel's swaps replayed on an index map give the composed
    permutation σ, and the rows are those with σ(r) ≠ r."""
    flops = nbytes = 0.0
    members = np.arange(batch)
    for p, ipiv in enumerate(ipivs):
        k0 = p * pw
        m = n - k0
        flops += batch * sum(2.0 * (m - j - 1) * (pw - j - 1) + (m - j - 1)
                             for j in range(pw))
        flops += batch * 2 * pw ** 3 / 3
        nbytes += batch * (8.0 * m * pw + 8.0 * pw * pw + 4.0 * pw)
        piv = ipiv.cpu().numpy().astype(np.int64) - k0
        sigma = np.tile(np.arange(m), (batch, 1))
        for j in range(pw):
            src, dst = sigma[members, piv[:, j]], sigma[members, j]
            sigma[members, j], sigma[members, piv[:, j]] = src, dst
        moved = int((sigma != np.arange(m)).sum())
        nbytes += moved * 8.0 * (n - pw)
    return flops, nbytes


def _time_k9_call(a, pw, panel, torch):
    """Device time of the K9 launches (or their plain version's work) in
    one blocked factor of ``a``, summed: CUDA events around each panel call
    (the trailing products queued before it keep the device busy, so the
    host's time to issue the call is not in the window)."""
    from cuda_matrix_inversion_tpu_torch.ops import lu_bign

    spans = []

    def timed(work, perm, k0, pw_):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = panel(work, perm, k0, pw_)
        end.record()
        spans.append((start, end))
        return out

    lu_bign.lu_factor_big(a, pw, panel=timed)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans)


def _median_k9(a, pw, panel, calls, torch) -> float:
    """Median over ``calls`` blocked factors (after one warm-up) of
    :func:`_time_k9_call`."""
    _time_k9_call(a, pw, panel, torch)
    return statistics.median(_time_k9_call(a, pw, panel, torch)
                             for _ in range(calls))


def _time_big_n(dev, cases, timing, library, card, torch):
    """Phase 5 for the big-n path at 100×512 and 1600×256: K9 alone (all
    panel launches of one call, summed) beside its plain version and its
    time before the Hopper redesign (:data:`K9_BEFORE_MS`), the port's
    blocked factor ``lu_factor_big`` (K9 and the getrf products) beside
    ``torch.linalg.lu_factor_ex`` (a yardstick: the port never calls it),
    the ``lu_bign_pallas`` lane beside its bound (LAPACK's 2n³ for getrf +
    getri and 4n³ for the polish at the fp32 peak), ``torch.linalg.inv``,
    the plain routine, ``lu_hiacc`` against ``lu_pallas``, and the panel
    width ladder."""
    from cuda_matrix_inversion_tpu_torch.ops import host_api, lu_bign

    def show(what, case, **ms):
        print(json.dumps({"timing": what, "case": case, **ms, **card}),
              flush=True)

    for case in ("nonsym500_100x512", "square_1600x256"):
        a = torch.tensor(cases[case], device=dev)
        batch, n = a.shape[0], a.shape[-1]
        pw = lu_bign.pick_pw(n)
        k9_ms = _median_k9(a, pw, lu_bign.lu_panel_cuda, TIMED_CALLS, torch)
        k9_plain_ms = _median_k9(a, pw, lu_bign.lu_panel_plain, 5, torch)
        # the work is what this run's data needs: its own pivots
        ipivs = lu_bign.lu_factor_big(a, pw)[2]
        flops, nbytes = _k9_work(batch, n, pw, ipivs)
        bound = _bound(flops, 0.0, nbytes)
        factor_ms = _median_ms(lambda: lu_bign.lu_factor_big(a, pw), torch)
        lu_factor_ex_ms = _median_ms(lambda: torch.linalg.lu_factor_ex(a),
                                     torch)
        inv_ms = _median_ms(lambda: torch.linalg.inv(a), torch)
        lane_ms = _median_ms(lambda: host_api.inverse_batched_device(
            a, "lu_bign_pallas"), torch)
        lu_pallas_ms = _median_ms(lambda: host_api.inverse_batched_device(
            a, "lu_pallas"), torch)
        plain_lane_ms = _median_ms(lambda: lu_bign.inverse_lu_big_plain(a),
                                   torch, calls=5, warmup=1)
        a64 = a.double()
        hiacc_ms = _median_ms(lambda: host_api.inverse_batched_device(
            a64, "lu_hiacc"), torch)
        lane_bound_ms = 1e3 * batch * 6.0 * n ** 3 / PEAK_FP32
        timing[("k9", case)] = (k9_ms, k9_plain_ms)
        library[("k9", case)] = lu_factor_ex_ms
        timing[("k9_bound", case)] = bound
        show("K9", case, pw=pw, kernel_ms_sum_of_launches=k9_ms,
             k9_before_ms=K9_BEFORE_MS[case],
             plain_ms_sum_of_panels=k9_plain_ms, bound_ms=bound[0],
             bound_by=bound[1], launches_per_call=len(ipivs),
             lu_factor_big_ms=factor_ms,
             torch_linalg_lu_factor_ex_ms=lu_factor_ex_ms,
             lane_lu_bign_pallas_ms=lane_ms, lane_lu_pallas_ms=lu_pallas_ms,
             lane_bound_ms=lane_bound_ms, plain_lane_ms=plain_lane_ms,
             torch_linalg_inv_ms=inv_ms, lu_hiacc_f64_ms=hiacc_ms)
        ladder = {}
        for width in (16, 32, 64):
            ladder[width] = {
                "lane_ms": _median_ms(lambda: lu_bign.inverse_lu_big(
                    a, pw=width), torch),
                "k9_ms": _median_k9(a, width, lu_bign.lu_panel_cuda,
                                    TIMED_CALLS, torch)}
        show("pw_ladder", case, default_pw=lu_bign.DEFAULT_PW, ladder=ladder)


# Phase 6 (the reference's harness): the fixture tree's dimensions, the
# shape of its rows, the CLIs' reps, and the stream's batch.
HARNESS_DIMS = (8, 32, 128)
HARNESS_N = 128
HARNESS_NUM = 100
INVERSE_REPS = 3
GAUSS_REPS = 2
STREAM_BATCH = 64
# the autodiff gradient against its fp64 closed form, max-norm relative
AUTODIFF_RTOL = 1e-4
# The general roster's host rows (lu_cpu, gauss_cpu, lu_native_cpu) are
# fp32 LAPACK / Gauss-Jordan with no polish, bit for bit the JAX package's
# host lanes: on the general class at n = 128 (κ ≤ 4n) they sit at
# ~4e-4, above GATE, where every polished device row passes it.  They are
# held to this instead (a broken oracle is off by O(1)).
HOST_GENERAL_GATE = 1e-3


def _cli_rows(bench, argv, what, phase5, lines, card, method=None):
    """Run a CLI through ``run_argv`` (what its ``main`` runs), print every
    CSV row as it comes, parse them with the port's ``parse_csv_rows`` and
    return ``(rows, reporter)``.  Each device row's mean ms is noted beside
    phase 5's time for the same lane (GP ``method``) and shape."""
    import io
    import tempfile

    from cuda_matrix_inversion_tpu_torch.bench.reporting import parse_csv_rows

    buf = io.StringIO()
    rep = bench.run_argv(argv, stream=buf)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"{what}: {line}", flush=True)
    with tempfile.NamedTemporaryFile("w", suffix=".csv") as f:
        f.write(text)
        f.flush()
        rows = parse_csv_rows(f.name)
    for row in rows:
        key = (("gp", method) if row["name"].endswith("_gpu")
               else ("lane", row["name"])) + (row["num_matrices"], row["n"])
        if key in phase5:
            lines.append({"phase": "reference_harness", "timing": what,
                          "row": row["name"],
                          "shape": f"{row['num_matrices']}x{row['n']}",
                          "cli_mean_ms": row["mean_ms"],
                          "phase5_ms": phase5[key][0],
                          "phase5_what": phase5[key][1], **card})
    return rows, rep


def _reference_harness(device, phase5, card, torch):
    """Phase 6: the reference's own workflow on the port — the fixture
    tree, the native oracle, both CLIs, the pinned-buffer stream and the
    autodiff backward.  Returns (printed lines, failures)."""
    import shutil
    import tempfile

    from cuda_matrix_inversion_tpu_torch.bench import gauss_bench, inverse_bench
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )
    from cuda_matrix_inversion_tpu_torch.io.fixtures import (
        generate_all,
        make_spd_batch,
    )
    from cuda_matrix_inversion_tpu_torch.io.stream import (
        DeviceBatchStream,
        stream_inverse,
    )
    from cuda_matrix_inversion_tpu_torch.native import build as native_build
    from cuda_matrix_inversion_tpu_torch.ops import autodiff
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
        list_inverse_algorithms,
    )

    lines, failures = [], []
    n, num = HARNESS_N, HARNESS_NUM
    root = tempfile.mkdtemp(prefix="cmi_harness_")
    try:
        t0 = time.monotonic()
        generate_all(root, dims=HARNESS_DIMS, num=num)
        native = native_build.ensure_built()
        native_err = None
        if native is None:
            try:
                native_build.build(verbose=False)
            except (OSError, native_build.NativeBuildError) as exc:
                native_err = str(exc)
        host_lanes = list_inverse_algorithms(cpu=True)
        print(json.dumps({"phase": "reference_harness", "fixtures": root,
                          "dims": list(HARNESS_DIMS), "num": num,
                          "seconds": time.monotonic() - t0,
                          "native_registered": "lu_native_cpu" in host_lanes
                          and "cholesky_native_cpu" in host_lanes,
                          "native_error": native_err,
                          "host_lanes": host_lanes}), flush=True)

        # inverse_bench: the default roster on the SPD set (100 and 1600
        # matrices), the general roster on the general set (100)
        available = set(list_inverse_algorithms())
        runs = [
            (f"inverse_{num}_{n}x{n}", 1, inverse_bench.DEFAULT_ALGORITHMS),
            (f"inverse_{num}_{n}x{n}", 16, inverse_bench.DEFAULT_ALGORITHMS),
            (f"square_5_{n}x{n}", 20, inverse_bench.GENERAL_ALGORITHMS)]
        for folder, dups, roster in runs:
            argv = [f"{root}/{folder}", str(INVERSE_REPS), str(dups), "-csv",
                    "--algorithms", *roster, "--device", str(device)]
            what = f"inverse_bench {folder} x{dups}"
            rows, rep = _cli_rows(inverse_bench, argv, what, phase5, lines,
                                  card)
            want = inverse_bench.resolve_algorithms(roster, available)
            got = [r["name"] for r in rows]
            if got != want:
                failures.append(f"{what}: rows {got}, want {want}")
            for name in want:
                gate = float(rep.entries[name].extra["max ||AA^-1 - I||_inf"])
                bound = (HOST_GENERAL_GATE if name.endswith("_cpu")
                         and folder.startswith("square") else GATE)
                lines.append({"phase": "reference_harness", "cli": what,
                              "row": name, "gate": gate, "bound": bound})
                if not gate < bound:
                    failures.append(f"{what} {name}: gate {gate:.3e}")

        # gauss_bench: each method at 100 and 1600 matrices (host rows on
        # the solve and inverse runs, the two host pipelines), the fit
        # rows once at 1600
        folder = f"{root}/gaussian_{num}_{n}x{n}"
        for dups in (1, 16):
            for method in GP_METHODS:
                argv = [folder, str(GAUSS_REPS), str(dups), "-csv",
                        "--method", method, "--device", str(device)]
                if method not in ("solve", "inverse"):
                    argv.append("--skip-cpu")
                if dups == 16 and method == "solve":
                    argv.append("--fit")
                what = f"gauss_bench {method} x{dups}"
                rows, _ = _cli_rows(gauss_bench, argv, what, phase5, lines,
                                    card, method=method)
                want = ["means_gpu", "variances_gpu"]
                if "--skip-cpu" not in argv:
                    want = ["means_cpu", "variances_cpu", *want]
                if "--fit" in argv:
                    want += ["fit_step_xla", "fit_step_pallas"]
                got = [r["name"] for r in rows]
                if got != want:
                    failures.append(f"{what}: rows {got}, want {want}")
                for r in rows:
                    if r["name"].startswith(("means", "variances", "fit")) \
                            and not r["err"] < GP_ATOL:
                        failures.append(f"{what} {r['name']}: error "
                                        f"{r['err']:.3e} per matrix")

        # stream_inverse over the written a.mats files: the same bits as
        # one direct call of the lane on the same re-chunked batches
        for lane, kinds in (("lu_pallas", ("inverse", "square")),
                            ("newton_schulz_spd10_pallas", ("inverse",))):
            fn = get_inverse_algorithm(lane)
            for dim in HARNESS_DIMS:
                paths = [f"{root}/inverse_{num}_{dim}x{dim}/a.mats"]
                if "square" in kinds:
                    paths.append(f"{root}/square_5_{dim}x{dim}/a.mats")
                streamed = list(stream_inverse(paths, lane, STREAM_BATCH,
                                               device=device))
                chunks = list(DeviceBatchStream(
                    paths, STREAM_BATCH, device="cpu")._host_batches())
                equal = len(streamed) == len(chunks)
                worst = 0.0
                for x, host in zip(streamed, chunks):
                    direct = fn(torch.tensor(host, device=device)).cpu()
                    equal &= torch.equal(torch.from_numpy(x), direct)
                    worst = max(worst, identity_error_inf(host, x))
                lines.append({"phase": "reference_harness",
                              "stream_inverse": lane, "n": dim,
                              "batches": [c.shape[0] for c in chunks],
                              "equal_to_direct": bool(equal), "gate": worst})
                if not equal:
                    failures.append(f"stream_inverse {lane} n={dim}: not "
                                    f"equal to the direct lane")
                if not worst < GATE:
                    failures.append(f"stream_inverse {lane} n={dim}: gate "
                                    f"{worst:.3e}")

        # autodiff: d sum(X * G) / dA through K2, against -A^-T G A^-T
        rng = np.random.default_rng(2029)
        a = torch.tensor(make_spd_batch(100, 32, rng), dtype=torch.float32,
                         device=device, requires_grad=True)
        g = torch.tensor(rng.standard_normal((100, 32, 32)),
                         dtype=torch.float32, device=device)
        x = autodiff.differentiable("lu_pallas")(a)
        (grad,) = torch.autograd.grad((x * g).sum(), a)
        inv64 = torch.linalg.inv(a.detach().double())
        ref = -(inv64.mT @ g.double() @ inv64.mT)
        rel = float((grad.double() - ref).abs().max() / ref.abs().max())
        lines.append({"phase": "reference_harness",
                      "autodiff": "differentiable('lu_pallas') 100x32",
                      "rel_vs_fp64": rel, "gate": AUTODIFF_RTOL})
        if not rel <= AUTODIFF_RTOL:
            failures.append(f"autodiff: {rel:.3e} off the fp64 closed form")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lines, failures


def main() -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )
    from cuda_matrix_inversion_tpu_torch.io.fixtures import (
        make_gp_batch,
        make_spd_batch,
        make_square_batch,
    )
    from cuda_matrix_inversion_tpu_torch.models import gp
    from cuda_matrix_inversion_tpu_torch.ops import (
        cuda_build,
        cuda_cholesky,
        cuda_gauss_jordan,
        cuda_gp,
        cuda_gp_lml,
        cuda_lu,
        host_api,
        linalg,
        lu_bign,
        newton_schulz,
    )
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        LANES,
        list_inverse_algorithms,
    )

    t_start = time.monotonic()

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 2. build ----
    t0 = time.monotonic()
    lib_path = cuda_build.build()
    cuda_build.library()
    print(f"build: {lib_path.name} in {time.monotonic() - t0:.2f} s",
          flush=True)

    # ---- 3. each kernel against its plain version ----
    k1_lanes = [name for name in list_inverse_algorithms(cpu=False)
                if LANES[name]["schedule"] is not None]
    k1_err = {"abs": 0.0, "rel": 0.0}
    k2_err = {"abs": 0.0, "rel_spd": 0.0, "rel_general": 0.0,
              "raw_equal_members": 0}
    gp_err = {k: {"abs": 0.0, "rel": 0.0} for k in ("k3", "k4", "k5", "k6")}
    new_err = {}  # K7, K8, K10, K11 (_compare's keys)
    shapes = [(b, n) for n in (8, 20, 64, 128) for b in (1, 7, 100)]
    shapes.append((1600, 128))
    for batch, n in shapes:
        rng = np.random.default_rng(1000 * n + batch)
        spd = torch.tensor(make_spd_batch(batch, n, rng), dtype=torch.float32,
                           device=dev)
        gen = torch.tensor(make_square_batch(batch, n, rng),
                           dtype=torch.float32, device=dev)
        for lane in k1_lanes:
            sched = LANES[lane]["schedule"]
            _k1_vs_plain(gen if sched.split3 else spd, sched,
                         f"{lane} {batch}x{n}", k1_err, torch)
        permuted = gen + n * torch.eye(n, device=dev)[
            torch.tensor(rng.permutation(n), device=dev)]
        singular = gen.clone()
        singular[batch // 2] = 1.0
        for label, a, rtol in (("spd", spd, K2_RTOL_SPD),
                               ("general", gen, K2_RTOL_GENERAL),
                               ("permuted", permuted, K2_RTOL_GENERAL),
                               ("singular", singular, K2_RTOL_GENERAL)):
            _k2_vs_plain(a, label, rtol, k2_err, torch,
                         singular=batch // 2 if label == "singular" else None)

        # K3 / K4 on the SPD draw, K5 / K6 on a GP system; for batch > 1
        # member batch // 2 is negated (negative definite) and alone must
        # come out non-finite, in the kernel and in the plain version.
        bad = batch // 2 if batch > 1 else None
        spd_bad = spd.clone()
        g = make_gp_batch(batch, n, rng)
        g = {k: torch.tensor(g[k], dtype=torch.float32, device=dev)
             for k in "abcde"}
        if bad is not None:
            spd_bad[bad] = -spd_bad[bad]
            g["b"][bad] = -g["b"][bad]
        flat = cuda_gp._flat(*(g[k] for k in "abcde"))
        for key, kernel, plain, args in (
                ("k3", cuda_cholesky.inverse_cholesky_cuda,
                 cuda_cholesky.inverse_cholesky_plain, (spd_bad,)),
                ("k4", cuda_cholesky.cholesky_cuda,
                 cuda_cholesky.cholesky_plain, (spd_bad,)),
                ("k5", cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_plain, flat),
                ("k6", cuda_gp.gp_fused_ns_cuda, cuda_gp.gp_fused_ns_plain,
                 flat)):
            what = f"{key.upper()} {batch}x{n}"
            x = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            ok = _confined(x, bad, what, torch)
            _confined(ref, bad, f"{what} plain", torch)
            diff = float((x[ok] - ref[ok]).abs().max())
            rel = _rel(x[ok], ref[ok])
            err = gp_err[key]
            err["abs"] = max(err["abs"], diff)
            err["rel"] = max(err["rel"], rel)
            if key in ("k3", "k4"):
                if not rel <= CHOL_RTOL:
                    raise AssertionError(f"{what}: kernel vs plain {rel:.3e}"
                                         f" > {CHOL_RTOL:g}")
                if key == "k3" and not torch.equal(x[ok], x[ok].mT):
                    raise AssertionError(f"{what}: inverse not symmetric")
            elif key == "k5" and not diff <= K5_ATOL:
                raise AssertionError(f"{what}: kernel vs plain {diff:.3e} > "
                                     f"{K5_ATOL:g}")
            elif key == "k6" and not (diff <= K6_ATOL and rel <= K6_RTOL):
                raise AssertionError(f"{what}: kernel vs plain {diff:.3e} "
                                     f"abs, {rel:.3e} rel")
        _new_kernels_vs_plain(batch, n, rng, dev, new_err, torch)
    for batch in (1, 7, 100):  # K6 and K11 at n = 72: zero padding to 128
        g = make_gp_batch(batch, 72, np.random.default_rng(72 + batch))
        g = {k: torch.tensor(g[k], dtype=torch.float32, device=dev)
             for k in "abcde"}
        bad = batch // 2 if batch > 1 else None
        _k11_vs_plain(g, bad, 72000 + batch, new_err, torch)
        if bad is not None:
            g["b"][bad] = -g["b"][bad]
        _compare("k6", cuda_gp.gp_fused_ns_cuda, cuda_gp.gp_fused_ns_plain,
                 cuda_gp._flat(*(g[k] for k in "abcde")), bad, K6_RTOL,
                 gp_err, torch)
    if not gp_err["k6"]["abs"] <= K6_ATOL:
        raise AssertionError(f"K6: kernel vs plain {gp_err['k6']['abs']:.3e}"
                             f" abs > {K6_ATOL:g}")
    # K11 off its default schedule: the fp32 polish round alone, and split
    # residual polish rounds before it
    for lo, hi in ((0, 1), (1, 2), (3, 2)):
        for n in (20, 128):
            g = make_gp_batch(7, n, np.random.default_rng(100 * lo + hi + n))
            _k11_vs_plain({k: torch.tensor(g[k], dtype=torch.float32,
                                           device=dev) for k in "abcde"},
                          3, 7000 + n, new_err, torch, lo=lo, hi=hi)
    # K1 and K8 where n is no multiple of 16 (zero padding in the tiles; n
    # = 1 in NP = 16, where two warps own tiles), K1 with every polish
    # residual the split (polish_highest=False), K8 off its default
    # schedule with a NaN member
    for n in (1, 40, 72, 127):
        for batch in (1, 7, 100):
            rng = np.random.default_rng(2000 * n + batch)
            spd = torch.tensor(make_spd_batch(batch, n, rng),
                               dtype=torch.float32, device=dev)
            gen = torch.tensor(make_square_batch(batch, n, rng),
                               dtype=torch.float32, device=dev)
            for lane in k1_lanes:
                sched = LANES[lane]["schedule"]
                _k1_vs_plain(gen if sched.split3 else spd, sched,
                             f"{lane} {batch}x{n}", k1_err, torch)
            _k8_vs_plain(spd, gen, batch // 2 if batch > 1 else None,
                         2000 * n + batch, new_err, torch)
    for n in (20, 72, 128):
        spd = torch.tensor(make_spd_batch(7, n, np.random.default_rng(n)),
                           dtype=torch.float32, device=dev)
        for init in ("spd", "pan"):
            _k1_vs_plain(spd, newton_schulz.resolve_schedule(
                init=init, polish_highest=False),
                f"{init} polish_highest=False 7x{n}", k1_err, torch)
    for lo, hi in ((0, 1), (1, 2), (3, 2)):
        for n in (20, 128):
            rng = np.random.default_rng(300 * lo + hi + n)
            spd = torch.tensor(make_spd_batch(7, n, rng),
                               dtype=torch.float32, device=dev)
            gen = torch.tensor(make_square_batch(7, n, rng),
                               dtype=torch.float32, device=dev)
            _k8_vs_plain(spd, gen, 3, 8000 + n, new_err, torch, lo=lo,
                         hi=hi)
    # K7 at every instance off the shapes above (n = 1, 7: NP = 16; 40:
    # 64; 72, 127: 128, padded; 160 and the JAX kernel's ceiling 192: 192;
    # n off a multiple of 4: scalar loads), and on small integers in
    # [-2, 2], where exact ties decide the pivots (a member may be
    # singular)
    for n in (1, 7, 40, 72, 127, 160, 192):
        for batch in (1, 7, 100):
            _new_kernels_vs_plain(batch, n, np.random.default_rng(
                4000 * n + batch), dev, new_err, torch, k7_only=True)
    for batch, n in ((7, 7), (7, 20), (7, 64), (7, 72), (100, 128), (7, 160),
                     (7, 192)):
        ties = np.random.default_rng(6000 + n).integers(-2, 3, (batch, n, n))
        _k7_vs_plain(torch.tensor(ties, dtype=torch.float32, device=dev),
                     "ties", new_err, torch)
    # K2 at every instance off the shapes above (n = 1, 2, 7: NP = 16;
    # 40: 64; 72, 127: 128, padded; n off a multiple of 4: scalar loads),
    # and on small integers in [-2, 2], where exact ties decide the pivots
    # (a member may be singular: raw bits only)
    for n in (1, 2, 7, 40, 72, 127):
        for batch in (1, 7, 100):
            rng = np.random.default_rng(3000 * n + batch)
            gen = torch.tensor(make_square_batch(batch, n, rng),
                               dtype=torch.float32, device=dev)
            _k2_vs_plain(gen, "general", K2_RTOL_GENERAL, k2_err, torch)
            if batch > 1:
                gen[batch // 2] = 1.0 if n > 1 else 0.0
                _k2_vs_plain(gen, "singular", K2_RTOL_GENERAL, k2_err, torch,
                             singular=batch // 2)
    for batch, n in ((7, 7), (7, 20), (7, 64), (7, 72), (100, 128)):
        ties = np.random.default_rng(5000 + n).integers(-2, 3, (batch, n, n))
        _k2_vs_plain(torch.tensor(ties, dtype=torch.float32, device=dev),
                     "ties", None, k2_err, torch)
    _k9_vs_plain(dev, new_err, torch)
    print(json.dumps({"phase": "kernels_vs_plain", "shapes": len(shapes),
                      "k1": k1_err, "k2": k2_err, **gp_err, **new_err}),
          flush=True)

    # ---- 4. the main path ----
    rng = np.random.default_rng(2026)
    a100 = make_spd_batch(100, 128, rng).astype(np.float32)
    a1600 = make_spd_batch(1600, 128, np.random.default_rng(2027)
                           ).astype(np.float32)
    sq100 = make_square_batch(100, 128, np.random.default_rng(2026)
                              ).astype(np.float32)
    inv100_ref = np.linalg.inv(a100.astype(np.float64))
    cases = {"spd_100x128": a100, "spd_1600x128": a1600,
             "square_100x128": sq100}
    dev_cases = {k: torch.tensor(v, device=dev) for k, v in cases.items()}
    device_lanes = list_inverse_algorithms(cpu=False)
    runs = [(lane, "spd_100x128") for lane in device_lanes]
    runs += [(lane, "spd_1600x128") for lane in device_lanes]
    runs += [("lu_pallas", "square_100x128"),
             ("newton_schulz_pan500_pallas", "square_100x128")]
    # GP systems as generate_gaussian_fixtures draws them, and entry()'s
    # forward step (batch 64, n = 128, seed 0, draws in its order)
    gp_host = {"gp_100x128": make_gp_batch(100, 128,
                                           np.random.default_rng(2026)),
               "gp_1600x128": make_gp_batch(1600, 128,
                                            np.random.default_rng(2027))}
    gp_host = {case: {k: g[k].astype(np.float32) for k in "abcde"}
               for case, g in gp_host.items()}
    rng0 = np.random.default_rng(0)
    entry = {"b": make_spd_batch(64, 128, rng0).astype(np.float32)}
    for k, shape in (("a", (64, 128, 1)), ("c", (64, 128, 1)),
                     ("d", (64, 128, 1)), ("e", (64, 1, 1))):
        entry[k] = rng0.random(shape, dtype=np.float32)
    gp_ref = {case: _gp_ref64(g) for case, g in gp_host.items()}
    gp_ref["entry_64x128"] = _gp_ref64(entry)
    gp_dev = {case: [torch.tensor(g[k], device=dev) for k in "abcde"]
              for case, g in gp_host.items()}
    counters = {"k1": newton_schulz.ns_iterate_cuda,
                "k2": cuda_lu.lu_inverse_cuda,
                "k3": cuda_cholesky.inverse_cholesky_cuda,
                "k4": cuda_cholesky.cholesky_cuda,
                "k5": cuda_gp.gp_fused_cuda,
                "k6": cuda_gp.gp_fused_ns_cuda,
                "k7": cuda_gauss_jordan.gauss_jordan_cuda,
                "k8": newton_schulz.ns_refine_cuda,
                "k10": cuda_gp_lml.lml_quad_logdet_cuda,
                "k11": cuda_gp.gp_fused_warm_cuda,
                "k9": lu_bign.lu_panel_cuda}
    inversion_path = ("k1", "k2", "k3", "k4", "k5", "k6")
    engine_path = ("k7", "k8", "k10", "k11")
    big_n_path = ("k2", "k9")
    harness_path = ("k1", "k2", "k3", "k5", "k6", "k7", "k9", "k10")

    for fn in counters.values():
        fn.launches = 0
    outputs = {}
    for lane, case in runs:
        outputs[(lane, case)] = host_api.inverse_batched_device(
            dev_cases[case], lane)
    host_out = host_api.inverse_batched(a100, "newton_schulz_spd10_pallas",
                                        device="cuda", check=True)
    gp_out = {}
    for case, (a, b, c, d, e) in gp_dev.items():
        for method in GP_METHODS:
            gp_out[("gp_mean_variance", method, case)] = gp.gp_mean_variance(
                a, b, c, d, e, method=method)
        for method in ("pallas", "pallas_ns"):
            gp_out[("gp_mean", method, case)] = (
                gp.gp_mean(a, b, c, d, method=method), None)
            gp_out[("gp_variance", method, case)] = (
                None, gp.gp_variance(a, b, c, e, method=method))
    gp_out[("gp_mean_variance_host", "solve", "entry_64x128")] = (
        gp.gp_mean_variance_host(*(entry[k] for k in "abcde"),
                                 method="solve", device="cuda"))
    k100 = linalg.add_diagonal(gp_dev["gp_100x128"][1],
                               gp_dev["gp_100x128"][2])
    l100 = cuda_cholesky.cholesky(k100)
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counters.items()}

    for (lane, case), out in outputs.items():
        a = cases[case]
        x = out.cpu().numpy()
        if x.shape != a.shape or x.dtype != np.float32:
            raise AssertionError(f"{lane} {case}: got {x.shape} {x.dtype}")
        if not np.isfinite(x).all():
            raise AssertionError(f"{lane} {case}: non-finite output")
        gate = identity_error_inf(a, x)
        line = {"phase": "main_path", "lane": lane, "case": case,
                "gate": gate}
        if case == "spd_100x128":
            line["rel_vs_fp64_inverse"] = float(
                np.abs(x - inv100_ref).max() / np.abs(inv100_ref).max())
        print(json.dumps(line), flush=True)
        if not gate < GATE:
            raise AssertionError(f"{lane} {case}: gate {gate:.3e} >= {GATE}")
        if line.get("rel_vs_fp64_inverse", 0.0) > 1e-4:
            raise AssertionError(f"{lane} {case}: disagrees with the fp64 "
                                 f"inverse")
    host_gate = identity_error_inf(a100, host_out)
    print(json.dumps({"phase": "main_path", "lane": "inverse_batched "
                      "newton_schulz_spd10_pallas", "case": "spd_100x128",
                      "gate": host_gate}), flush=True)
    if not host_gate < GATE:
        raise AssertionError(f"inverse_batched: gate {host_gate:.3e}")

    for (fn, method, case), pair in gp_out.items():
        line = {"phase": "main_path", "fn": fn, "method": method,
                "case": case}
        for label, out, ref in zip(("mean", "var"), pair, gp_ref[case]):
            if out is None:
                continue
            x = out if isinstance(out, np.ndarray) else out.cpu().numpy()
            if x.shape != (ref.shape[0], 1, 1) or x.dtype != np.float32:
                raise AssertionError(f"{fn} {method} {case}: {label} is "
                                     f"{x.shape} {x.dtype}")
            if not np.isfinite(x).all():
                raise AssertionError(f"{fn} {method} {case}: non-finite "
                                     f"{label}")
            line[f"{label}_abs_err"] = float(np.abs(x[:, 0, 0] - ref).max())
        print(json.dumps(line), flush=True)
        if any(v >= GP_ATOL for k, v in line.items() if k.endswith("err")):
            raise AssertionError(f"{fn} {method} {case}: off the fp64 closed "
                                 f"form by {GP_ATOL:g} or more")
    l_ref = np.linalg.cholesky(k100.double().cpu().numpy())
    l_rel = float(np.abs(l100.cpu().numpy() - l_ref).max()
                  / np.abs(l_ref).max())
    print(json.dumps({"phase": "main_path", "fn": "cholesky",
                      "case": "gp_100x128 K", "rel_vs_fp64": l_rel,
                      "launches": launches}), flush=True)
    if not l_rel < GATE:
        raise AssertionError(f"cholesky: {l_rel:.3e} off the fp64 factor")
    if not all(launches[k] for k in inversion_path):
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}")

    # the serving and fitting path, counted on its own
    for fn in counters.values():
        fn.launches = 0
    engine_lines = _engine_path(dev, cases, gp_host, gp_ref, torch)
    torch.cuda.synchronize()
    engine_launches = {key: fn.launches for key, fn in counters.items()}
    for line in engine_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "engine_path", "launches": engine_launches}),
          flush=True)
    if not all(engine_launches[k] for k in engine_path):
        raise AssertionError(f"engine path did not launch every kernel: "
                             f"{engine_launches}")

    # the big-n and fp64 path, counted on its own
    big_cases = _big_n_cases()
    for fn in counters.values():
        fn.launches = 0
    big_lines = _big_n_path(dev, big_cases, torch)
    torch.cuda.synchronize()
    big_launches = {key: fn.launches for key, fn in counters.items()}
    for line in big_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "big_n_path", "launches": big_launches}),
          flush=True)
    if not all(big_launches[k] for k in big_n_path):
        raise AssertionError(f"big-n path did not launch every kernel: "
                             f"{big_launches}")
    print(json.dumps(_fp32_residual_floor(dev, big_cases, torch)),
          flush=True)
    launches = {k: launches[k] + engine_launches[k] + big_launches[k]
                for k in counters}

    # ---- 5. timing ----
    name, limit = [s.strip() for s in smi.split(",", 1)]
    card = {"card": name, "power_limit": limit}
    timing = {}
    library = {}  # the one PyTorch call computing the same function
    # phase 5's time of each lane / GP method by ("lane" | "gp", name,
    # batch, n), for phase 6's CLI rows
    phase5 = {}
    # K2's general class (κ ≤ 4n) at both shapes
    k2_squares = {"spd_100x128": dev_cases["square_100x128"],
                  "spd_1600x128": torch.tensor(make_square_batch(
                      1600, 128, np.random.default_rng(2028)),
                      dtype=torch.float32, device=dev)}
    for case in ("spd_100x128", "spd_1600x128"):
        a = dev_cases[case]
        linalg_ms = _median_ms(lambda: torch.linalg.inv(a), torch)
        lane_ms = {}
        for lane in list_inverse_algorithms(cpu=False):
            lane_ms[lane] = _median_ms(
                lambda: host_api.inverse_batched_device(a, lane), torch)
            phase5[("lane", lane, a.shape[0], a.shape[-1])] = (
                lane_ms[lane], f"inverse_batched_device {case}")
            print(json.dumps({"timing": "lane", "lane": lane, "case": case,
                              "ms": lane_ms[lane],
                              "torch_linalg_inv_ms": linalg_ms, **card}),
                  flush=True)
        for lane in k1_lanes:
            sched = LANES[lane]["schedule"]
            ms = _median_ms(lambda: newton_schulz.ns_iterate_cuda(a, sched),
                            torch)
            plain_ms = _median_ms(
                lambda: newton_schulz.ns_iterate_plain(a, sched), torch)
            timing[("k1", lane, case)] = (ms, plain_ms)
            library[("k1", lane, case)] = linalg_ms
            print(json.dumps({"timing": "K1", "lane": lane, "case": case,
                              "kernel_ms": ms, "plain_ms": plain_ms,
                              "k1_before_ms": K1_BEFORE_MS[lane][case],
                              "torch_linalg_inv_ms": linalg_ms, **card}),
                  flush=True)
        ms = _median_ms(lambda: cuda_lu.lu_inverse_cuda(a), torch)
        plain_ms = _median_ms(lambda: cuda_lu.lu_inverse_plain(a), torch)
        timing[("k2", "lu_pallas", case)] = (ms, plain_ms)
        library[("k2", "lu_pallas", case)] = linalg_ms
        sq = k2_squares[case]
        print(json.dumps({"timing": "K2", "lane": "lu_pallas", "case": case,
                          "kernel_ms": ms, "k2_before_ms": K2_BEFORE_MS[case],
                          "plain_ms": plain_ms,
                          "torch_linalg_inv_ms": linalg_ms,
                          "general_class": {
                              "kernel_ms": _median_ms(
                                  lambda: cuda_lu.lu_inverse_cuda(sq), torch),
                              "lane_ms": _median_ms(
                                  lambda: cuda_lu.inverse_lu(sq), torch),
                              "torch_linalg_inv_ms": _median_ms(
                                  lambda: torch.linalg.inv(sq), torch)},
                          **card}), flush=True)
        chol_ms = _median_ms(lambda: linalg.cholesky(a), torch)
        for key, kernel, plain, lane, lane_t in (
                ("k3", cuda_cholesky.inverse_cholesky_cuda,
                 cuda_cholesky.inverse_cholesky_plain, "cholesky_pallas",
                 lane_ms["cholesky_pallas"]),
                ("k4", cuda_cholesky.cholesky_cuda,
                 cuda_cholesky.cholesky_plain, "cuda_cholesky.cholesky",
                 _median_ms(lambda: cuda_cholesky.cholesky(a), torch))):
            ms = _median_ms(lambda: kernel(a), torch)
            plain_ms = _median_ms(lambda: plain(a), torch)
            timing[(key, case)] = (ms, plain_ms)
            library[(key, case)] = (lane_ms["cholesky"] if key == "k3"
                                    else chol_ms)
            before = (K3_BEFORE_MS if key == "k3" else K4_BEFORE_MS)[case]
            print(json.dumps({"timing": key.upper(), "lane": lane,
                              "case": case, "kernel_ms": ms,
                              f"{key}_before_ms": before,
                              "plain_ms": plain_ms, "lane_ms": lane_t,
                              "library_ms": {
                                  "cholesky (linalg.inverse_cholesky)":
                                      lane_ms["cholesky"],
                                  "torch.linalg.cholesky_ex": chol_ms},
                              **card}), flush=True)
    for case, args in gp_dev.items():
        method_ms = {}
        for method in GP_METHODS:
            method_ms[method] = _median_ms(
                lambda: gp.gp_mean_variance(*args, method=method), torch)
            phase5[("gp", method, args[1].shape[0], args[1].shape[-1])] = (
                method_ms[method], f"gp_mean_variance (mean and var) {case}")
            print(json.dumps({"timing": "gp_mean_variance", "method": method,
                              "case": case, "ms": method_ms[method],
                              **card}), flush=True)
        flat = cuda_gp._flat(*args)
        for key, kernel, plain, method in (
                ("k5", cuda_gp.gp_fused_cuda, cuda_gp.gp_fused_plain,
                 "pallas"),
                ("k6", cuda_gp.gp_fused_ns_cuda, cuda_gp.gp_fused_ns_plain,
                 "pallas_ns")):
            ms = _median_ms(lambda: kernel(*flat), torch)
            plain_ms = _median_ms(lambda: plain(*flat), torch)
            timing[(key, case)] = (ms, plain_ms)
            library[(key, case)] = method_ms["solve"]
            before = ({"k6_before_ms": K6_BEFORE_MS[case]} if key == "k6"
                      else {"k5_before_ms": K5_BEFORE_MS[case]})
            print(json.dumps({"timing": key.upper(), "method": method,
                              "case": case, "kernel_ms": ms,
                              "plain_ms": plain_ms,
                              "lane_ms": method_ms[method],
                              "solve_method_ms": method_ms["solve"],
                              **before, **card}), flush=True)
    _time_new_kernels(dev, dev_cases, gp_dev, timing, library, card, torch)
    _time_big_n(dev, big_cases, timing, library, card, torch)

    # ---- 6. the reference's harness, counted on its own ----
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    harness_lines, failures = _reference_harness(dev, phase5, card, torch)
    torch.cuda.synchronize()
    harness_launches = {key: fn.launches for key, fn in counters.items()}
    for line in harness_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "reference_harness",
                      "seconds": time.monotonic() - t0,
                      "launches": harness_launches}), flush=True)
    if failures:
        raise AssertionError("reference harness: " + "; ".join(failures))
    if not all(harness_launches[k] for k in harness_path):
        raise AssertionError(f"reference harness did not launch every "
                             f"kernel of its path: {harness_launches}")
    launches = {k: launches[k] + harness_launches[k] for k in counters}

    scheds = (LANES["newton_schulz_spd10_pallas"]["schedule"],
              cuda_gp.GP_NS_SCHEDULE)
    bounds = _kernel_bounds(100, 128, *scheds)
    print(json.dumps({"bounds_ms": {
        f"{batch}x128": {k: v[0] for k, v in
                         _kernel_bounds(batch, 128, *scheds).items()}
        for batch in (100, 1600)}, "peaks": {
            "fp32": PEAK_FP32, "bf16": PEAK_BF16, "hbm": PEAK_HBM}}),
          flush=True)

    def entry_line(key, title, source, replaces, ms_key):
        err = {"k1": k1_err, "k2": k2_err, **gp_err, **new_err}[
            "k10_emit_w" if key == "k10" else key]
        ms, plain_ms = timing[ms_key]
        bound_ms, bound_by = bounds[key]
        return {"name": title, "route": "cuda",
                "source": f"cuda_matrix_inversion_tpu_torch/csrc/{source}",
                "replaces": f"cuda_matrix_inversion_tpu/ops/{replaces}",
                "launches": launches[key], "max_abs_err": err["abs"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library.get(ms_key)}

    kernels = [
        entry_line("k1", "K1 newton_schulz (spd10 schedule, 100x128)",
                   "newton_schulz.cu", "newton_schulz.py:549",
                   ("k1", "newton_schulz_spd10_pallas", "spd_100x128")),
        entry_line("k2", "K2 lu (pivoted getrf + inverse, 100x128)",
                   "lu.cu", "pallas_lu.py:453",
                   ("k2", "lu_pallas", "spd_100x128")),
        entry_line("k3", "K3 cholesky inverse (100x128)", "cholesky.cu",
                   "pallas_cholesky.py:475", ("k3", "spd_100x128")),
        entry_line("k4", "K4 cholesky factor (100x128)", "cholesky.cu",
                   "pallas_cholesky.py:507", ("k4", "spd_100x128")),
        entry_line("k5", "K5 fused GP mean/variance, Cholesky (100x128)",
                   "gp.cu", "pallas_gp.py:171", ("k5", "gp_100x128")),
        entry_line("k6", "K6 fused GP mean/variance, Newton-Schulz "
                   "(100x128)", "gp.cu", "pallas_gp.py:606",
                   ("k6", "gp_100x128")),
        entry_line("k7", "K7 gauss_jordan (pivoted, no polish, square "
                   "100x128)", "gauss_jordan.cu",
                   "pallas_gauss_jordan.py:244", ("k7", "square_100x128")),
        entry_line("k8", "K8 newton_schulz warm (bf16, 2+1 rounds, drifted "
                   "spd 100x128)", "newton_schulz.cu", "newton_schulz.py:742",
                   ("k8", "spd_100x128")),
        entry_line("k10", "K10 fused GP log marginal likelihood (emit_w, "
                   "the fit's forward, 100x128)", "gp.cu", "pallas_gp.py:304",
                   ("k10_emit_w", "spd_100x128")),
        entry_line("k11", "K11 fused GP mean/variance, warm Newton-Schulz "
                   "(100x128)", "gp.cu", "pallas_gp.py:491",
                   ("k11", "gp_100x128")),
    ]
    k9_ms, k9_plain_ms = timing[("k9", "nonsym500_100x512")]
    k9_bound_ms, k9_bound_by = timing[("k9_bound", "nonsym500_100x512")]
    kernels.insert(8, {
        "name": f"K9 lu_bign panel (getf2 + laswp + the two triangle "
                f"inverses; all {512 // lu_bign.pick_pw(512)} panel launches "
                f"of one 100x512 call, summed; library: "
                f"torch.linalg.lu_factor_ex, the whole factor)",
        "route": "cuda",
        "source": "cuda_matrix_inversion_tpu_torch/csrc/lu_bign.cu",
        "replaces": "cuda_matrix_inversion_tpu/ops/lu_bign.py:195",
        "launches": launches["k9"], "max_abs_err": new_err["k9"]["abs"],
        "ms": k9_ms, "plain_ms": k9_plain_ms, "bound_ms": k9_bound_ms,
        "bound_by": k9_bound_by,
        "library_ms": library[("k9", "nonsym500_100x512")]})
    print(f"total {time.monotonic() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
