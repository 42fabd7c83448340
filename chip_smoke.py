#!/usr/bin/env python3
"""Drive the PyTorch / H100 port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the hand-written kernels (``csrc/*.cu``, sm_90a);
3. kernels: each kernel (K1–K6) against its plain PyTorch version on the
   card, at n ∈ {8, 20, 64, 128} and batch ∈ {1, 7, 100} (and 1600 at
   n = 128); K3–K6 with one indefinite member per batch, which alone must
   come out non-finite;
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
   form.  Every kernel's launch counter must move in this phase;
5. timing: CUDA events, median of 20 calls after warm-up, for each lane,
   each GP method, and each kernel beside its plain version and the
   library (``torch.linalg.inv``; ``torch.linalg.cholesky``; the GP
   ``solve`` method on cuSOLVER).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
# GP main path: mean and var against the fp64 closed form (the JAX test's
# bound, tests/test_gauss_jordan_gp.py).
GP_ATOL = 1e-4
GP_METHODS = ("solve", "inverse", "lu", "newton_schulz", "pallas",
              "pallas_ns")
TIMED_CALLS = 20


def _rel(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


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
        cuda_gp,
        cuda_lu,
        host_api,
        linalg,
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
    k1_lanes = [name for name in list_inverse_algorithms()
                if LANES[name]["schedule"] is not None]
    k1_err = {"abs": 0.0, "rel": 0.0}
    k2_err = {"abs": 0.0, "rel_spd": 0.0, "rel_general": 0.0}
    gp_err = {k: {"abs": 0.0, "rel": 0.0} for k in ("k3", "k4", "k5", "k6")}
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
            a = gen if sched.split3 else spd
            x = newton_schulz.ns_iterate_cuda(a, sched)
            torch.cuda.synchronize()
            ref = newton_schulz.ns_iterate_plain(a, sched, bf16_products=True)
            rel = _rel(x, ref)
            k1_err["abs"] = max(k1_err["abs"], float((x - ref).abs().max()))
            k1_err["rel"] = max(k1_err["rel"], rel)
            if not rel <= K1_RTOL:
                raise AssertionError(
                    f"K1 {lane} {batch}x{n}: kernel vs plain {rel:.3e} > "
                    f"{K1_RTOL:g}")
        permuted = gen + n * torch.eye(n, device=dev)[
            torch.tensor(rng.permutation(n), device=dev)]
        singular = gen.clone()
        singular[batch // 2] = 1.0
        for label, a, rtol in (("spd", spd, K2_RTOL_SPD),
                               ("general", gen, K2_RTOL_GENERAL),
                               ("permuted", permuted, K2_RTOL_GENERAL),
                               ("singular", singular, K2_RTOL_GENERAL)):
            eye = torch.eye(n, device=dev)
            x, piv = cuda_lu.lu_inverse_cuda(a)
            torch.cuda.synchronize()
            ref, ref_piv = cuda_lu.lu_inverse_plain(a)
            x = x + x @ (eye - a @ x)
            ref = ref + ref @ (eye - a @ ref)
            ok = torch.isfinite(ref).all(dim=(1, 2))
            if not torch.equal(torch.isfinite(x).all(dim=(1, 2)), ok):
                raise AssertionError(f"K2 {label} {batch}x{n}: non-finite "
                                     f"members differ from the plain version")
            if label == "singular" and bool(ok[batch // 2]):
                raise AssertionError(f"K2 singular {batch}x{n}: singular "
                                     f"member came out finite")
            if int(ok.sum()) == 0:
                continue
            rel = _rel(x[ok], ref[ok])
            k2_err["abs"] = max(k2_err["abs"],
                                float((x[ok] - ref[ok]).abs().max()))
            key = "rel_spd" if label == "spd" else "rel_general"
            k2_err[key] = max(k2_err[key], rel)
            if not rel <= rtol:
                raise AssertionError(f"K2 {label} {batch}x{n}: kernel vs "
                                     f"plain {rel:.3e} > {rtol:g}")
            if not torch.equal(piv[ok], ref_piv[ok]):
                raise AssertionError(f"K2 {label} {batch}x{n}: pivots differ")

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
    print(json.dumps({"phase": "kernels_vs_plain", "shapes": len(shapes),
                      "k1": k1_err, "k2": k2_err, **gp_err}), flush=True)

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
    runs = [(lane, "spd_100x128") for lane in list_inverse_algorithms()]
    runs += [(lane, "spd_1600x128") for lane in list_inverse_algorithms()]
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
                "k6": cuda_gp.gp_fused_ns_cuda}

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
    if not all(launches.values()):
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}")

    # ---- 5. timing ----
    name, limit = [s.strip() for s in smi.split(",", 1)]
    card = {"card": name, "power_limit": limit}
    timing = {}
    for case in ("spd_100x128", "spd_1600x128"):
        a = dev_cases[case]
        linalg_ms = _median_ms(lambda: torch.linalg.inv(a), torch)
        lane_ms = {}
        for lane in list_inverse_algorithms():
            lane_ms[lane] = _median_ms(
                lambda: host_api.inverse_batched_device(a, lane), torch)
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
            print(json.dumps({"timing": "K1", "lane": lane, "case": case,
                              "kernel_ms": ms, "plain_ms": plain_ms,
                              "torch_linalg_inv_ms": linalg_ms, **card}),
                  flush=True)
        ms = _median_ms(lambda: cuda_lu.lu_inverse_cuda(a), torch)
        plain_ms = _median_ms(lambda: cuda_lu.lu_inverse_plain(a), torch)
        timing[("k2", "lu_pallas", case)] = (ms, plain_ms)
        print(json.dumps({"timing": "K2", "lane": "lu_pallas", "case": case,
                          "kernel_ms": ms, "plain_ms": plain_ms,
                          "torch_linalg_inv_ms": linalg_ms, **card}),
              flush=True)
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
            print(json.dumps({"timing": key.upper(), "lane": lane,
                              "case": case, "kernel_ms": ms,
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
            print(json.dumps({"timing": key.upper(), "method": method,
                              "case": case, "kernel_ms": ms,
                              "plain_ms": plain_ms,
                              "lane_ms": method_ms[method],
                              "solve_method_ms": method_ms["solve"],
                              **card}), flush=True)

    def entry_line(key, title, source, replaces, ms_key):
        err = {"k1": k1_err, "k2": k2_err, **gp_err}[key]
        ms, plain_ms = timing[ms_key]
        return {"name": title, "route": "cuda",
                "source": f"cuda_matrix_inversion_tpu_torch/csrc/{source}",
                "replaces": f"cuda_matrix_inversion_tpu/ops/{replaces}",
                "launches": launches[key], "max_abs_err": err["abs"],
                "ms": ms, "plain_ms": plain_ms}

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
    ]
    print(f"total {time.monotonic() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
