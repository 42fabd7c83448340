#!/usr/bin/env python3
"""Drive the PyTorch / H100 port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the hand-written kernels (``csrc/*.cu``, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card, at
   n ∈ {8, 20, 64, 128} and batch ∈ {1, 7, 100} (and 1600 at n = 128);
4. main path: every registry lane through ``inverse_batched_device`` on
   ``make_spd_batch(100, 128, default_rng(2026))`` and a 1600×128 batch,
   ``lu_pallas`` and pan500 also on ``make_square_batch(100, 128)``, and
   ``inverse_batched`` once NumPy in, NumPy out; every result must pass
   max‖AA⁻¹−I‖∞ < 1e-4 (fp64) and the kernels' launch counters must move;
5. timing: CUDA events, median of 20 calls after warm-up, for each lane
   and for each kernel beside its plain version and ``torch.linalg.inv``.

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


def main() -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cuda_matrix_inversion_tpu_torch.bench.reporting import (
        identity_error_inf,
    )
    from cuda_matrix_inversion_tpu_torch.io.fixtures import (
        make_spd_batch,
        make_square_batch,
    )
    from cuda_matrix_inversion_tpu_torch.ops import (
        cuda_build,
        cuda_lu,
        host_api,
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
    print(json.dumps({"phase": "kernels_vs_plain", "shapes": len(shapes),
                      "k1": k1_err, "k2": k2_err}), flush=True)

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

    newton_schulz.ns_iterate_cuda.launches = 0
    cuda_lu.lu_inverse_cuda.launches = 0
    outputs = {}
    for lane, case in runs:
        outputs[(lane, case)] = host_api.inverse_batched_device(
            dev_cases[case], lane)
    host_out = host_api.inverse_batched(a100, "newton_schulz_spd10_pallas",
                                        device="cuda", check=True)
    torch.cuda.synchronize()
    launches = {"k1": newton_schulz.ns_iterate_cuda.launches,
                "k2": cuda_lu.lu_inverse_cuda.launches}

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
                      "gate": host_gate, "launches": launches}), flush=True)
    if not host_gate < GATE:
        raise AssertionError(f"inverse_batched: gate {host_gate:.3e}")
    if launches["k1"] == 0 or launches["k2"] == 0:
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}")

    # ---- 5. timing ----
    name, limit = [s.strip() for s in smi.split(",", 1)]
    timing = {}
    for case in ("spd_100x128", "spd_1600x128"):
        a = dev_cases[case]
        linalg_ms = _median_ms(lambda: torch.linalg.inv(a), torch)
        for lane in list_inverse_algorithms():
            ms = _median_ms(
                lambda: host_api.inverse_batched_device(a, lane), torch)
            print(json.dumps({"timing": "lane", "lane": lane, "case": case,
                              "ms": ms, "torch_linalg_inv_ms": linalg_ms,
                              "card": name, "power_limit": limit}),
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
                              "torch_linalg_inv_ms": linalg_ms, "card": name,
                              "power_limit": limit}), flush=True)
        ms = _median_ms(lambda: cuda_lu.lu_inverse_cuda(a), torch)
        plain_ms = _median_ms(lambda: cuda_lu.lu_inverse_plain(a), torch)
        timing[("k2", "lu_pallas", case)] = (ms, plain_ms)
        print(json.dumps({"timing": "K2", "lane": "lu_pallas", "case": case,
                          "kernel_ms": ms, "plain_ms": plain_ms,
                          "torch_linalg_inv_ms": linalg_ms, "card": name,
                          "power_limit": limit}), flush=True)

    k1_ms, k1_plain = timing[("k1", "newton_schulz_spd10_pallas",
                              "spd_100x128")]
    k2_ms, k2_plain = timing[("k2", "lu_pallas", "spd_100x128")]
    kernels = [
        {"name": "K1 newton_schulz (spd10 schedule, 100x128)",
         "route": "cuda",
         "source": "cuda_matrix_inversion_tpu_torch/csrc/newton_schulz.cu",
         "replaces": "cuda_matrix_inversion_tpu/ops/newton_schulz.py:549",
         "launches": launches["k1"], "max_abs_err": k1_err["abs"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 lu (pivoted getrf + inverse, 100x128)",
         "route": "cuda",
         "source": "cuda_matrix_inversion_tpu_torch/csrc/lu.cu",
         "replaces": "cuda_matrix_inversion_tpu/ops/pallas_lu.py:453",
         "launches": launches["k2"], "max_abs_err": k2_err["abs"],
         "ms": k2_ms, "plain_ms": k2_plain},
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
