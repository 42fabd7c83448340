"""Probes of kernels K1 and K8 (``csrc/newton_schulz.cu``: the
fixed-schedule Newton-Schulz inverse and its warm refinement) on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.ns_probe [BASELINE_CSRC]

Each probe builds ``newton_schulz.cu`` from a patched copy of ``csrc/``
under ``build/`` (``gp_ns_probe.variant_library``) and prints one JSON
line.  The cases are ``chip_smoke.py``'s: the SPD batches of its main path
at 100×128 and 1600×128, for K8 the same batch drifted by 1e-3 (bf16) and
the general batch drifted by 1e-4 (split3), each from its exact inverse.

- ``occupancy``: ``ptxas -v``'s lines for the kernels of
  ``newton_schulz.cu`` (registers a thread, spill stores), for this tree
  and the baseline; for this tree's n = 128 instances also the registers
  and local memory from ``cudaFuncGetAttributes`` and the blocks an SM
  from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the shared
  memory the launch asks for (``ns_smem_bytes``).
- ``timing``: each K1 lane and K8 precision through its wrapper
  (``ns_iterate_cuda``, ``ns_refine_cuda``), as ``chip_smoke.py`` phase 5
  times it: CUDA events, median of 20 calls after warm-up.
- ``clock_split``: thread 0 of block 0 stamping ``clock64`` and
  ``%globaltimer`` after the block barriers of the load, the seed, each
  half of each round and the write (``gp_ns_probe.PHASES`` names
  them); each
  interval in µs, median of 5 launches, at the SM clock the two timers
  give.  K1 spd10 at both shapes, spd, pan and pan500 at 100×128, K8 at
  100×128.
- ``baseline`` (when ``BASELINE_CSRC``, another checkout's ``csrc/``, is
  given): K1 (every lane), K8, K6 and K11 of that checkout, built
  unpatched, against this tree's on the same inputs: whether the outputs
  are bitwise equal, the largest difference, and each timed as a bare
  launch in the order baseline, this, this, baseline.

The exit code is non-zero when K6's or K11's outputs differ from the
baseline's: those two kernels must keep their bits.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import (
    LOOP_STAMPS,
    _k6_launcher,
    _launcher,
    clock_split,
    median_ms,
    scalar_args,
    stamped_edits,
    variant_library,
)
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp, linalg
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu_torch.ops.registry import LANES

K1_LANES = ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
            "newton_schulz_pallas", "newton_schulz_pan500_pallas")

# The clock split's patches, (anchor, replacement, count) a file: the
# shared loop's (gp_ns_probe.LOOP_STAMPS) and the kernel's in
# newton_schulz.cu.
STAMPS = {
    **LOOP_STAMPS,
    "newton_schulz.cu": [
        ("  ns_load(sm, a + base, n);\n",
         "  ns_stamp(0);\n  ns_load(sm, a + base, n);\n", 1),
        ("  ns_stage(sm, n, [](int, int, float v) { return v; });\n",
         "  ns_stage(sm, n, [](int, int, float v) { return v; });\n"
         "  ns_stamp(1);\n", 1),
        ("    xb[e] = sm.Xf[(e / n) * LD + e % n];\n}\n",
         "    xb[e] = sm.Xf[(e / n) * LD + e % n];\n  __syncthreads();\n"
         "  ns_stamp(7);\n}\n", 1),
    ],
}


# Appended to this tree's newton_schulz.cu: registers, local bytes and
# blocks an SM of each n = 128 instance at its launch's shared memory.
OCCUPANCY = """
extern "C" int cmi_probe_ns_occupancy(int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(ns_mma_kernel<8, false, false>),
      reinterpret_cast<const void*>(ns_mma_kernel<8, true, false>),
      reinterpret_cast<const void*>(ns_mma_kernel<8, false, true>),
      reinterpret_cast<const void*>(ns_mma_kernel<8, true, true>)};
  const size_t smem = ns_smem_bytes(128);
  for (int k = 0; k < 4; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fns[k]);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[k],
                                                          kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[4 * k] = attr.numRegs;
    out[4 * k + 1] = static_cast<int>(attr.localSizeBytes);
    out[4 * k + 2] = blocks;
    out[4 * k + 3] = static_cast<int>(smem);
  }
  return 0;
}
"""
OCCUPANCY_KERNELS = ("K1 bf16 (ns_mma_kernel<8, false, false>)",
                     "K8 bf16 (ns_mma_kernel<8, true, false>)",
                     "K1 split3 (ns_mma_kernel<8, false, true>)",
                     "K8 split3 (ns_mma_kernel<8, true, true>)")


def _occupancy(cdll) -> dict:
    fn = cdll.cmi_probe_ns_occupancy
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 16)()
    cuda_build.check(fn(ctypes.cast(out, ctypes.c_void_p)), "occupancy")
    return {k: {"registers": out[4 * i], "local_bytes": out[4 * i + 1],
                "blocks_per_sm": out[4 * i + 2], "smem_bytes": out[4 * i + 3]}
            for i, k in enumerate(OCCUPANCY_KERNELS)}


def _cases(dev) -> dict:
    """``chip_smoke.py``'s batches: the SPD main-path batches and the
    general batches of its K8 split3 timing."""
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    return {"spd_100x128": t(make_spd_batch(100, 128,
                                            np.random.default_rng(2026))),
            "spd_1600x128": t(make_spd_batch(1600, 128,
                                             np.random.default_rng(2027))),
            "square_100x128": t(make_square_batch(
                100, 128, np.random.default_rng(2026))),
            "square_1600x128": t(make_square_batch(
                1600, 128, np.random.default_rng(2028)))}


def _drifted(a, delta: float, seed: int, symmetric: bool):
    """``a`` plus Gaussian noise of relative 2-norm ``delta`` a member
    (symmetrised for SPD input), and the exact inverse of ``a``."""
    a64 = a.double()
    noise = torch.tensor(np.random.default_rng(seed).standard_normal(
        a.shape), device=a.device)
    if symmetric:
        noise = (noise + noise.mT) / 2
    scale = (torch.linalg.matrix_norm(a64, ord=2)
             / torch.linalg.matrix_norm(noise, ord=2))
    drifted = (a64 + delta * scale[:, None, None] * noise).float()
    return drifted, torch.linalg.inv(a64).float().contiguous()


def _warm_cases(cases: dict) -> dict:
    """K8's inputs ``(a, x0, split3)`` by (precision, shape)."""
    out = {}
    for batch in (100, 1600):
        shape = f"{batch}x128"
        out[("bf16", shape)] = (*_drifted(cases[f"spd_{shape}"], 1e-3,
                                          batch, True), False)
        out[("split3", shape)] = (*_drifted(cases[f"square_{shape}"], 1e-4,
                                            batch, False), True)
    return out


def k1_launcher(cdll, a, sched):
    """A bare launch of ``cmi_ns_inverse`` at the lane's schedule, into
    the same output every call."""
    two_c, c_sq = scalar_args(cdll, sched, a.device)
    x = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)

    def run():
        cuda_build.check(cdll.cmi_ns_inverse(
            a.data_ptr(), x.data_ptr(), a.shape[0], a.shape[-1],
            int(sched.init == "spd"), sched.lo_iters, sched.hi_iters,
            int(sched.split3), int(sched.polish_highest), two_c, c_sq,
            device, stream, None), "k1")
        return x
    return run


def k8_launcher(cdll, a, x0, split3: bool):
    """A bare launch of ``cmi_ns_warm`` at the default 2 + 1 rounds, into
    the same output every call."""
    x = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)

    def run():
        cuda_build.check(cdll.cmi_ns_warm(
            a.data_ptr(), x0.data_ptr(), x.data_ptr(), a.shape[0],
            a.shape[-1], 2, 1, int(split3), device, stream), "k8")
        return x
    return run


def _ptxas(cdll) -> list:
    """``ptxas -v``'s register and spill lines for each kernel."""
    lines = cdll.compiler_log.splitlines()
    return [x.strip() for i, line in enumerate(lines)
            if "Compiling entry function" in line
            for x in lines[i:i + 4]
            if "Compiling" in x or "registers" in x or "spill" in x]


def _ab(libs: dict, make_run, what: str, card: str, must_match: bool):
    """Baseline against this tree on the same inputs: bits, the largest
    difference, and bare launches timed baseline, this, this, baseline."""
    runs = {k: make_run(v) for k, v in libs.items()}
    outs = {}
    for k, run in runs.items():
        got = run()
        outs[k] = [x.clone() for x in (got if isinstance(got, tuple)
                                       else (got,))]
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(outs["baseline"],
                                                 outs["this"]))
    diff = max(float((x - y).abs().nan_to_num(nan=np.inf).max())
               for x, y in zip(outs["baseline"], outs["this"]))
    ms = {k: [] for k in runs}
    for k in ("baseline", "this", "this", "baseline"):
        ms[k].append(median_ms(runs[k]))
    print(json.dumps({"probe": "baseline", "case": what,
                      "bitwise_equal": same, "max_abs_diff": diff,
                      "baseline_ms": ms["baseline"], "this_ms": ms["this"],
                      "card": card}), flush=True)
    return same or not must_match


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    src = cuda_build.CSRC_DIR
    units = ("newton_schulz.cu",)
    this_v = variant_library("ns_this",
                             {"newton_schulz.cu": ([], OCCUPANCY)}, src=src,
                             units=units, flags=("-Xptxas", "-v"))
    stamped = variant_library(
        "ns_stamped", stamped_edits(STAMPS, "newton_schulz.cu"), src=src,
        units=units)
    base = None
    if len(sys.argv) > 1:
        base = variant_library("ns_baseline", src=Path(sys.argv[1]),
                               units=("newton_schulz.cu", "gp.cu"),
                               flags=("-Xptxas", "-v"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"probe": "occupancy", "this": {
                          "n128": _occupancy(this_v),
                          "ptxas": _ptxas(this_v)},
                      **({"baseline": _ptxas(base)} if base else {}),
                      "card": card}), flush=True)

    cases = _cases(dev)
    warm = _warm_cases(cases)
    for shape in ("100x128", "1600x128"):
        a = cases[f"spd_{shape}"]
        for lane in K1_LANES:
            sched = LANES[lane]["schedule"]
            print(json.dumps({"probe": "timing", "kernel": "K1",
                              "lane": lane, "case": f"spd_{shape}",
                              "wrapper_ms": median_ms(
                                  lambda: ns.ns_iterate_cuda(a, sched)),
                              "card": card}), flush=True)
        for prec in ("bf16", "split3"):
            wa, x0, split3 = warm[(prec, shape)]
            print(json.dumps({"probe": "timing", "kernel": "K8",
                              "precision": prec, "case": shape,
                              "wrapper_ms": median_ms(
                                  lambda: ns.ns_refine_cuda(wa, x0, 2, 1,
                                                            split3)),
                              "card": card}), flush=True)

    splits = [(f"K1 {lane} spd_100x128",
               k1_launcher(stamped, cases["spd_100x128"],
                           LANES[lane]["schedule"])) for lane in K1_LANES]
    splits.insert(1, ("K1 newton_schulz_spd10_pallas spd_1600x128",
                      k1_launcher(stamped, cases["spd_1600x128"],
                                  LANES[K1_LANES[0]]["schedule"])))
    for prec in ("bf16", "split3"):
        wa, x0, split3 = warm[(prec, "100x128")]
        splits.append((f"K8 {prec} 100x128",
                       k8_launcher(stamped, wa, x0, split3)))
    for what, run in splits:
        print(json.dumps({"probe": "clock_split", "case": what,
                          **clock_split(stamped, run), "card": card}),
              flush=True)

    if base is None:
        return 0
    libs = {"baseline": base, "this": cuda_build.library()}
    ok = True
    for batch in (100, 1600):
        shape = f"{batch}x128"
        a = cases[f"spd_{shape}"]
        for lane in K1_LANES:
            sched = LANES[lane]["schedule"]
            ok &= _ab(libs, lambda lib: k1_launcher(lib, a, sched),
                      f"K1 {lane} spd_{shape}", card, False)
        for prec in ("bf16", "split3"):
            wa, x0, split3 = warm[(prec, shape)]
            ok &= _ab(libs, lambda lib: k8_launcher(lib, wa, x0, split3),
                      f"K8 {prec} {shape}", card, False)
        g = make_gp_batch(batch, 128, np.random.default_rng(batch))
        t = [torch.tensor(g[k], dtype=torch.float32, device=dev)
             for k in "abcde"]
        x0 = torch.linalg.inv(linalg.add_diagonal(t[1], t[2]).double()
                              ).float().contiguous()
        flat = cuda_gp._flat(*t)
        ok &= _ab(libs, lambda lib: _k6_launcher(lib, flat),
                  f"K6 gp_{shape}", card, True)
        ok &= _ab(libs, lambda lib: _launcher(lib, flat, x0),
                  f"K11 gp_{shape}", card, True)
    if not ok:
        raise SystemExit("K6 or K11 differs from the baseline's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
