"""Probes of kernels K6 and K11 (``csrc/gp.cu::gp_ns_kernel``,
``gp_warm_kernel``) on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe [BASELINE_CSRC]

Each probe builds a variant of ``gp.cu`` from a patched copy of ``csrc/``
under ``build/`` and prints one JSON line a shape (GP systems at 100×128
and 1600×128, K11 at its default 2 + 1 rounds):

- ``x0_load``: K11 reads X0 from device memory straight into the
  accumulator fragments while B's asynchronous copies are in flight
  ("direct", the shipped kernel).  The alternative ("staged") copies X0
  into shared memory with ``cp.async`` once K has left the staging space
  and loads the fragments from there.  Both must give the same bits; each
  is timed in the order direct, staged, staged, direct (CUDA events,
  median of 20 calls after warm-up, each a bare ctypes launch), then the
  direct one into fresh output tensors each call, a ``torch.empty_like``
  of X0 alone, and the direct one through its Python wrapper
  ``gp_fused_warm_cuda``.
- ``clock_split``: the shipped kernel with thread 0 of block 0 stamping
  ``clock64`` and ``%globaltimer`` after each phase (each stamp follows a
  block barrier); the phases in µs, median of 5 launches, at the SM clock
  the two timers give over the block.  The round loop's stamps
  (:data:`LOOP_STAMPS`, in ``ns_mma_rounds.cuh``) serve
  ``bench/ns_probe.py`` too; :data:`PHASES` names them.
- ``k6_baseline`` (when ``BASELINE_CSRC``, another checkout's ``csrc/``, is
  given): K6 of that checkout against K6 of this one on the same inputs,
  whether they give the same bits, and each timed in the order baseline,
  this, this, baseline.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.io.fixtures import make_gp_batch
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp, linalg

DIRECT = """  gp_ns_load_b<M>(sm, a, b + sys * n * n, d, sys, n);
  const WarpTile w = warp_tile<NP>();
  float xm[G::kMT][G::kNT][4];
  if (w.active)
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      v = (i < n && j < n) ? xs[i * n + j] : 0.f;
    });
  gp_ns_stage_k<M>(sm, c + sys * n, n);
"""
STAGED = """  gp_ns_load_b<M>(sm, a, b + sys * n * n, d, sys, n);
  gp_ns_stage_k<M>(sm, c + sys * n, n);
  const int nn = n * n;
  if ((nn & 3) == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
    for (int x = 4 * threadIdx.x; x < nn; x += 4 * kThreads)
      cp_async16(sm.stage + x, xs + x);
  } else {
    for (int x = threadIdx.x; x < nn; x += kThreads)
      cp_async4(sm.stage + x, xs + x);
  }
  cp_async_wait_all();
  __syncthreads();
  const WarpTile w = warp_tile<NP>();
  float xm[G::kMT][G::kNT][4];
  if (w.active)
    tile_for_each(xm, w, [&](int i, int j, float& v) {
      v = (i < n && j < n) ? sm.stage[i * n + j] : 0.f;
    });
"""


# The clock split's bookkeeping, patched into ns_common.cuh (which every
# Newton-Schulz kernel includes first): thread 0 of block 0 records
# (clock64, globaltimer, id) at each ns_stamp(id); id 0 restarts the
# record.  PHASES names the interval that ends at stamp id k.
STAMP_DEFS = """#pragma once

static __device__ unsigned long long ns_probe_t[3][48];
static __device__ int ns_probe_next;
__device__ __forceinline__ void ns_stamp(int id) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (id == 0) ns_probe_next = 0;
    const int k = ns_probe_next;
    if (k < 48) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      ns_probe_t[0][k] = clock64();
      ns_probe_t[1][k] = g;
      ns_probe_t[2][k] = id;
      ns_probe_next = k + 1;
    }
  }
}
"""
STAMP_READER = """
extern "C" int cmi_ns_stamps(unsigned long long* host, int* count) {
  cudaError_t err = cudaMemcpyFromSymbol(host, ns_probe_t, sizeof(ns_probe_t));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(count, ns_probe_next, sizeof(int));
  return static_cast<int>(err);
}
"""
PHASES = {1: "load and stage A (K8, K11: X0's loads issued)",
          2: "seed or X0 into X, publish X",
          3: "lo round: T = 2cI - c^2 AX", 4: "lo round: X = XT, publish X",
          5: "hi round: R = I - AX", 6: "hi round: X = X + XR, publish X",
          7: "write X", 8: "epilogue (mean, var)", 9: "write K^-1"}
# The stamps of the shared tensor-core round loop, (anchor, replacement,
# count) a file.
LOOP_STAMPS = {
    "ns_common.cuh": [("#pragma once\n", STAMP_DEFS, 1)],
    "ns_mma_rounds.cuh": [
        ("  publish(0);\n", "  publish(0);\n  ns_stamp(2);\n", 1),
        ("    __syncthreads();\n    if (w.active) {\n      if constexpr (SPLIT3)\n"
         "        mma_split3<NP>(xm,",
         "    __syncthreads();\n    ns_stamp(3);\n    if (w.active) {\n"
         "      if constexpr (SPLIT3)\n        mma_split3<NP>(xm,", 1),
        ("        mma_tiles<NP>(xm, sXh, sT, w);\n    }\n    publish(r + 1);\n",
         "        mma_tiles<NP>(xm, sXh, sT, w);\n    }\n    publish(r + 1);\n"
         "    ns_stamp(4);\n", 1),
        ("      store_tile_bf16(acc, sT, LDB, w);\n    }\n    __syncthreads();\n"
         "    if (w.active) {\n",
         "      store_tile_bf16(acc, sT, LDB, w);\n    }\n    __syncthreads();\n"
         "    ns_stamp(5);\n    if (w.active) {\n", 1),
        ("            xm[m][j][q] = __fadd_rn(xm[m][j][q], acc[m][j][q]);\n    }\n"
         "    publish(r + 1);\n",
         "            xm[m][j][q] = __fadd_rn(xm[m][j][q], acc[m][j][q]);\n    }\n"
         "    publish(r + 1);\n    ns_stamp(6);\n", 1),
    ],
}
# K11's clock split: the loop's stamps and K11's own in gp.cu.
STAMPS = {**LOOP_STAMPS, "gp.cu": [
    ("  const float* xs = x0 + sys * n * n;\n",
     "  const float* xs = x0 + sys * n * n;\n  ns_stamp(0);\n", 1),
    ("  gp_ns_stage_k<M>(sm, c + sys * n, n);\n\n  ns_mma_rounds",
     "  gp_ns_stage_k<M>(sm, c + sys * n, n);\n  ns_stamp(1);\n\n"
     "  ns_mma_rounds", 1),
    ("  ns_gp_epilogue<M>(sm.Xf, sm.rest, n, e[sys], out + 2 * sys, red);\n"
     "  float* ks",
     "  ns_gp_epilogue<M>(sm.Xf, sm.rest, n, e[sys], out + 2 * sys, red);\n"
     "  ns_stamp(8);\n  float* ks", 1),
    ("    ks[x] = sm.Xf[(x / n) * LD + x % n];\n}\n",
     "    ks[x] = sm.Xf[(x / n) * LD + x % n];\n  __syncthreads();\n"
     "  ns_stamp(9);\n}\n", 1),
]}


def stamped_edits(stamps: dict, reader_unit: str) -> dict:
    """``variant_library`` edits for a clock split: ``stamps``' patches,
    with the stamp reader appended to ``reader_unit``."""
    return {f: (p, STAMP_READER if f == reader_unit else "")
            for f, p in stamps.items()}


def variant_library(name: str, edits=None, src: Path = cuda_build.CSRC_DIR,
                    units=("gp.cu",), flags=()) -> ctypes.CDLL:
    """Build ``units`` into one library from a copy of ``src`` under
    ``build/``.  ``edits`` maps a unit's file name to ``(patches, tail)``:
    each patch (anchor, replacement, count) must match ``count`` times, and
    ``tail`` is appended.  Every entry point of ``cuda_build._SIGNATURES``
    that the library holds gets its C signature; with extra ``flags`` (say
    ``-Xptxas -v``) the compiler's output is kept as ``.compiler_log``."""
    variant = cuda_build.BUILD_DIR / f"probe_{name}" / "csrc"
    shutil.rmtree(variant.parent, ignore_errors=True)
    shutil.copytree(src, variant)
    for unit, (patches, tail) in (edits or {}).items():
        path = variant / unit
        text = path.read_text()
        for anchor, new, count in patches:
            if text.count(anchor) != count:
                raise RuntimeError(f"{unit} no longer holds {anchor!r} "
                                   f"{count} time(s): update this probe's "
                                   f"patches")
            text = text.replace(anchor, new)
        path.write_text(text + tail)
    lib = variant.parent / f"libprobe_{name}.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-shared",
           "-o", str(lib), *(str(variant / u) for u in units)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed ({log.returncode}): {' '.join(cmd)}"
                           f"\n{log.stdout}{log.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for fn_name, argtypes in cuda_build._SIGNATURES.items():
        if hasattr(cdll, fn_name):
            fn = getattr(cdll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    cdll.compiler_log = log.stdout + log.stderr
    return cdll


def _launcher(cdll, flat, x0, fresh: bool = False):
    """A bare launch of ``cmi_gp_fused_warm``: into the same output
    buffers every call, or (``fresh``) into new ones from the caching
    allocator, as the wrapper does."""
    a, b, c, d, e = flat
    out = torch.empty((b.shape[0], 2), device=b.device)
    kinv = torch.empty_like(x0)
    device, stream = cuda_build.launch_args(b)

    def run():
        nonlocal out, kinv
        if fresh:
            out, kinv = torch.empty_like(out), torch.empty_like(kinv)
        cuda_build.check(cdll.cmi_gp_fused_warm(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            e.data_ptr(), out.data_ptr(), b.shape[0], b.shape[-1],
            x0.data_ptr(), kinv.data_ptr(), 2, 1, device, stream), "k11")
        return out, kinv
    return run


def _k6_launcher(cdll, flat):
    """A bare launch of K6 (``cmi_gp_fused_ns``) at its schedule."""
    a, b, c, d, e = flat
    sched = cuda_gp.GP_NS_SCHEDULE
    lo = sched.lo_iters
    two_c = (ctypes.c_float * lo)(*[2.0 * c_ for c_ in sched.coeffs])
    c_sq = (ctypes.c_float * lo)(*[c_ * c_ for c_ in sched.coeffs])
    out = torch.empty((b.shape[0], 2), device=b.device)
    device, stream = cuda_build.launch_args(b)

    def run():
        cuda_build.check(cdll.cmi_gp_fused_ns(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            e.data_ptr(), out.data_ptr(), b.shape[0], b.shape[-1], lo,
            sched.hi_iters, ctypes.cast(two_c, ctypes.c_void_p),
            ctypes.cast(c_sq, ctypes.c_void_p), device, stream), "k6")
        return out
    return run


def median_ms(fn, calls: int = 20, warmup: int = 3) -> float:
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


def clock_split(cdll, run) -> dict:
    """Block 0's intervals between stamps, median over 5 launches of
    ``run``, in µs at the SM clock the two timers give: in order, and
    summed by phase."""
    fn = cdll.cmi_ns_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stamps = (ctypes.c_ulonglong * (3 * 48))()
    count = ctypes.c_int()
    seqs, ghz = [], []
    for _ in range(5):
        run()
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p),
                            ctypes.byref(count)), "ns stamps")
        c = min(count.value, 48)
        clk = np.array(stamps[:c], dtype=np.float64)
        ns = np.array(stamps[48:48 + c], dtype=np.float64)
        rate = (clk[-1] - clk[0]) / (ns[-1] - ns[0])  # clocks per ns
        ghz.append(rate)
        seqs.append((list(stamps[96:96 + c]), np.diff(clk) / rate / 1e3))
    ids = seqs[0][0]
    if any(s[0] != ids for s in seqs):
        raise RuntimeError("the stamps differ between launches")
    med = np.median(np.array([s[1] for s in seqs]), axis=0)
    by_phase = {}
    for k, us in zip(ids[1:], med):
        by_phase[PHASES[k]] = by_phase.get(PHASES[k], 0.0) + float(us)
    return {"sm_clock_ghz": float(np.median(ghz)),
            "block_us": float(med.sum()), "by_phase_us": by_phase,
            "sequence_us": [[PHASES[k], float(us)]
                            for k, us in zip(ids[1:], med)]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    libs = {"direct": cuda_build.library(),
            "staged": variant_library(
                "staged", {"gp.cu": ([(DIRECT, STAGED, 1)], "")})}
    stamped = variant_library("stamped", stamped_edits(STAMPS, "gp.cu"))
    k6_libs = None
    if len(sys.argv) > 1:
        k6_libs = {"baseline": variant_library("baseline",
                                               src=Path(sys.argv[1])),
                   "this": libs["direct"]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    failed = False
    for batch in (100, 1600):
        case = f"gp_{batch}x128"
        g = make_gp_batch(batch, 128, np.random.default_rng(batch))
        t = [torch.tensor(g[k], dtype=torch.float32, device=dev)
             for k in "abcde"]
        # contiguous, as the kernel reads it (torch.linalg.inv returns
        # column-major batches)
        x0 = torch.linalg.inv(linalg.add_diagonal(t[1], t[2]).double()
                              ).float().contiguous()
        flat = cuda_gp._flat(*t)
        runs = {k: _launcher(v, flat, x0) for k, v in libs.items()}
        outs = {k: [x.clone() for x in run()] for k, run in runs.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(outs["direct"],
                                                     outs["staged"]))
        failed |= not same
        ms = {k: [] for k in runs}
        for k in ("direct", "staged", "staged", "direct"):
            ms[k].append(median_ms(runs[k]))
        fresh_ms = median_ms(_launcher(libs["direct"], flat, x0, fresh=True))
        empty_ms = median_ms(lambda: torch.empty_like(x0))
        wrapper_ms = median_ms(lambda: cuda_gp.gp_fused_warm_cuda(*flat, x0))
        print(json.dumps({"probe": "x0_load", "case": case,
                          "direct_ms": ms["direct"],
                          "staged_ms": ms["staged"], "bitwise_equal": same,
                          "direct_fresh_outputs_ms": fresh_ms,
                          "empty_like_x0_ms": empty_ms,
                          "direct_through_wrapper_ms": wrapper_ms,
                          "card": card}), flush=True)
        print(json.dumps({"probe": "clock_split", "case": case,
                          **clock_split(stamped, _launcher(stamped, flat,
                                                           x0)),
                          "card": card}), flush=True)
        if k6_libs:
            k6 = {k: _k6_launcher(v, flat) for k, v in k6_libs.items()}
            k6_out = {k: run().clone() for k, run in k6.items()}
            torch.cuda.synchronize()
            k6_same = torch.equal(k6_out["baseline"], k6_out["this"])
            failed |= not k6_same
            k6_ms = {k: [] for k in k6}
            for k in ("baseline", "this", "this", "baseline"):
                k6_ms[k].append(median_ms(k6[k]))
            print(json.dumps({"probe": "k6_baseline", "case": case,
                              "baseline_ms": k6_ms["baseline"],
                              "this_ms": k6_ms["this"],
                              "bitwise_equal": k6_same, "card": card}),
                  flush=True)
    if failed:
        raise SystemExit("a variant disagrees with the shipped kernel")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
