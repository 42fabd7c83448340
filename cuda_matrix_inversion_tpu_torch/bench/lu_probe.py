"""Probes of the big-n LU panel kernel K9 (``csrc/lu_bign.cu``) on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.lu_probe [BASELINE_CSRC]

Each probe builds ``lu_bign.cu`` from a copy of a ``csrc/`` under
``build/`` (``gp_ns_probe.variant_library``) and prints one JSON line.
This tree's copy is patched (an occupancy reader, and clock stamps for the
split); a baseline, another checkout's ``csrc/`` such as the parent's
unpacked with ``git archive HEAD~`` under ``build/``, is built unpatched,
so any version of K9 serves as one.

- ``occupancy``: at 100×512 and 1600×256 (the first panel, pw = 64), the
  registers a thread and the local memory (spills) from
  ``cudaFuncGetAttributes`` and the blocks an SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's shared
  memory, for this tree; ``ptxas -v``'s lines for the panel kernels, for
  this tree and the baseline.
- ``baseline`` (when ``BASELINE_CSRC``, another checkout's ``csrc/``, is
  given): the blocked factor ``lu_bign.lu_factor_big`` run on each
  checkout's K9 from the same input, whether every output (the factor,
  ``perm``, every panel's pivots, L11⁻¹ and U11⁻¹) is bitwise equal, and
  K9's launches in one factor, summed, timed in the order baseline, this,
  this, baseline (CUDA events around each launch, median of 20 factors
  after warm-up).
- ``clock_split``: for the first, middle and last panel of the factor,
  block 0's thread 0 stamping ``clock64`` and ``%globaltimer`` at the
  steps of :data:`STEPS` (a step that repeats, such as a column of the
  chain, is summed over its repeats), and every thread of block 0 its own
  time in the gather of the rows outside the panel (the slowest
  thread's); each in µs, median of 5 launches of the same panel on the
  same input, at the SM clock the two timers give.  For this tree.

The exit code is non-zero when an output differs from the baseline's.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import variant_library
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_nonsym_cond,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, lu_bign

UNITS = ("lu_bign.cu",)

# Clock bookkeeping.  Thread 0 of block 0 adds the clocks since its
# previous stamp to step s (k9_step); each thread of block 0 may raise the
# slowest-thread slot 15 (k9_max); k9_finish copies the sums, and the
# globaltimer and clock at the two ends, to k9_probe.
_DEFS = """
__device__ unsigned long long k9_probe[2][16];
__shared__ unsigned long long k9_sh[17];
__device__ __forceinline__ bool k9_mine() {
  return blockIdx.x == 0 && threadIdx.x == 0;
}
__device__ __forceinline__ void k9_start() {
  if (k9_mine()) {
    for (int i = 0; i < 16; ++i) k9_sh[i] = 0;
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    k9_probe[1][0] = g;
    k9_sh[16] = clock64();
    k9_probe[1][2] = k9_sh[16];
  }
  __syncthreads();
}
__device__ __forceinline__ void k9_step(int s) {
  if (k9_mine()) {
    const unsigned long long t = clock64();
    k9_sh[s] += t - k9_sh[16];
    k9_sh[16] = t;
  }
}
__device__ __forceinline__ void k9_max(unsigned long long v) {
  if (blockIdx.x == 0) atomicMax(&k9_sh[15], v);
}
__device__ __forceinline__ void k9_finish() {
  __syncthreads();
  if (k9_mine()) {
    for (int i = 0; i < 16; ++i) k9_probe[0][i] = k9_sh[i];
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    k9_probe[1][1] = g;
    k9_probe[1][3] = clock64();
  }
}
"""
STAMP_READER = """
extern "C" int cmi_k9_stamps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, k9_probe, sizeof(k9_probe)));
}
"""
OCCUPANCY = """
extern "C" int cmi_probe_lu_occupancy(int n, int k0, int pw, int* out) {
  const void* fn = panel_kernel_for(pw);
  const size_t smem = panel_smem(n - k0, pw);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                        smem);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = blocks;
  }
  return static_cast<int>(err);
}
"""

# The steps of the split, and the (anchor, replacement, count) patches of
# lu_bign.cu that stamp them.
STEPS = ("load", "chain: candidates and barrier",
         "chain: the pivot and the row map",
         "chain: the rows' step on the block's 4 columns (thread 0's rows)",
         "write-back", "row map, ipiv and barrier",
         "diagonal block reload and perm", "gather (thread 0)",
         "triangles (thread 0's column, then the block)",
         "chain: the last barrier",
         "chain: the block's pivot rows past it and a barrier "
         "(every 4th column)",
         "chain: the columns past the block (thread 0's group, "
         "every 4th column)")
STAMPS = [
    ("#include <cstdint>\n", "#include <cstdint>\n" + _DEFS, 1),
    ("  const int q4 = pw / 4;\n",
     "  const int q4 = pw / 4;\n  k9_start();\n", 1),
    ("  cp_async_wait_all();\n  __syncthreads();\n\n  // column 0's",
     "  cp_async_wait_all();\n  __syncthreads();\n  k9_step(0);\n\n"
     "  // column 0's", 1),
    ("                static_cast<unsigned long long>(hi) << 32 | lo);\n"
     "    __syncthreads();\n",
     "                static_cast<unsigned long long>(hi) << 32 | lo);\n"
     "    __syncthreads();\n    k9_step(1);\n", 1),
    ("    const float* prow = P + sp * ld;\n    key = 0ull;\n",
     "    k9_step(2);\n    const float* prow = P + sp * ld;\n"
     "    key = 0ull;\n", 1),
    ("        *reinterpret_cast<float4*>(row + b4) = r;\n      }\n",
     "        *reinterpret_cast<float4*>(row + b4) = r;\n      }\n"
     "      k9_step(3);\n", 1),
    ("        }\n        __syncthreads();\n        // the other rows past",
     "        }\n        __syncthreads();\n        k9_step(10);\n"
     "        // the other rows past", 1),
    ("cand_key(r.x, ps, s));\n          }\n        }\n",
     "cand_key(r.x, ps, s));\n          }\n        }\n        k9_step(11);\n",
     1),
    ("      }\n    }\n  }\n  __syncthreads();\n\n  // write-back",
     "      }\n    }\n  }\n  __syncthreads();\n  k9_step(9);\n\n"
     "  // write-back", 1),
    ("  // the composed row map", "  k9_step(4);\n  // the composed row map",
     1),
    ("    ipiv[static_cast<size_t>(blockIdx.x) * pw + s] = s_ipiv[s];\n"
     "  __syncthreads();\n",
     "    ipiv[static_cast<size_t>(blockIdx.x) * pw + s] = s_ipiv[s];\n"
     "  __syncthreads();\n  k9_step(5);\n", 1),
    ("    if (t < nt) pm[s_tdst[t]] = pv[u];\n  }\n",
     "    if (t < nt) pm[s_tdst[t]] = pv[u];\n  }\n  k9_step(6);\n"
     "  const unsigned long long t_g = clock64();\n", 1),
    ("  // the triangles by column",
     "  k9_step(7);\n  k9_max(clock64() - t_g);\n  // the triangles by column",
     1),
    ("kmax, pw, ld);\n    }\n  }\n}\n",
     "kmax, pw, ld);\n    }\n  }\n  __syncthreads();\n"
     "  k9_step(8);\n  k9_finish();\n}\n", 1),
]
# The probe's cases: JAX's lu_bign_512_gate draw and chip_smoke.py's
# 1600×256 general batch.
CASES = {"nonsym500_100x512": lambda: make_nonsym_cond(
             100, 512, 500.0, np.random.default_rng(63)),
         "square_1600x256": lambda: make_square_batch(
             1600, 256, np.random.default_rng(2029)).astype(np.float32)}


def _libraries() -> dict:
    """This tree's K9, plain (with the occupancy reader) and stamped."""
    src = cuda_build.CSRC_DIR
    return {"plain": variant_library(
                "lu_this", {"lu_bign.cu": ([], OCCUPANCY)}, src=src,
                units=UNITS, flags=("-Xptxas", "-v")),
            "stamped": variant_library(
                "lu_this_stamped", {"lu_bign.cu": (STAMPS, STAMP_READER)},
                src=src, units=UNITS)}


def _ptxas(cdll) -> list:
    """``ptxas -v``'s lines for the panel kernels of ``cdll``'s build."""
    lines = cdll.compiler_log.splitlines()
    return [x.strip() for i, line in enumerate(lines)
            if "Compiling entry function" in line and "panel_kernel" in line
            for x in lines[i:i + 4]]


def panel_launcher(cdll):
    """``lu_bign.lu_panel_cuda`` on ``cdll``'s ``cmi_lu_panel``."""
    def run(work, perm, k0, pw):
        batch, n = work.shape[0], work.shape[-1]
        ipiv = torch.empty((batch, pw), dtype=torch.int32,
                           device=work.device)
        ldi = torch.empty((batch, pw, pw), device=work.device)
        udi = torch.empty_like(ldi)
        device, stream = cuda_build.launch_args(work)
        cuda_build.check(cdll.cmi_lu_panel(
            work.data_ptr(), perm.data_ptr(), ipiv.data_ptr(),
            ldi.data_ptr(), udi.data_ptr(), batch, n, k0, pw, device,
            stream), "k9")
        return ipiv, ldi, udi
    return run


def _occupancy(cdll, cases: dict) -> dict:
    fn = cdll.cmi_probe_lu_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = {}
    for case, a in cases.items():
        n = a.shape[-1]
        out = (ctypes.c_int * 3)()
        cuda_build.check(fn(n, 0, lu_bign.pick_pw(n),
                            ctypes.cast(out, ctypes.c_void_p)), "occupancy")
        res[case] = {"registers": out[0], "local_bytes": out[1],
                     "blocks_per_sm": out[2]}
    res["ptxas"] = _ptxas(cdll)
    return res


def _k9_ms(a, pw, panel) -> float:
    """K9's launches in one blocked factor of ``a``, summed (CUDA events
    around each launch)."""
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


def _median_k9_ms(a, pw, panel, calls: int = 20) -> float:
    _k9_ms(a, pw, panel)
    return statistics.median(_k9_ms(a, pw, panel) for _ in range(calls))


def _outputs(a, pw, panel) -> list:
    lu, perm, ipivs, ldis, udis = lu_bign.lu_factor_big(a, pw, panel=panel)
    return [lu, perm, *ipivs, *ldis, *udis]


def _ab(libs: dict, a, pw, case: str, card: str) -> bool:
    """Bitwise equality of every output and the timings, baseline and this
    in turns.  Prints one line; returns whether everything was equal."""
    runs = {k: panel_launcher(v) for k, v in libs.items()}
    outs = {k: _outputs(a, pw, run) for k, run in runs.items()}
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(outs["baseline"],
                                                  outs["this"]))
    ms = {k: [] for k in runs}
    for k in ("baseline", "this", "this", "baseline"):
        ms[k].append(_median_k9_ms(a, pw, runs[k]))
    print(json.dumps({"probe": "baseline", "case": case, "pw": pw,
                      "bitwise_equal": same, "baseline_ms": ms["baseline"],
                      "this_ms": ms["this"], "card": card}), flush=True)
    return same


def _snapshots(a, pw, panel) -> dict:
    """(work, perm) just before the first, middle and last panel launch."""
    n = a.shape[-1]
    want = {0: "first", (n // pw // 2) * pw: "middle", n - pw: "last"}
    snaps = {}

    def keep(work, perm, k0, pw_):
        if k0 in want:
            snaps[want[k0]] = (k0, work.clone(), perm.clone())
        return panel(work, perm, k0, pw_)

    lu_bign.lu_factor_big(a, pw, panel=keep)
    return snaps


def _clock_split(cdll, snaps: dict, pw: int) -> dict:
    """Per panel, the median over 5 launches of each step of block 0."""
    fn = cdll.cmi_k9_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    run = panel_launcher(cdll)
    stamps = (ctypes.c_ulonglong * 32)()
    res = {}
    for which, (k0, work, perm) in snaps.items():
        rows, ghz = [], []
        for _ in range(5):
            run(work.clone(), perm.clone(), k0, pw)
            torch.cuda.synchronize()
            cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)),
                             "k9 stamps")
            rate = ((stamps[19] - stamps[18])
                    / (stamps[17] - stamps[16]))  # clocks per ns
            ghz.append(rate)
            rows.append([stamps[i] / rate / 1e3
                         for i in (*range(len(STEPS)), 15)])
        med = np.median(np.array(rows), axis=0)
        res[which] = {"k0": k0, "sm_clock_ghz": float(np.median(ghz)),
                      "block_us_thread0": float(med[:-1].sum()),
                      "steps_us": dict(zip(STEPS, map(float, med[:-1]))),
                      "slowest_thread_swaps_us": float(med[-1])}
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    this = _libraries()
    libs = {"this": this["plain"]}
    if len(sys.argv) > 1:
        libs["baseline"] = variant_library(
            "lu_baseline", src=Path(sys.argv[1]), units=UNITS,
            flags=("-Xptxas", "-v"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cases = {k: torch.tensor(f(), device=dev) for k, f in CASES.items()}
    print(json.dumps({"probe": "occupancy",
                      "this": _occupancy(this["plain"], cases),
                      **({"baseline": {"ptxas": _ptxas(libs["baseline"])}}
                         if "baseline" in libs else {}),
                      "card": card}), flush=True)
    same = True
    for case, a in cases.items():
        pw = lu_bign.pick_pw(a.shape[-1])
        if "baseline" in libs:
            same &= _ab(libs, a, pw, case, card)
        snaps = _snapshots(a, pw, panel_launcher(this["plain"]))
        print(json.dumps({"probe": "clock_split", "case": case, "pw": pw,
                          **_clock_split(this["stamped"], snaps, pw),
                          "card": card}), flush=True)
    if not same:
        raise SystemExit("the baseline's K9 outputs differ from this tree's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
