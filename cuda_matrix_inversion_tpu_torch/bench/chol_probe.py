"""Probes of the Cholesky kernels K3, K4, K5 and K10 on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.chol_probe [BASELINE_CSRC]

The four kernels share ``csrc/cholesky_common.cuh`` (the panel factor and
W = L⁻¹).  Each probe builds ``cholesky.cu`` and ``gp.cu`` from a patched
copy of ``csrc/`` under ``build/`` (``gp_ns_probe.variant_library``) and
prints one JSON line:

- ``occupancy``: for K3 (``chol_inverse_kernel<8>``), K4, K5 and K10 with
  and without W at n = 128, the registers a thread and the local memory
  (spills) from ``cudaFuncGetAttributes``, the blocks an SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the kernel's shared
  memory, and ``ptxas -v``'s lines for them; for this tree, the variant
  with ``kCholPanel`` = 16, and the baseline.
- ``baseline`` (when ``BASELINE_CSRC``, another checkout's ``csrc/``, is
  given) at 100×128 and 1600×128: each kernel of that checkout against the
  same kernel of this one on the same inputs, whether every output is
  bitwise equal, and each timed in the order baseline, this, this,
  baseline (CUDA events, median of 20 bare ctypes launches after warm-up).
- ``panel``: this tree at ``kCholPanel`` = 16 against 8, the same way (the
  panel width must not change a bit).
- ``clock_split``: K3 with thread 0 of block 0 stamping ``clock64`` and
  ``%globaltimer`` after each barrier (load, factor, L⁻¹, WᵀW, write); the
  phases in µs, median of 5 launches, at the SM clock the two timers give;
  and, in the last launch, thread 0's time in each step of the factor and
  of L⁻¹, summed over the panels: the factor's first diagonal block, its
  strips, warp 0's next diagonal block and then the wait for the other
  warps' trailing tiles; L⁻¹'s owners' update and solve of a panel (thread
  0's column) and then its tiles and the wait (the last panel's solve is
  in no step).
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
    median_ms,
    variant_library,
)
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp

UNITS = ("cholesky.cu", "gp.cu")
PANEL = "constexpr int kCholPanel = 8;"
PANEL_16 = "constexpr int kCholPanel = 16;"

_PROBE_OCCUPANCY = """
static int probe_occupancy(const void* fn, size_t smem, int* out) {
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
# Appended to cholesky.cu: which 0 = K4, 1 = K3.
CHOL_OCCUPANCY = _PROBE_OCCUPANCY + """
extern "C" int cmi_probe_chol_occupancy(int which, int n, int* out) {
  const size_t m = static_cast<size_t>(n) * chol_ld(n) * sizeof(float);
  return which == 0
             ? probe_occupancy((const void*)chol_factor_kernel, m, out)
             : probe_occupancy((const void*)chol_inverse_kernel<8>, 2 * m,
                               out);
}
"""
# Appended to gp.cu: which 0 = K5, 1 = K10 without W, 2 = K10 with W.
GP_OCCUPANCY = _PROBE_OCCUPANCY + """
extern "C" int cmi_probe_gp_occupancy(int which, int n, int* out) {
  const size_t m = static_cast<size_t>(n) * chol_ld(n) * sizeof(float);
  const size_t v = 2ull * n * sizeof(float);
  if (which == 0) return probe_occupancy((const void*)gp_chol_kernel, m + v,
                                         out);
  if (which == 1)
    return probe_occupancy((const void*)gp_lml_kernel<false>, m + v, out);
  return probe_occupancy((const void*)gp_lml_kernel<true>, 2 * m + v, out);
}
"""
OCCUPANCY = {"cholesky.cu": ([], CHOL_OCCUPANCY), "gp.cu": ([], GP_OCCUPANCY)}
# (name, function, which, kernel symbol as ptxas prints it, in part)
KERNELS = (("K4", "cmi_probe_chol_occupancy", 0, "chol_factor_kernel"),
           ("K3", "cmi_probe_chol_occupancy", 1, "chol_inverse_kernelILi8E"),
           ("K5", "cmi_probe_gp_occupancy", 0, "gp_chol_kernel"),
           ("K10", "cmi_probe_gp_occupancy", 1, "gp_lml_kernelILb0E"),
           ("K10_emit_w", "cmi_probe_gp_occupancy", 2, "gp_lml_kernelILb1E"))

# The clock split's patches of cholesky.cu: (anchor, replacement, count).
_STAMP_DEFS = """#include "cholesky_common.cuh"

__device__ unsigned long long chol_stamps[2][8];
__device__ int chol_next;
__device__ __forceinline__ void chol_stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0 && chol_next < 8) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    chol_stamps[0][chol_next] = clock64();
    chol_stamps[1][chol_next++] = g;
  }
}
"""
STAMPS = [
    ('#include "cholesky_common.cuh"\n', _STAMP_DEFS, 1),
    ("  const int tid = threadIdx.x;\n  load_matrix(a, L, n, ld);\n"
     "  __syncthreads();\n  chol_factor(L, n, CholSquare{ld});\n"
     "  chol_tri_inverse(L, W, n, ld);  // W = L^-1 by row panels\n"
     "  __syncthreads();\n",
     "  const int tid = threadIdx.x;\n"
     "  if (blockIdx.x == 0 && tid == 0) chol_next = 0;\n  chol_stamp();\n"
     "  load_matrix(a, L, n, ld);\n  __syncthreads();\n  chol_stamp();\n"
     "  chol_step(-1);\n"
     "  chol_factor(L, n, CholSquare{ld});\n  chol_stamp();\n"
     "  chol_tri_inverse(L, W, n, ld);\n  __syncthreads();\n"
     "  chol_stamp();\n", 1),
    ("      for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], "
     "acc[r][c]);\n  }\n",
     "      for (int c = 0; c < M; ++c) acc[r][c] = fmaf(p[r], q[c], "
     "acc[r][c]);\n  }\n  __syncthreads();\n  chol_stamp();\n", 1),
    ("      if (i < n && j < n) inv[base + i * n + j] = acc[r][c];\n"
     "    }\n}\n",
     "      if (i < n && j < n) inv[base + i * n + j] = acc[r][c];\n"
     "    }\n  __syncthreads();\n  chol_stamp();\n"
     "  if (blockIdx.x == 0 && tid == 0)\n"
     "    for (int i = 0; i < 16; ++i) chol_step_clocks[i] = chol_step_sh[i];\n"
     "}\n", 1),
]
STAMP_READER = """
extern "C" int cmi_chol_stamps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, chol_stamps, sizeof(chol_stamps)));
}
extern "C" int cmi_chol_steps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, chol_step_clocks, sizeof(chol_step_clocks)));
}
"""
PHASES = ("load", "factor", "L^-1", "W^T W", "write")
# The same split inside the two functions of cholesky_common.cuh: thread 0
# of block 0 adds the clocks since the previous barrier to its step's sum.
_STEP_DEFS = """__device__ unsigned long long chol_step_clocks[16];
// the 16 sums and the last clock, in shared memory (padded to 16 bytes)
__shared__ unsigned long long chol_step_sh[18];
__device__ __forceinline__ void chol_step(int s) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long t = clock64();
    if (s >= 0) {
      chol_step_sh[s] += t - chol_step_sh[16];
    } else {
      for (int i = 0; i < 16; ++i) chol_step_sh[i] = 0;
    }
    chol_step_sh[16] = t;
  }
}

"""
STEPS = [
    ("// A trailing-update tile: 64 rows",
     _STEP_DEFS + "// A trailing-update tile: 64 rows", 1),
    ("n <= NB, lay);\n  __syncthreads();\n",
     "n <= NB, lay);\n  __syncthreads();\n  chol_step(0);\n", 1),
    ("a[h + 3]);\n    }\n    __syncthreads();\n",
     "a[h + 3]);\n    }\n    __syncthreads();\n    chol_step(1);\n", 1),
    ("      lrr = chol_diag_block<NB>(K, k1, k2 - k1, k0, k2 == n, lay);\n",
     "      lrr = chol_diag_block<NB>(K, k1, k2 - k1, k0, k2 == n, lay);\n"
     "      chol_step(2);\n", 1),
    ("        t -= cols;\n      }\n    }\n    __syncthreads();\n",
     "        t -= cols;\n      }\n    }\n    __syncthreads();\n"
     "    chol_step(3);\n", 1),
    ("        prev[r] = w[r];\n      }\n    }\n",
     "        prev[r] = w[r];\n      }\n    }\n    chol_step(4);\n", 1),
    ("    __syncwarp();\n  }\n  // b[i][j] (j <= i) holds",
     "    __syncwarp();\n  }\n  chol_step(6);\n  // b[i][j] (j <= i) holds", 1),
    ("  __syncwarp();  // every lane has read the block",
     "  chol_step(7);\n  __syncwarp();  // every lane has read the block", 1),
    ("__fmul_rn(lp[kk], prev[kk]));\n        }\n      }\n",
     "__fmul_rn(lp[kk], prev[kk]));\n        }\n      }\n      chol_step(8);\n",
     1),
    ("    if (k1 < n) __syncthreads();\n",
     "    if (k1 < n) {\n      __syncthreads();\n      chol_step(5);\n    }\n",
     1),
]
STEP_NAMES = ("factor: first diagonal block's stores and barrier",
              "factor: strips",
              "factor: warp 0's stores of the next diagonal block",
              "factor: then waiting for the trailing tiles",
              "L^-1: owners' chain of the panel's rows and stores (thread 0)",
              "L^-1: then tiles and waiting",
              "factor: warp 0's update of a diagonal block by its panel",
              "factor: warp 0's factor of a diagonal block (all blocks)",
              "L^-1: owners' loads, and the previous panel's rows applied "
              "(thread 0)")


def _occupancy(cdll) -> dict:
    """Registers a thread, spill bytes and blocks an SM of each kernel at
    n = 128, with ``ptxas -v``'s lines for it."""
    lines = cdll.compiler_log.splitlines()
    res = {}
    for name, fn_name, which, symbol in KERNELS:
        fn = getattr(cdll, fn_name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        cuda_build.check(fn(which, 128, ctypes.cast(out, ctypes.c_void_p)),
                         f"{name} occupancy")
        ptxas = []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and symbol in line:
                ptxas = [x.strip() for x in lines[i + 1:i + 4]]
                break
        res[name] = {"registers": out[0], "local_bytes": out[1],
                     "blocks_per_sm": out[2], "ptxas": ptxas}
    return res


def _inputs(batch: int, dev) -> dict:
    """The same inputs for every library: an SPD batch (K3, K4) and GP
    systems (K5, K10), n = 128."""
    a = torch.tensor(make_spd_batch(batch, 128,
                                    np.random.default_rng(batch)),
                     dtype=torch.float32, device=dev)
    g = make_gp_batch(batch, 128, np.random.default_rng(batch + 1))
    flat = cuda_gp._flat(*(torch.tensor(g[k], dtype=torch.float32,
                                        device=dev) for k in "abcde"))
    return {"a": a, "flat": flat}


def _launchers(cdll, x: dict) -> dict:
    """Bare ctypes launches of K3, K4, K5 and K10 (both variants) into
    output buffers of their own; each returns its outputs."""
    a = x["a"]
    ga, gb, gc, gd, ge = x["flat"]
    batch, n = a.shape[0], a.shape[-1]
    device, stream = cuda_build.launch_args(a)
    inv, l = torch.empty_like(a), torch.empty_like(a)
    out5 = torch.empty((batch, 2), device=a.device)
    out10 = torch.empty((batch, 2), device=a.device)
    out10w = torch.empty((batch, 2), device=a.device)
    w, alpha = torch.empty_like(gb), torch.empty_like(gc)

    def k3():
        cuda_build.check(cdll.cmi_chol_inverse(
            a.data_ptr(), inv.data_ptr(), batch, n, device, stream), "k3")
        return (inv,)

    def k4():
        cuda_build.check(cdll.cmi_chol_factor(
            a.data_ptr(), l.data_ptr(), batch, n, device, stream), "k4")
        return (l,)

    def k5():
        cuda_build.check(cdll.cmi_gp_fused(
            ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), gd.data_ptr(),
            ge.data_ptr(), out5.data_ptr(), batch, n, device, stream), "k5")
        return (out5,)

    def k10():
        cuda_build.check(cdll.cmi_gp_lml(
            gb.data_ptr(), gc.data_ptr(), gd.data_ptr(), out10.data_ptr(),
            None, None, batch, n, 0, device, stream), "k10")
        return (out10,)

    def k10w():
        cuda_build.check(cdll.cmi_gp_lml(
            gb.data_ptr(), gc.data_ptr(), gd.data_ptr(), out10w.data_ptr(),
            w.data_ptr(), alpha.data_ptr(), batch, n, 1, device, stream),
            "k10 emit_w")
        return (out10w, w, alpha)

    return {"K3": k3, "K4": k4, "K5": k5, "K10": k10, "K10_emit_w": k10w}


def _ab(libs: dict, x: dict, case: str, card: str, probe: str) -> bool:
    """``libs`` = {"baseline" or "panel_16": cdll, "this": cdll}: per
    kernel, bitwise equality and times in the order other, this, this,
    other.  Prints one line; returns whether every output was equal."""
    other = next(k for k in libs if k != "this")
    runs = {k: _launchers(v, x) for k, v in libs.items()}
    rows, all_same = {}, True
    for name in runs["this"]:
        outs = {k: [t.clone() for t in runs[k][name]()] for k in libs}
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(outs[other],
                                                      outs["this"]))
        all_same &= same
        ms = {k: [] for k in libs}
        for k in (other, "this", "this", other):
            ms[k].append(median_ms(runs[k][name]))
        rows[name] = {"bitwise_equal": same, f"{other}_ms": ms[other],
                      "this_ms": ms["this"]}
    print(json.dumps({"probe": probe, "case": case, "kernels": rows,
                      "card": card}), flush=True)
    return all_same


def _clock_split(cdll, x: dict) -> dict:
    """Median over 5 launches of K3 of each phase of block 0, in µs."""
    fn = cdll.cmi_chol_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    run = _launchers(cdll, x)["K3"]
    stamps = (ctypes.c_ulonglong * 16)()
    phases, ghz = [], []
    for _ in range(5):
        run()
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)),
                         "k3 stamps")
        clk = np.array(stamps[:len(PHASES) + 1], dtype=np.float64)
        ns = np.array(stamps[8:9 + len(PHASES)], dtype=np.float64)
        rate = (clk[-1] - clk[0]) / (ns[-1] - ns[0])  # clocks per ns
        ghz.append(rate)
        phases.append(np.diff(clk) / rate / 1e3)
    med = np.median(np.array(phases), axis=0)
    steps_fn = cdll.cmi_chol_steps
    steps_fn.argtypes = [ctypes.c_void_p]
    steps_fn.restype = ctypes.c_int
    steps = (ctypes.c_ulonglong * 16)()
    cuda_build.check(steps_fn(ctypes.cast(steps, ctypes.c_void_p)),
                     "k3 steps")
    rate = float(np.median(ghz))
    return {"sm_clock_ghz": rate, "block_us": float(med.sum()),
            "phases_us": dict(zip(PHASES, map(float, med))),
            "steps_us_last_launch": {
                name: steps[i] / rate / 1e3
                for i, name in enumerate(STEP_NAMES)}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    ptxas = ("-Xptxas", "-v")
    libs = {"this": variant_library("chol_this", OCCUPANCY, units=UNITS,
                                    flags=ptxas)}
    libs["panel_16"] = variant_library(
        "chol_panel_16", {**OCCUPANCY, "cholesky_common.cuh": (
            [(PANEL, PANEL_16, 1)], "")}, units=UNITS, flags=ptxas)
    if len(sys.argv) > 1:
        libs["baseline"] = variant_library(
            "chol_baseline", OCCUPANCY, src=Path(sys.argv[1]), units=UNITS,
            flags=ptxas)
    stamped = variant_library(
        "chol_stamped", {"cholesky.cu": (STAMPS, STAMP_READER),
                         "cholesky_common.cuh": (STEPS, "")},
        units=("cholesky.cu",))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"probe": "occupancy", "n": 128,
                      **{k: _occupancy(v) for k, v in libs.items()},
                      "card": card}), flush=True)
    same = True
    for batch in (100, 1600):
        case = f"{batch}x128"
        x = _inputs(batch, dev)
        if "baseline" in libs:
            same &= _ab({"baseline": libs["baseline"], "this": libs["this"]},
                        x, case, card, "baseline")
        same &= _ab({"panel_16": libs["panel_16"], "this": libs["this"]}, x,
                    case, card, "panel")
        print(json.dumps({"probe": "clock_split", "kernel": "K3",
                          "case": case, **_clock_split(stamped, x),
                          "card": card}), flush=True)
    if not same:
        raise SystemExit("a variant's outputs differ from this tree's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
