"""Probes of the batched LU inverse kernel K2 (``csrc/lu.cu``) on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.lu_small_probe [BASELINE_CSRC]

Each probe builds ``lu.cu`` from a copy of a ``csrc/`` under ``build/``
(``gp_ns_probe.variant_library``) and prints one JSON line.  This tree's
copy is patched (an occupancy reader, and clock stamps for the split); a
baseline, another checkout's ``csrc/`` such as the parent's unpacked with
``git archive HEAD~`` under ``build/``, is built unpatched, so any version
of K2 serves as one.

- ``occupancy``: for each template instance (n ∈ :data:`OCC_N`, and at
  n = 128 both the instance for one wave and the one capped to two blocks
  an SM), the registers a thread and the local memory (spills) from
  ``cudaFuncGetAttributes`` and the blocks an SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's
  shared memory, for this tree; ``ptxas -v``'s lines for K2, for this
  tree and the baseline.
- ``instances``: the two n = 128 instances against each other, bits and
  bare timings in the order one, two, two, one.
- ``baseline`` (when ``BASELINE_CSRC`` is given): both checkouts' K2 on
  the same inputs (:data:`CASES`), whether ``inv`` and ``ipiv`` are
  bitwise equal on the finite members and non-finite on the same ones,
  and each timed as a bare launch in the order baseline, this, this,
  baseline (CUDA events around each launch, median of 20 after warm-up).
- ``wrapper``: this tree's K2 through ``cuda_lu.lu_inverse_cuda`` (what
  ``chip_smoke.py`` times), median of 20.
- ``clock_split``: two threads of block 0, thread 0 and the last one,
  stamping ``clock64`` (thread 0 also ``%globaltimer``) at the steps of
  :data:`STEPS` (a step that repeats, such as a pivot column, is summed
  over its repeats); each in µs, median of 5 launches of the whole batch,
  at the SM clock the two timers give.  For this tree.

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
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_lu

UNITS = ("lu.cu",)

# Clock bookkeeping.  Two observers in block 0, thread 0 (one of the
# threads that factor each panel; row group 0, quad 0) and the last thread
# (row group 7, the last quad: the trailing updates' worker), each add the clocks since their previous
# stamp to step s (k2_step); k2_finish closes the last step after a
# barrier and copies both rows of sums, and the globaltimer and clock at
# the two ends, to k2_probe.
_DEFS = """
__device__ unsigned long long k2_probe[3][16];
__shared__ unsigned long long k2_sh[2][17];
__device__ __forceinline__ int k2_obs() {
  if (blockIdx.x != 0) return -1;
  return threadIdx.x == 0 ? 0 : threadIdx.x == blockDim.x - 1 ? 1 : -1;
}
__device__ __forceinline__ void k2_start() {
  const int o = k2_obs();
  if (o >= 0) {
    for (int i = 0; i < 16; ++i) k2_sh[o][i] = 0;
    k2_sh[o][16] = clock64();
    if (o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      k2_probe[2][0] = g;
      k2_probe[2][2] = k2_sh[0][16];
    }
  }
}
__device__ __forceinline__ void k2_step(int s) {
  const int o = k2_obs();
  if (o >= 0) {
    const unsigned long long t = clock64();
    k2_sh[o][s] += t - k2_sh[o][16];
    k2_sh[o][16] = t;
  }
}
__device__ __forceinline__ void k2_finish(int s) {
  __syncthreads();
  const int o = k2_obs();
  if (o >= 0) {
    k2_step(s);
    for (int i = 0; i < 16; ++i) k2_probe[o][i] = k2_sh[o][i];
    if (o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      k2_probe[2][1] = g;
      k2_probe[2][3] = clock64();
    }
  }
}
"""
STAMP_READER = """
extern "C" int cmi_k2_stamps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, k2_probe, sizeof(k2_probe)));
}
"""
OCCUPANCY = """
extern "C" int cmi_probe_k2_occupancy(int n, int pair, int* out) {
  const void* fn = lu_kernel_for(n, pair != 0);
  const size_t smem = lu_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, lu_threads(n, pair != 0), smem);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = blocks;
    out[3] = lu_threads(n, pair != 0);
    out[4] = static_cast<int>(smem);
  }
  return static_cast<int>(err);
}
extern "C" int cmi_probe_k2_launch(const float* a, float* inv, int* ipiv,
                                   int batch, int n, int pair, void* stream) {
  const void* fn = lu_kernel_for(n, pair != 0);
  const size_t smem = lu_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a, &inv, &ipiv, &n};
  return static_cast<int>(cudaLaunchKernel(
      fn, dim3(batch), dim3(lu_threads(n, pair != 0)), args, smem,
      static_cast<cudaStream_t>(stream)));
}
"""
# One n a template instance (NP = 16, 32, 64, 128).
OCC_N = (16, 32, 64, 128)

# The steps of the split, and the (anchor, replacement, count) patches of
# lu.cu that stamp them.
STEPS = ("load and tables",
         "factor: the barrier before a panel (waiting on the panel end)",
         "factor: the panel threads factor the panel (4 columns)",
         "factor: the barrier after the panel",
         "factor: the rows that move staged",
         "factor: their barrier",
         "factor: U12",
         "factor: the panel end (rows taken, the 4 steps on the tile, quad "
         "g reloaded, quad g + 1 published)",
         "factors stored by position and barrier",
         "forward substitution", "back substitution", "write")
STAMPS = [
    ("#include <cstdint>\n", "#include <cstdint>\n" + _DEFS, 1),
    ("  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n",
     "  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n"
     "  k2_start();\n", 1),
    ("      for (int r = 0; r < kRB; ++r) st4(P + 4 * row_of(q, r), w[q][r]);\n"
     "  }\n",
     "      for (int r = 0; r < kRB; ++r) st4(P + 4 * row_of(q, r), w[q][r]);\n"
     "  }\n  k2_step(0);\n", 1),
    ("    float* Pg = P + (g & 1) * 4 * NP;\n    __syncthreads();\n",
     "    float* Pg = P + (g & 1) * 4 * NP;\n    __syncthreads();\n"
     "    k2_step(1);\n", 1),
    ("                                  s_piv_slot + k0, s_sj + k0);\n"
     "    __syncthreads();\n",
     "                                  s_piv_slot + k0, s_sj + k0);\n"
     "    k2_step(2);\n    __syncthreads();\n    k2_step(3);\n", 1),
    ("    if (tid < 8) s_perm_st[tid] = s_perm[tid < 4 ? psl[tid] : k0 + tid - 4];"
     "\n    __syncthreads();\n",
     "    if (tid < 8) s_perm_st[tid] = s_perm[tid < 4 ? psl[tid] : k0 + tid - 4];"
     "\n    k2_step(4);\n    __syncthreads();\n    k2_step(5);\n", 1),
    ("      u[3] = step4(step4(step4(u[3], lp[3].x, u[0]), lp[3].y, u[1]), lp[3].z,"
     "\n                   u[2]);\n    }\n",
     "      u[3] = step4(step4(step4(u[3], lp[3].x, u[0]), lp[3].y, u[1]), lp[3].z,"
     "\n                   u[2]);\n    }\n    k2_step(6);\n", 1),
    ("            w[q][r] = ld4(Pg + 4 * src);\n        }\n      }\n    }\n  }\n",
     "            w[q][r] = ld4(Pg + 4 * src);\n        }\n      }\n    }\n"
     "    k2_step(7);\n  }\n", 1),
    ("    for (int r = 0; r < kRB; ++r) st4(W + row_of(q, r) * kLd + c0, w[q][r]);"
     "\n  __syncthreads();\n",
     "    for (int r = 0; r < kRB; ++r) st4(W + row_of(q, r) * kLd + c0, w[q][r]);"
     "\n  __syncthreads();\n  k2_step(8);\n", 1),
    ("    __syncthreads();\n  }\n\n  // Y = U^-1 Y by blocks",
     "    __syncthreads();\n  }\n  k2_step(9);\n\n  // Y = U^-1 Y by blocks", 1),
    ("    __syncthreads();\n  }\n\n  // the inverse, rows by position",
     "    __syncthreads();\n  }\n  k2_step(10);\n\n"
     "  // the inverse, rows by position", 1),
    ("    ipiv[static_cast<size_t>(blockIdx.x) * n + i] = s_ipiv[i];\n}\n",
     "    ipiv[static_cast<size_t>(blockIdx.x) * n + i] = s_ipiv[i];\n"
     "  k2_finish(11);\n}\n", 1),
]
# The probe's cases: chip_smoke.py's K2 timing draws (SPD, the main path's
# headline class) and its general class (κ ≤ 4n), at both shapes.
CASES = {"spd_100x128": lambda: make_spd_batch(
             100, 128, np.random.default_rng(2026)),
         "spd_1600x128": lambda: make_spd_batch(
             1600, 128, np.random.default_rng(2027)),
         "square_100x128": lambda: make_square_batch(
             100, 128, np.random.default_rng(2026)),
         "square_1600x128": lambda: make_square_batch(
             1600, 128, np.random.default_rng(2028))}


def _libraries() -> dict:
    """This tree's K2, plain (with the occupancy reader) and stamped."""
    src = cuda_build.CSRC_DIR
    return {"plain": variant_library(
                "k2_this", {"lu.cu": ([], OCCUPANCY)}, src=src, units=UNITS,
                flags=("-Xptxas", "-v")),
            "stamped": variant_library(
                "k2_this_stamped", {"lu.cu": (STAMPS, STAMP_READER)},
                src=src, units=UNITS)}


def _ptxas(cdll) -> list:
    """``ptxas -v``'s lines for the K2 kernels of ``cdll``'s build."""
    lines = cdll.compiler_log.splitlines()
    return [x.strip() for i, line in enumerate(lines)
            if "Compiling entry function" in line and "lu_kernel" in line
            for x in lines[i:i + 4]]


def _occupancy(cdll) -> dict:
    fn = cdll.cmi_probe_k2_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = {}
    for n in OCC_N:
        for pair in ((0, 1) if n > 64 else (0,)):
            out = (ctypes.c_int * 5)()
            cuda_build.check(fn(n, pair, ctypes.cast(out, ctypes.c_void_p)),
                             "occupancy")
            res[f"n{n}" + ("_pair" if pair else "")] = {
                "registers": out[0], "local_bytes": out[1],
                "blocks_per_sm": out[2], "threads": out[3],
                "smem_bytes": out[4]}
    res["ptxas"] = _ptxas(cdll)
    return res


def launcher(cdll, a, pair=None):
    """A bare launch of ``cdll``'s ``cmi_lu_inverse`` on ``a`` into the
    same output buffers every call; with ``pair`` (0 or 1) the probe's
    ``cmi_probe_k2_launch`` of that instance instead."""
    inv = torch.empty_like(a)
    ipiv = torch.empty(a.shape[:2], dtype=torch.int32, device=a.device)
    device, stream = cuda_build.launch_args(a)
    if pair is not None:
        fn = cdll.cmi_probe_k2_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def run():
        if pair is None:
            err = cdll.cmi_lu_inverse(a.data_ptr(), inv.data_ptr(),
                                      ipiv.data_ptr(), a.shape[0],
                                      a.shape[-1], device, stream)
        else:
            err = fn(a.data_ptr(), inv.data_ptr(), ipiv.data_ptr(),
                     a.shape[0], a.shape[-1], pair, stream)
        cuda_build.check(err, "k2")
        return inv, ipiv
    return run


def _median_ms(fn, calls: int = 20, warmup: int = 3) -> float:
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


def same_outputs(x, piv, ref, ref_piv) -> bool:
    """``inv`` and ``ipiv`` equal (``torch.equal``) on the members where
    ``ref`` is finite, and the same members non-finite."""
    ok = torch.isfinite(ref).all(dim=(1, 2))
    return (torch.equal(torch.isfinite(x).all(dim=(1, 2)), ok)
            and torch.equal(x[ok], ref[ok])
            and torch.equal(piv[ok], ref_piv[ok]))


def _ab(libs: dict, a, case: str, card: str) -> bool:
    """Bitwise equality of both outputs and the bare timings, baseline
    and this in turns.  Prints one line; returns whether they agreed."""
    runs = {k: launcher(v, a) for k, v in libs.items()}
    outs = {k: [t.clone() for t in run()] for k, run in runs.items()}
    torch.cuda.synchronize()
    same = same_outputs(*outs["this"], *outs["baseline"])
    ms = {k: [] for k in runs}
    for k in ("baseline", "this", "this", "baseline"):
        ms[k].append(_median_ms(runs[k]))
    print(json.dumps({"probe": "baseline", "case": case,
                      "bitwise_equal": same, "baseline_ms": ms["baseline"],
                      "this_ms": ms["this"], "card": card}), flush=True)
    return same


def _clock_split(cdll, a) -> dict:
    """The median over 5 launches of each step of block 0, for each
    observer."""
    fn = cdll.cmi_k2_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    run = launcher(cdll, a)
    stamps = (ctypes.c_ulonglong * 48)()
    rows, ghz = [], []
    for _ in range(5):
        run()
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)),
                         "k2 stamps")
        rate = ((stamps[35] - stamps[34])
                / (stamps[33] - stamps[32]))  # clocks per ns
        ghz.append(rate)
        rows.append([[stamps[16 * o + i] / rate / 1e3
                      for i in range(len(STEPS))] for o in (0, 1)])
    med = np.median(np.array(rows), axis=0)
    return {"sm_clock_ghz": float(np.median(ghz)),
            **{who: {"block_us": float(m.sum()),
                     "steps_us": dict(zip(STEPS, map(float, m)))}
               for who, m in zip(("thread_0", "last_thread"), med)}}


def _instances(cdll, a, case: str, card: str) -> None:
    """At n = 128, the instance for one wave against the one capped to two
    blocks an SM: bits and bare timings in the order one, two, two, one
    (``cmi_lu_inverse`` takes the second past one wave)."""
    runs = {"one_block": launcher(cdll, a, 0),
            "two_blocks": launcher(cdll, a, 1)}
    outs = {k: [t.clone() for t in run()] for k, run in runs.items()}
    torch.cuda.synchronize()
    ms = {k: [] for k in runs}
    for k in ("one_block", "two_blocks", "two_blocks", "one_block"):
        ms[k].append(_median_ms(runs[k]))
    print(json.dumps({"probe": "instances", "case": case,
                      "bitwise_equal": same_outputs(*outs["two_blocks"],
                                                    *outs["one_block"]),
                      "one_block_ms": ms["one_block"],
                      "two_blocks_ms": ms["two_blocks"], "card": card}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    this = _libraries()
    libs = {"this": this["plain"]}
    if len(sys.argv) > 1:
        libs["baseline"] = variant_library(
            "k2_baseline", src=Path(sys.argv[1]), units=UNITS,
            flags=("-Xptxas", "-v"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"probe": "occupancy",
                      "this": _occupancy(this["plain"]),
                      **({"baseline": {"ptxas": _ptxas(libs["baseline"])}}
                         if "baseline" in libs else {}),
                      "card": card}), flush=True)
    same = True
    for case, make in CASES.items():
        a = torch.tensor(make(), dtype=torch.float32, device=dev)
        if "baseline" in libs:
            same &= _ab(libs, a, case, card)
        _instances(this["plain"], a, case, card)
        print(json.dumps({"probe": "wrapper", "case": case,
                          "ms": _median_ms(
                              lambda: cuda_lu.lu_inverse_cuda(a)),
                          "card": card}), flush=True)
        print(json.dumps({"probe": "clock_split", "case": case,
                          **_clock_split(this["stamped"], a),
                          "card": card}), flush=True)
    if not same:
        raise SystemExit("the baseline's K2 outputs differ from this tree's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
