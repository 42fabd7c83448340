"""Probes of the batched Gauss-Jordan inverse kernel K7
(``csrc/gauss_jordan.cu``) on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.gj_probe [BASELINE_CSRC]

Each probe builds ``gauss_jordan.cu`` from a copy of a ``csrc/`` under
``build/`` (``gp_ns_probe.variant_library``) and prints one JSON line.
Two designs of K7 are known to the probe (:data:`DESIGNS`): the register
tiled one of this tree (``"tiles"``) and the one it replaced (``"shared"``:
the matrix in shared memory, one warp's pivot search and three block
barriers a step).  A ``csrc/`` is probed with the design whose anchors it
holds, so the baseline (another checkout's ``csrc/``, such as the
parent's unpacked with ``git archive HEAD~`` under ``build/``) gets its
own occupancy and clock split when it holds either design, and is built
unpatched for the A/B in any case.

- ``occupancy``: for each instance (n ∈ {16, 32, 64, 128, 192}), the
  registers a thread and the local memory (spills) from
  ``cudaFuncGetAttributes``, and the blocks an SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's shared
  memory; ``ptxas -v``'s lines for K7.
- ``baseline`` (when ``BASELINE_CSRC`` is given): both checkouts' K7 on
  the same inputs (:data:`CASES`), whether the outputs are bitwise equal
  on the finite members and non-finite on the same ones, and each timed
  as a bare launch in the order baseline, this, this, baseline (CUDA
  events around each launch, median of 20 after warm-up).
- ``wrapper``: this tree's K7 through ``cuda_gauss_jordan.gauss_jordan_cuda``
  (what ``chip_smoke.py`` times), median of 20.
- ``clock_split``: two threads of block 0, thread 0 and the last one,
  stamping ``clock64`` (thread 0 also ``%globaltimer``) at the steps of
  the design (a step that repeats, such as a pivot column, is summed over
  its repeats); each in µs, median of 5 launches of the whole batch, at
  the SM clock the two timers give; and the stamped build's own time as a
  bare launch (block 0 against the whole batch).

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
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gauss_jordan

UNITS = ("gauss_jordan.cu",)

# Clock bookkeeping.  Two observers in block 0, thread 0 and the last
# thread, each add the clocks since their previous stamp to step s
# (k7_step); k7_finish closes the last step after a barrier and copies both
# rows of sums, and the globaltimer and clock at the two ends, to k7_probe.
_DEFS = """
__device__ unsigned long long k7_probe[3][16];
__shared__ unsigned long long k7_sh[2][17];
__device__ __forceinline__ int k7_obs() {
  if (blockIdx.x != 0) return -1;
  return threadIdx.x == 0 ? 0 : threadIdx.x == blockDim.x - 1 ? 1 : -1;
}
__device__ __forceinline__ void k7_start() {
  const int o = k7_obs();
  if (o >= 0) {
    for (int i = 0; i < 16; ++i) k7_sh[o][i] = 0;
    k7_sh[o][16] = clock64();
    if (o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      k7_probe[2][0] = g;
      k7_probe[2][2] = k7_sh[0][16];
    }
  }
}
__device__ __forceinline__ void k7_step(int s) {
  const int o = k7_obs();
  if (o >= 0) {
    const unsigned long long t = clock64();
    k7_sh[o][s] += t - k7_sh[o][16];
    k7_sh[o][16] = t;
  }
}
__device__ __forceinline__ void k7_finish(int s) {
  __syncthreads();
  const int o = k7_obs();
  if (o >= 0) {
    k7_step(s);
    for (int i = 0; i < 16; ++i) k7_probe[o][i] = k7_sh[o][i];
    if (o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      k7_probe[2][1] = g;
      k7_probe[2][3] = clock64();
    }
  }
}
"""
STAMP_READER = """
extern "C" int cmi_k7_stamps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, k7_probe, sizeof(k7_probe)));
}
"""
# The occupancy reader of the instance for n, for each design.
_OCC_BODY = """
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = blocks;
    out[3] = threads;
    out[4] = static_cast<int>(smem);
  }
  return static_cast<int>(err);
}
"""
_OCC_HEAD = """
extern "C" int cmi_probe_k7_occupancy(int n, int* out) {
"""
_SHARED_INSTANCE = """
  const void* fn = reinterpret_cast<const void*>(gauss_jordan_kernel);
  const size_t smem = (static_cast<size_t>(n) * gj_ld(n) + n) * sizeof(float) +
                      2ull * n * sizeof(int);
  const int threads = kThreads;
"""
_TILES_INSTANCE = """
  const void* fn = gj_kernel_for(n);
  const size_t smem = gj_smem(n);
  const int threads = gj_threads(n);
"""


# Each design: its steps (at most 16), the (anchor, replacement, count)
# patches that stamp them and the probe's occupancy reader.
DESIGNS = {
    "shared": {
        "steps": ("load", "pivot search (warp 0)",
                  "forming f and 1/pivot (warp 0)",
                  "the barrier after the search (the other warps wait)",
                  "swap and scale, and its barrier",
                  "update, and its barrier", "unswap (thread 0) and barrier",
                  "write"),
        "stamps": [
            ("#include <cuda_runtime.h>\n",
             "#include <cuda_runtime.h>\n" + _DEFS, 1),
            ("  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n",
             "  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n"
             "  k7_start();\n", 1),
            ("    for (int j = lane; j < n; j += 32) W[i * ld + j] = "
             "a[base + i * n + j];\n  __syncthreads();\n",
             "    for (int j = lane; j < n; j += 32) W[i * ld + j] = "
             "a[base + i * n + j];\n  __syncthreads();\n  k7_step(0);\n", 1),
            ("      const int p = bi < n ? bi : k;\n",
             "      k7_step(1);\n      const int p = bi < n ? bi : k;\n", 1),
            ("        s_inv = 1.f / W[p * ld + k];\n      }\n    }\n"
             "    __syncthreads();\n",
             "        s_inv = 1.f / W[p * ld + k];\n      }\n      k7_step(2);\n"
             "    }\n    __syncthreads();\n    k7_step(3);\n", 1),
            ("      W[k * ld + j] = __fmul_rn(j == k ? 1.f : t, r);\n    }\n"
             "    __syncthreads();\n",
             "      W[k * ld + j] = __fmul_rn(j == k ? 1.f : t, r);\n    }\n"
             "    __syncthreads();\n    k7_step(4);\n", 1),
            ("                                  __fmul_rn(fi, W[k * ld + j]));"
             "\n    }\n    __syncthreads();\n  }\n",
             "                                  __fmul_rn(fi, W[k * ld + j]));"
             "\n    }\n    __syncthreads();\n    k7_step(5);\n  }\n", 1),
            ("      src[p] = t;\n    }\n  }\n  __syncthreads();\n",
             "      src[p] = t;\n    }\n  }\n  __syncthreads();\n"
             "  k7_step(6);\n", 1),
            ("      inv[base + i * n + j] = W[i * ld + src[j]];\n}\n",
             "      inv[base + i * n + j] = W[i * ld + src[j]];\n"
             "  k7_finish(7);\n}\n", 1),
        ],
        "tail": _OCC_HEAD + _SHARED_INSTANCE + _OCC_BODY,
    },
    "tiles": {
        # both kernels of the file: gj_kernel (thread 0 a panel thread, the
        # last thread a tile thread) and gj_look_kernel (thread 0 a tile
        # thread, the last thread one of its own panel threads)
        "steps": ("load (lookahead panel threads: their first columns; its "
                  "tile threads: and the mirror)",
                  "the wait for a panel (the barrier before it; lookahead "
                  "tile threads: its hand-over)",
                  "the panel threads take the panel's 4 steps",
                  "the barrier after the panel (lookahead panel threads: "
                  "the wait for the mirror)",
                  "the pivot rows staged (lookahead tile threads: the mirror "
                  "written)", "their barrier",
                  "the pivot rows formed (row group 0; lookahead: the panel "
                  "threads, a column each)", "their barrier",
                  "the 4 steps on the tile (quad g: the panel reloaded), "
                  "the next columns published",
                  "the row map's tables and barrier (lookahead: the last "
                  "barrier)", "write",
                  "lookahead panel threads: the next panel's columns take "
                  "the panel's steps"),
        "stamps": [
            ("#include <cstdint>\n", "#include <cstdint>\n" + _DEFS, 1),
            ("  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n",
             "  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;\n"
             "  k7_start();\n", 2),
            ("  if (t.cq == 0) t.publish(sm.Pf);\n",
             "  if (t.cq == 0) t.publish(sm.Pf);\n  k7_step(0);\n", 1),
            ("    float* Pg = sm.Pf + (g & 1) * 4 * NP;\n    __syncthreads();\n",
             "    float* Pg = sm.Pf + (g & 1) * 4 * NP;\n    __syncthreads();\n"
             "    k7_step(1);\n", 1),
            ("        st4(sm.L + 4 * s, make_float4(f[0], f[1], f[2], f[3]));\n"
             "      }\n    }\n    __syncthreads();\n",
             "        st4(sm.L + 4 * s, make_float4(f[0], f[1], f[2], f[3]));\n"
             "      }\n    }\n    k7_step(2);\n    __syncthreads();\n"
             "    k7_step(3);\n", 1),
            ("    if (t.cq != g) t.stage(m, sp, sm.St);\n    __syncthreads();\n",
             "    if (t.cq != g) t.stage(m, sp, sm.St);\n    k7_step(4);\n"
             "    __syncthreads();\n    k7_step(5);\n", 1),
            ("    if (t.rg == 0 && t.cq != g) t.form(sm.St, sm.L, sm.r, sp, nh, "
             "sm.U);\n    __syncthreads();\n",
             "    if (t.rg == 0 && t.cq != g) t.form(sm.St, sm.L, sm.r, sp, nh, "
             "sm.U);\n    k7_step(6);\n    __syncthreads();\n"
             "    k7_step(7);\n", 1),
            ("      if (t.cq == g + 1) t.publish(sm.Pf + ((g + 1) & 1) * 4 * NP);"
             "\n    }\n  }\n",
             "      if (t.cq == g + 1) t.publish(sm.Pf + ((g + 1) & 1) * 4 * NP);"
             "\n    }\n    k7_step(8);\n  }\n", 1),
            ("    sm.row[pos] = tid;\n  }\n  __syncthreads();\n",
             "    sm.row[pos] = tid;\n  }\n  __syncthreads();\n  k7_step(9);\n",
             1),
            ("  t.write(inv + base, n, sm.pos, sm.row);\n}\n",
             "  t.write(inv + base, n, sm.pos, sm.row);\n  k7_finish(10);\n}\n",
             2),
            # the lookahead's panel threads
            ("    float4 v = load_quad(a + base, n, vec, s, 0);\n",
             "    float4 v = load_quad(a + base, n, vec, s, 0);\n"
             "    k7_step(0);\n", 1),
            ("      panel_steps<NP>(v, f, pos, s, n, k0, nh, sm, sm.sp + 4 * b,\n"
             "                      sm.r + 4 * b);\n",
             "      panel_steps<NP>(v, f, pos, s, n, k0, nh, sm, sm.sp + 4 * b,\n"
             "                      sm.r + 4 * b);\n      k7_step(2);\n", 1),
            ("      bar_sync<3, kAll>();\n",
             "      bar_sync<3, kAll>();\n      k7_step(3);\n", 1),
            ("      for (int h = 0; h < 4; ++h) sm.U[h * NP + s] = u[h];\n",
             "      for (int h = 0; h < 4; ++h) sm.U[h * NP + s] = u[h];\n"
             "      k7_step(6);\n", 1),
            ("      v = row_steps(nx, lf, un, piv);\n",
             "      v = row_steps(nx, lf, un, piv);\n      k7_step(11);\n", 1),
            ("    __syncthreads();\n    return;\n",
             "    __syncthreads();\n    k7_finish(10);\n    return;\n", 1),
            # the lookahead's tile threads
            ("  t.mirror(sm.W, kLd, n);\n  bar_arrive<3, kAll>();\n",
             "  t.mirror(sm.W, kLd, n);\n  bar_arrive<3, kAll>();\n"
             "  k7_step(0);\n", 1),
            ("    bar_sync<2, kAll>();\n",
             "    bar_sync<2, kAll>();\n    k7_step(1);\n", 1),
            ("      t.steps(t.mine(sp), sp, sm.U, sm.L + b * 4 * NP, n);\n"
             "    if (g + 1 < panels) {\n      t.mirror(sm.W, kLd, n);\n",
             "      t.steps(t.mine(sp), sp, sm.U, sm.L + b * 4 * NP, n);\n"
             "    k7_step(8);\n    if (g + 1 < panels) {\n"
             "      t.mirror(sm.W, kLd, n);\n      k7_step(4);\n", 1),
            ("      bar_arrive<3, kAll>();\n    }\n  }\n  __syncthreads();\n",
             "      bar_arrive<3, kAll>();\n    }\n  }\n  __syncthreads();\n"
             "  k7_step(9);\n", 1),
        ],
        "tail": _OCC_HEAD + _TILES_INSTANCE + _OCC_BODY,
    },
}
# The probe's cases: chip_smoke.py's K7 timing draws (the general class,
# κ ≤ 4n) at both shapes, and the JAX kernel's ceiling.
CASES = {"square_100x128": lambda: make_square_batch(
             100, 128, np.random.default_rng(2026)),
         "square_1600x128": lambda: make_square_batch(
             1600, 128, np.random.default_rng(2028)),
         "square_100x192": lambda: make_square_batch(
             100, 192, np.random.default_rng(2192))}


def design_of(src: Path) -> str | None:
    """The design whose every patch anchor ``src/gauss_jordan.cu`` holds
    as often as the patch expects, or None."""
    text = (src / "gauss_jordan.cu").read_text()
    for name, design in DESIGNS.items():
        if all(text.count(anchor) == count
               for anchor, _, count in design["stamps"]):
            return name
    return None


def _libraries(tag: str, src: Path, design: str | None) -> dict:
    """K7 of ``src``: built plain (with the occupancy reader of its
    design, where it has one) and stamped."""
    if design is None:
        return {"plain": variant_library(f"k7_{tag}", src=src, units=UNITS,
                                         flags=("-Xptxas", "-v"))}
    d = DESIGNS[design]
    return {"plain": variant_library(
                f"k7_{tag}", {"gauss_jordan.cu": ([], d["tail"])}, src=src,
                units=UNITS, flags=("-Xptxas", "-v")),
            "stamped": variant_library(
                f"k7_{tag}_stamped",
                {"gauss_jordan.cu": (d["stamps"], STAMP_READER)}, src=src,
                units=UNITS)}


def _ptxas(cdll) -> list:
    """``ptxas -v``'s lines for the K7 kernels of ``cdll``'s build."""
    lines = cdll.compiler_log.splitlines()
    return [x.strip() for i, line in enumerate(lines)
            if "Compiling entry function" in line and "gauss_jordan" in line
            for x in lines[i:i + 4]]


def _occupancy(cdll) -> dict:
    fn = cdll.cmi_probe_k7_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = {}
    for n in (16, 32, 64, 128, 192):
        out = (ctypes.c_int * 5)()
        cuda_build.check(fn(n, ctypes.cast(out, ctypes.c_void_p)),
                         "occupancy")
        res[f"n{n}"] = {"registers": out[0], "local_bytes": out[1],
                        "blocks_per_sm": out[2], "threads": out[3],
                        "smem_bytes": out[4]}
    res["ptxas"] = _ptxas(cdll)
    return res


def launcher(cdll, a):
    """A bare launch of ``cdll``'s ``cmi_gauss_jordan`` on ``a`` into the
    same output buffer every call."""
    inv = torch.empty_like(a)
    device, stream = cuda_build.launch_args(a)

    def run():
        cuda_build.check(cdll.cmi_gauss_jordan(
            a.data_ptr(), inv.data_ptr(), a.shape[0], a.shape[-1], device,
            stream), "k7")
        return inv
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


def same_outputs(x, ref) -> bool:
    """``x`` equal to ``ref`` (``torch.equal``) on the members where
    ``ref`` is finite, and the same members non-finite."""
    ok = torch.isfinite(ref).all(dim=(1, 2))
    return (torch.equal(torch.isfinite(x).all(dim=(1, 2)), ok)
            and torch.equal(x[ok], ref[ok]))


def _ab(libs: dict, a, case: str, card: str) -> bool:
    """Bitwise equality and the bare timings, baseline and this in turns.
    Prints one line; returns whether they agreed."""
    runs = {k: launcher(v["plain"], a) for k, v in libs.items()}
    outs = {k: run().clone() for k, run in runs.items()}
    torch.cuda.synchronize()
    same = same_outputs(outs["this"], outs["baseline"])
    ms = {k: [] for k in runs}
    for k in ("baseline", "this", "this", "baseline"):
        ms[k].append(_median_ms(runs[k]))
    print(json.dumps({"probe": "baseline", "case": case,
                      "bitwise_equal": same, "baseline_ms": ms["baseline"],
                      "this_ms": ms["this"], "card": card}), flush=True)
    return same


def _clock_split(cdll, a, design: str) -> dict:
    """The median over 5 launches of each step of block 0, for each
    observer."""
    steps = DESIGNS[design]["steps"]
    fn = cdll.cmi_k7_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    run = launcher(cdll, a)
    stamps = (ctypes.c_ulonglong * 48)()
    rows, ghz = [], []
    for _ in range(5):
        run()
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)),
                         "k7 stamps")
        rate = ((stamps[35] - stamps[34])
                / (stamps[33] - stamps[32]))  # clocks per ns
        ghz.append(rate)
        rows.append([[stamps[16 * o + i] / rate / 1e3
                      for i in range(len(steps))] for o in (0, 1)])
    med = np.median(np.array(rows), axis=0)
    return {"design": design, "sm_clock_ghz": float(np.median(ghz)),
            "stamped_kernel_ms": _median_ms(run),
            **{who: {"block_us": float(m.sum()),
                     "steps_us": dict(zip(steps, map(float, m)))}
               for who, m in zip(("thread_0", "last_thread"), med)}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    trees = {"this": cuda_build.CSRC_DIR}
    if len(sys.argv) > 1:
        trees["baseline"] = Path(sys.argv[1])
    designs = {k: design_of(src) for k, src in trees.items()}
    if designs["this"] is None:
        raise SystemExit("this tree's gauss_jordan.cu holds no design the "
                         "probe knows: update its patches")
    libs = {k: _libraries(k, src, designs[k]) for k, src in trees.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    for k, lib in libs.items():
        d = designs[k]
        print(json.dumps({"probe": "occupancy", "tree": k, "design": d,
                          **(_occupancy(lib["plain"]) if d else
                             {"ptxas": _ptxas(lib["plain"])}),
                          "card": card}), flush=True)
    same = True
    for case, make in CASES.items():
        a = torch.tensor(make(), dtype=torch.float32, device=dev)
        if "baseline" in libs:
            same &= _ab(libs, a, case, card)
        print(json.dumps({"probe": "wrapper", "case": case,
                          "ms": _median_ms(lambda: cuda_gauss_jordan.
                                           gauss_jordan_cuda(a)),
                          "card": card}), flush=True)
        for k, lib in libs.items():
            if "stamped" in lib:
                print(json.dumps({"probe": "clock_split", "tree": k,
                                  "case": case,
                                  **_clock_split(lib["stamped"], a,
                                                 designs[k]),
                                  "card": card}), flush=True)
    if not same:
        raise SystemExit("the baseline's K7 outputs differ from this tree's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
