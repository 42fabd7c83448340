"""Probes of the Cholesky kernels' packed instances (129 ≤ n ≤ 256): K4
(``csrc/cholesky.cu::chol_factor_band_kernel``), K5
(``csrc/gp.cu::gp_chol_band_kernel``) and K10 with and without W
(``gp_lml_band_kernel``), on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe routes
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe ab BASELINE_CSRC

Prints one JSON line a probe (``routes`` alone with that argument, and
``ab`` alone with its):

- ``occupancy``: for each kernel at n = 160, 192, 224 and 256 and each
  block size (256 and 512 threads, the instances ``chol_band_threads``
  chooses from), the registers a thread and the local memory (spills) from
  ``cudaFuncGetAttributes``, the shared memory a block asks for, and the
  blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
  ``ptxas -v``'s lines.
- ``wrapper``: each kernel through its wrapper at :data:`TIMED` (median of
  20 CUDA-event timings after 3 warm-up calls; 1600 = 100 draws repeated).
- ``clock_split``: thread 0 of block 0 stamping ``clock64`` and
  ``%globaltimer`` at the phases of K4 (load, factor, write) and of K10
  with W (load, factor, W = L⁻¹ in place, t = Wd with α = Wᵀt and W's
  store, the epilogue), µs at the SM clock the two timers give, median of
  5 launches; and in the last launch thread 0's time in each step of the
  factor and of the in-place W summed over the panels (``chol_probe``'s
  factor steps, thread 0 being warp 0's lane 0: the strips, the update,
  pivots and stores of the diagonal blocks, then the wait for the other
  warps' trailing tiles; W's chain of thread 0's column, the diagonal
  block's copy, its tiles and the barrier, then the strip's copy and its
  barrier), at :data:`SPLIT`.  The
  stamps cost thread 0 time.
- ``routes``: at :data:`TIMED`, each kernel beside the route it replaced
  in the band (K4: ``torch.linalg.cholesky_ex``; K5: the Schur solve on K3,
  ``cuda_gp.gp_schur_route``; K10: one ``torch.linalg`` LML forward and
  backward, ``models.gp.gp_log_marginal_likelihood``), its plain version,
  the GP ``pallas`` method and one fit step's forward and backward through
  the fused LML, and the GP ``solve`` method.
- ``ab`` (``BASELINE_CSRC``: another checkout's ``csrc/``, e.g. the parent
  unpacked by ``git archive`` under ``build/``): ``occupancy`` of this
  tree (both block sizes), then at :data:`TIMED` each kernel of the
  baseline, of this tree (its own block sizes) and of this tree with every
  packed instance at 256 and at 512 threads, bare ctypes launches on the
  same inputs: which outputs are bitwise equal to the baseline's and to
  this tree's, and the times in the order baseline, this, this, baseline
  and 256, 512, 512, 256 (CUDA events, median of 20 after warm-up).

The stamped, occupancy and block-size builds come from a copy of
``csrc/`` with patches and a reader (``gp_ns_probe.variant_library``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench import chol_probe
from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import (
    median_ms,
    variant_library,
)
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.models import gp
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    cuda_gp,
    cuda_gp_lml,
)

BAND_N = (160, 192, 224, 256)
TIMED = ((100, 160), (100, 192), (100, 224), (100, 256), (1600, 224),
         (1600, 256))
SPLIT = ((100, 256), (1600, 256))

# Occupancy of one kernel at `threads` threads and `smem` bytes:
# registers, local bytes and blocks an SM into out[0..3).
_OCC = """
static int probe_band_occupancy(const void* fn, int threads, size_t smem,
                                int* out) {
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
  }
  return static_cast<int>(err);
}
"""
# Appended to cholesky.cu (which 0) and gp.cu (1 = K5, 2 = K10, 3 = K10
# with W): registers, local bytes, blocks an SM and shared bytes at n and
# `threads` (256 or 512, the templated instances).
CHOL_OCCUPANCY = _OCC + """
extern "C" int cmi_probe_band_occupancy(int which, int n, int threads,
                                        int* out) {
  const size_t m = static_cast<size_t>(chol_packed_floats(n)) * sizeof(float);
  out[3] = static_cast<int>(m);
  const void* fn = threads == 512 ? (const void*)chol_factor_band_kernel<512>
                                  : (const void*)chol_factor_band_kernel<256>;
  return probe_band_occupancy(fn, threads, m, out);
}
"""
GP_OCCUPANCY = _OCC + """
extern "C" int cmi_probe_band_occupancy(int which, int n, int threads,
                                        int* out) {
  const bool wide = threads == 512;
  const void* fn =
      which == 1 ? (wide ? (const void*)gp_chol_band_kernel<512>
                         : (const void*)gp_chol_band_kernel<256>)
      : which == 2 ? (wide ? (const void*)gp_lml_band_kernel<false, 512>
                           : (const void*)gp_lml_band_kernel<false, 256>)
                   : (wide ? (const void*)gp_lml_band_kernel<true, 512>
                           : (const void*)gp_lml_band_kernel<true, 256>);
  const size_t smem =
      which == 1 ? (chol_packed_floats(n) + 2ull * n) * sizeof(float)
                 : gp_lml_band_floats(n, which == 3) * sizeof(float);
  out[3] = static_cast<int>(smem);
  return probe_band_occupancy(fn, threads, smem, out);
}
"""
# (name, unit, which, kernel symbol as ptxas prints it with the block size
# "{}")
KERNELS = (("K4", "cholesky.cu", 0, "chol_factor_band_kernelILi{}E"),
           ("K5", "gp.cu", 1, "gp_chol_band_kernelILi{}E"),
           ("K10", "gp.cu", 2, "gp_lml_band_kernelILb0ELi{}E"),
           ("K10_emit_w", "gp.cu", 3, "gp_lml_band_kernelILb1ELi{}E"))
THREADS = (256, 512)
# chol_band_threads' body, and the bodies that pin every packed instance to
# one block size (the ab mode's 256 and 512 builds).
BAND_THREADS = "  return 2 * (smem + 1024) <= 233472 ? 256 : 512;\n"


def _threads_patch(threads: int):
    return {"cholesky_common.cuh": (
        [(BAND_THREADS, f"  return {threads};\n", 1)], "")}


# The in-place W's steps, added to chol_probe.STEPS' (ids 9 to 12).
W_STEPS = [
    ("        if (k0 + r < n) K[rb + r * rs + j] = w[r];\n    }\n",
     "        if (k0 + r < n) K[rb + r * rs + j] = w[r];\n    }\n"
     "    chol_step(9);\n", 1),
    ("      save_block(k1, (p + 1) & 1);\n",
     "      save_block(k1, (p + 1) & 1);\n      chol_step(11);\n", 1),
    ("          t = __shfl_sync(0xffffffffu, next, 0);\n        }\n      }\n"
     "    }\n    __syncthreads();\n",
     "          t = __shfl_sync(0xffffffffu, next, 0);\n        }\n      }\n"
     "    }\n    __syncthreads();\n    chol_step(10);\n", 1),
    ("      __syncthreads();\n    }\n  }\n}\n\n}  // namespace\n",
     "      __syncthreads();\n      chol_step(12);\n    }\n  }\n}\n\n"
     "}  // namespace\n", 1),
]
STEP_NAMES = {0: "factor: first diagonal block's stores and barrier",
              1: "factor: strips",
              2: "factor: warp 0's stores of the next diagonal block",
              3: "factor: then waiting for the trailing tiles",
              6: "factor: warp 0's update of a diagonal block by its panel",
              7: "factor: warp 0's factor of a diagonal block (pivots)",
              9: "W in place: thread 0's column of the panel (the previous "
                 "panel applied, the chain of divisions, the stores)",
              11: "W in place: the diagonal block's copy",
              10: "W in place: thread 0's tiles, then the barrier",
              12: "W in place: the strip's copy and its barrier"}
_START = ("  if (blockIdx.x == 0 && threadIdx.x == 0) chol_next = 0;\n"
          "  chol_stamp();\n")
_END = ("  __syncthreads();\n  chol_stamp();\n"
        "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
        "    for (int i = 0; i < 16; ++i) chol_step_clocks[i] = "
        "chol_step_sh[i];\n")
K4_STAMPS = [
    ('#include "cholesky_common.cuh"\n', chol_probe._STAMP_DEFS, 1),
    ("  const CholPacked lay;\n  chol_load(", "  const CholPacked lay;\n"
     + _START + "  chol_load(", 1),
    ("  __syncthreads();\n  chol_factor(smem, n, lay);\n",
     "  __syncthreads();\n  chol_stamp();\n  chol_step(-1);\n"
     "  chol_factor(smem, n, lay);\n  chol_stamp();\n", 1),
    ("    l[base + e] = j <= i ? smem[lay.row(i) + j] : 0.f;\n  }\n}\n",
     "    l[base + e] = j <= i ? smem[lay.row(i) + j] : 0.f;\n  }\n" + _END
     + "}\n", 1),
]
K4_PHASES = ("load", "factor", "write")
K10_STAMPS = [
    ('#include "cholesky_common.cuh"\n', chol_probe._STAMP_DEFS, 1),
    ("  const float* cs = c + sys * n;\n  chol_load(bs, K, n, lay, [=](int i, "
     "int j, float v) {\n    return i == j ? __fadd_rn(v, cs[i]) : v;  // as "
     "gp_ns_stage_k rounds it\n  });\n  for (int i = tid; i < n; i += "
     "T) v[i] = d[sys * n + i];\n  __syncthreads();\n"
     "  chol_factor(K, n, lay);\n",
     "  const float* cs = c + sys * n;\n" + _START
     + "  chol_load(bs, K, n, lay, [=](int i, int j, float v) {\n"
     "    return i == j ? __fadd_rn(v, cs[i]) : v;\n  });\n"
     "  for (int i = tid; i < n; i += T) v[i] = d[sys * n + i];\n"
     "  __syncthreads();\n  chol_stamp();\n  chol_step(-1);\n"
     "  chol_factor(K, n, lay);\n  chol_stamp();\n", 1),
    ("      chol_tri_inverse_in_place(K, W, n, lay);  // ends with a "
     "barrier\n",
     "      chol_tri_inverse_in_place(K, W, n, lay);\n"
     "      chol_stamp();\n", 1),
    ("    u = v + n;\n  }\n  __syncthreads();\n",
     "    u = v + n;\n  }\n  __syncthreads();\n  chol_stamp();\n", 1),
    ("      out[2 * sys + 1] = 2.f * ld_sum;\n    }\n  }\n}\n",
     "      out[2 * sys + 1] = 2.f * ld_sum;\n    }\n  }\n" + _END + "}\n",
     1),
]
K10_PHASES = ("load", "factor", "W in place", "t, alpha, W store",
              "epilogue")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def _inputs(batch: int, n: int, dev) -> dict:
    """100 draws repeated to ``batch``: an SPD batch (K4) and GP systems
    (K5, K10) in the kernels' flat layout and the fixture layout."""
    reps = batch // 100

    def tile(x):
        return torch.tensor(x, dtype=torch.float32, device=dev).repeat(
            reps, *([1] * (x.ndim - 1))).contiguous()

    a = tile(make_spd_batch(100, n, np.random.default_rng(9100 + n)))
    g = make_gp_batch(100, n, np.random.default_rng(9200 + n))
    fixture = [tile(g[k]) for k in "abcde"]
    flat = cuda_gp._flat(*fixture, max_n=cuda_build.CHOL_MAX_N)
    return {"a": a, "fixture": fixture, "flat": flat}


def occupancy() -> dict:
    """Registers, spills, shared bytes and blocks an SM of each packed
    instance at each n of :data:`BAND_N` and each block size, with ``ptxas
    -v``'s lines."""
    res, ptxas = {}, []
    for unit, tail in (("cholesky.cu", CHOL_OCCUPANCY),
                       ("gp.cu", GP_OCCUPANCY)):
        lib = variant_library(
            f"chol_band_occ_{unit[:-3]}", {unit: ([], tail)},
            units=(unit,), flags=("-Xptxas", "-v"))
        fn = lib.cmi_probe_band_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lines = lib.compiler_log.splitlines()
        for name, u, which, symbol in KERNELS:
            if u != unit:
                continue
            for threads in THREADS:
                rows = {}
                for n in BAND_N:
                    out = (ctypes.c_int * 4)()
                    cuda_build.check(fn(which, n, threads, ctypes.cast(
                        out, ctypes.c_void_p)), f"{name} occupancy")
                    rows[n] = {"registers": out[0], "local_bytes": out[1],
                               "smem_bytes": out[3],
                               "blocks_per_sm": out[2]}
                res[f"{name}_t{threads}"] = rows
                sym = symbol.format(threads)
                ptxas += [f"{name}_t{threads}: " + x.strip()
                          for i, line in enumerate(lines)
                          if "Compiling entry function" in line
                          and sym in line
                          for x in lines[i:i + 4]
                          if "registers" in x or "spill" in x]
    return {"kernels": res, "ptxas": ptxas}


def _timed_calls(x: dict) -> dict:
    a, flat = x["a"], x["flat"]
    b, c, d = flat[1], flat[2], flat[3]
    return {
        "K4": lambda: cuda_cholesky.cholesky_cuda(a),
        "K5": lambda: cuda_gp.gp_fused_cuda(*flat),
        "K10": lambda: cuda_gp_lml.lml_quad_logdet_cuda(b, c, d),
        "K10_emit_w": lambda: cuda_gp_lml.lml_quad_logdet_cuda(b, c, d, True),
    }


def clock_split(lib, run, phases) -> dict:
    """Median over 5 launches of ``run`` of each phase of block 0, and the
    steps of the last launch, in µs."""
    fn = lib.cmi_chol_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stamps = (ctypes.c_ulonglong * 16)()
    rows, ghz = [], []
    for _ in range(5):
        run()
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)), "stamps")
        clk = np.array(stamps[:len(phases) + 1], dtype=np.float64)
        ns = np.array(stamps[8:9 + len(phases)], dtype=np.float64)
        rate = (clk[-1] - clk[0]) / (ns[-1] - ns[0])  # clocks per ns
        ghz.append(rate)
        rows.append(np.diff(clk) / rate / 1e3)
    med = np.median(np.array(rows), axis=0)
    steps_fn = lib.cmi_chol_steps
    steps_fn.argtypes = [ctypes.c_void_p]
    steps_fn.restype = ctypes.c_int
    steps = (ctypes.c_ulonglong * 16)()
    cuda_build.check(steps_fn(ctypes.cast(steps, ctypes.c_void_p)), "steps")
    rate = float(np.median(ghz))
    return {"sm_clock_ghz": rate, "block_us": float(med.sum()),
            "phases_us": dict(zip(phases, map(float, med))),
            "steps_us_last_launch": {
                name: steps[i] / rate / 1e3 for i, name in STEP_NAMES.items()
                if steps[i]}}


def _stamped():
    """The stamped builds of K4 (cholesky.cu) and K10 (gp.cu)."""
    steps = ([*chol_probe.STEPS, *W_STEPS], "")
    k4 = variant_library("chol_band_k4_stamped", {
        "cholesky.cu": (K4_STAMPS, chol_probe.STAMP_READER),
        "cholesky_common.cuh": steps}, units=("cholesky.cu",))
    k10 = variant_library("chol_band_k10_stamped", {
        "gp.cu": (K10_STAMPS, chol_probe.STAMP_READER),
        "cholesky_common.cuh": steps}, units=("gp.cu",))
    return k4, k10


def _stamped_runs(k4, k10, x: dict) -> dict:
    a, flat = x["a"], x["flat"]
    b, c, d = flat[1], flat[2], flat[3]
    batch, n = b.shape[0], b.shape[-1]
    device, stream = cuda_build.launch_args(b)
    l, w = torch.empty_like(a), torch.empty_like(b)
    out = torch.empty((batch, 2), device=b.device)
    alpha = torch.empty_like(c)

    def run_k4():
        cuda_build.check(k4.cmi_chol_factor(a.data_ptr(), l.data_ptr(),
                                            batch, n, device, stream), "k4")

    def run_k10():
        cuda_build.check(k10.cmi_gp_lml(
            b.data_ptr(), c.data_ptr(), d.data_ptr(), out.data_ptr(),
            w.data_ptr(), alpha.data_ptr(), batch, n, 1, device, stream),
            "k10")
    return {"K4": (run_k4, K4_PHASES), "K10_emit_w": (run_k10, K10_PHASES)}


def routes(dev, card: str) -> None:
    """One line a shape of :data:`TIMED` (``routes`` in the docstring)."""
    for batch, n in TIMED:
        x = _inputs(batch, n, dev)
        a, fixture, flat = x["a"], x["fixture"], x["flat"]
        kernels = _timed_calls(x)
        bf, cf, df = fixture[1], fixture[2], fixture[3]
        b, c, d = flat[1], flat[2], flat[3]

        def lml_step(fn):
            args = [t.clone().requires_grad_(True) for t in (bf, cf, df)]
            fn(*args).sum().backward()

        row = {
            "K4": {"kernel_ms": median_ms(kernels["K4"]),
                   "plain_ms": median_ms(
                       lambda: cuda_cholesky.cholesky_plain(a), calls=5,
                       warmup=1),
                   "route_before": "torch.linalg.cholesky_ex",
                   "route_before_ms": median_ms(
                       lambda: torch.linalg.cholesky_ex(a))},
            "K5": {"kernel_ms": median_ms(kernels["K5"]),
                   "plain_ms": median_ms(
                       lambda: cuda_gp.gp_fused_plain(*flat), calls=5,
                       warmup=1),
                   "method_pallas_ms": median_ms(
                       lambda: gp.gp_mean_variance(*fixture,
                                                   method="pallas")),
                   "route_before": "cuda_gp.gp_schur_route (Schur on K3)",
                   "route_before_ms": median_ms(
                       lambda: cuda_gp.gp_schur_route(*fixture)),
                   "solve_method_ms": median_ms(
                       lambda: gp.gp_mean_variance(*fixture,
                                                   method="solve"))},
            "K10": {"kernel_ms": median_ms(kernels["K10"]),
                    "plain_ms": median_ms(
                        lambda: cuda_gp_lml.lml_quad_logdet_plain(b, c, d),
                        calls=5, warmup=1)},
            "K10_emit_w": {
                "kernel_ms": median_ms(kernels["K10_emit_w"]),
                "plain_ms": median_ms(
                    lambda: cuda_gp_lml.lml_quad_logdet_plain(b, c, d, True),
                    calls=5, warmup=1),
                "fused_lml_forward_backward_ms": median_ms(
                    lambda: lml_step(
                        cuda_gp_lml.gp_log_marginal_likelihood_fused)),
                "route_before": "torch.linalg LML forward and backward "
                                "(models.gp.gp_log_marginal_likelihood)",
                "route_before_ms": median_ms(
                    lambda: lml_step(gp.gp_log_marginal_likelihood))},
        }
        print(json.dumps({"probe": "routes", "case": f"{batch}x{n}", **row,
                          "card": card}), flush=True)


UNITS = ("cholesky.cu", "gp.cu")


def _launchers(cdll, x: dict) -> dict:
    """Bare ctypes launches of the packed instances of K4, K5 and K10 (both
    variants) of one library into output buffers of their own; each
    returns its outputs by name."""
    a, (ga, gb, gc, gd, ge) = x["a"], x["flat"]
    batch, n = gb.shape[0], gb.shape[-1]
    device, stream = cuda_build.launch_args(gb)
    l = torch.empty_like(a)
    out5, out10, out10w = (torch.empty((batch, 2), device=gb.device)
                           for _ in range(3))
    w, alpha = torch.empty_like(gb), torch.empty_like(gc)

    def k4():
        cuda_build.check(cdll.cmi_chol_factor(
            a.data_ptr(), l.data_ptr(), batch, n, device, stream), "k4")
        return {"L": l}

    def k5():
        cuda_build.check(cdll.cmi_gp_fused(
            ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), gd.data_ptr(),
            ge.data_ptr(), out5.data_ptr(), batch, n, device, stream), "k5")
        return {"mean_var": out5}

    def k10():
        cuda_build.check(cdll.cmi_gp_lml(
            gb.data_ptr(), gc.data_ptr(), gd.data_ptr(), out10.data_ptr(),
            None, None, batch, n, 0, device, stream), "k10")
        return {"quad": out10[:, 0], "logdet": out10[:, 1]}

    def k10w():
        cuda_build.check(cdll.cmi_gp_lml(
            gb.data_ptr(), gc.data_ptr(), gd.data_ptr(), out10w.data_ptr(),
            w.data_ptr(), alpha.data_ptr(), batch, n, 1, device, stream),
            "k10 emit_w")
        return {"quad": out10w[:, 0], "logdet": out10w[:, 1], "W": w,
                "alpha": alpha}

    return {"K4": k4, "K5": k5, "K10": k10, "K10_emit_w": k10w}


def ab(baseline: Path, dev, card: str) -> None:
    """The ``ab`` probe (see the module docstring)."""
    builds = {"baseline": ({}, baseline), "this": ({}, None),
              "t256": (_threads_patch(256), None),
              "t512": (_threads_patch(512), None)}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(
            variant_library, f"chol_band_ab_{k}", edits,
            src or cuda_build.CSRC_DIR, UNITS)
            for k, (edits, src) in builds.items()}
        occ = pool.submit(occupancy)
        libs = {k: f.result() for k, f in futures.items()}
        print(json.dumps({"probe": "occupancy", **occ.result(),
                          "card": card}), flush=True)
    for batch, n in TIMED:
        x = _inputs(batch, n, dev)
        runs = {k: _launchers(v, x) for k, v in libs.items()}
        rows = {}
        for name in runs["this"]:
            outs = {k: {o: t.clone() for o, t in runs[k][name]().items()}
                    for k in libs}
            torch.cuda.synchronize()
            same = {ref: {k: [o for o in outs[k]
                              if torch.equal(outs[k][o], outs[ref][o])]
                          for k in libs if k != ref}
                    for ref in ("baseline", "this")}
            ms = {k: [] for k in libs}
            for k in ("baseline", "this", "this", "baseline",
                      "t256", "t512", "t512", "t256"):
                ms[k].append(median_ms(runs[k][name]))
            rows[name] = {"bitwise_equal_outputs": same, "ms": ms}
        print(json.dumps({"probe": "ab", "case": f"{batch}x{n}",
                          "kernels": rows, "card": card}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    if sys.argv[1:2] == ["routes"]:
        routes(dev, card)
        return 0
    if sys.argv[1:2] == ["ab"]:
        ab(Path(sys.argv[2]), dev, card)
        return 0
    print(json.dumps({"probe": "occupancy", **occupancy(), "card": card}),
          flush=True)
    for batch, n in TIMED:
        calls = _timed_calls(_inputs(batch, n, dev))
        print(json.dumps({"probe": "wrapper", "case": f"{batch}x{n}",
                          **{k: median_ms(f) for k, f in calls.items()},
                          "card": card}), flush=True)
    k4, k10 = _stamped()
    for batch, n in SPLIT:
        runs = _stamped_runs(k4, k10, _inputs(batch, n, dev))
        for name, (run, phases) in runs.items():
            print(json.dumps({"probe": "clock_split", "kernel": name,
                              "case": f"{batch}x{n}",
                              **clock_split(k4 if name == "K4" else k10,
                                            run, phases),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
