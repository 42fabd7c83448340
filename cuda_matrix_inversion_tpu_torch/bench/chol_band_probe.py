"""Probes of the Cholesky kernels' packed instances (129 ≤ n ≤ 256): K4
(``csrc/cholesky.cu::chol_factor_band_kernel``), K5
(``csrc/gp.cu::gp_chol_band_kernel``) and K10 with and without W
(``gp_lml_band_kernel``), on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe routes
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe ab BASELINE_CSRC
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe wrappers ROOT [ROOT ...]
    python -m cuda_matrix_inversion_tpu_torch.bench.chol_band_probe latency

Prints one JSON line a probe (``routes``, ``ab``, ``wrappers`` and
``latency`` alone with their arguments):

- ``occupancy``: for each kernel at n = 160, 192, 224 and 256 and each
  block size (256 and 512 threads, the instances ``chol_band_threads``
  and ``chol_band_plan`` choose from; for K4 and K5, 256 threads is the
  two-barrier factor and 512 the band factor), the registers a thread and the local memory (spills) from
  ``cudaFuncGetAttributes``, the shared memory a block asks for, and the
  blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
  ``ptxas -v``'s lines.
- ``wrapper``: each kernel through its wrapper at :data:`TIMED` (median of
  20 CUDA-event timings after 3 warm-up calls; 1600 = 100 draws repeated).
- ``clock_split``: thread 0 of block 0 stamping ``clock64`` and
  ``%globaltimer`` at the phases of K4 (load, factor, L's store), of K5
  (load, factor with the border, dot products) and of K10 with W (load,
  factor, W = L⁻¹ in place, t = Wd with α = Wᵀt and W's store, the
  epilogue), µs at the SM clock the two timers give, median of 5
  launches; and in the last launch the band factor's steps summed over
  the panels, for thread 0 (the panel warp: its wait for the next column,
  the block's loads and pivots, the block's stores and the strip's first
  rows) and thread 32 (the first tile warp: its wait for
  the panel, its pieces' strip rows, its pieces of the next column, its
  wait for every strip row, its tiles of the rest), and the in-place W's
  (thread 0's column chain, the diagonal block's copy, its tiles and the
  barrier, the strip's copy and its barrier), at :data:`SPLIT`.  The
  stamps cost the two threads time.
- ``routes``: at :data:`TIMED`, each kernel beside the route it replaced
  in the band (K4: ``torch.linalg.cholesky_ex``; K5: the Schur solve on K3,
  ``cuda_gp.gp_schur_route``; K10: one ``torch.linalg`` LML forward and
  backward, ``models.gp.gp_log_marginal_likelihood``), its plain version,
  the GP ``pallas`` method and one fit step's forward and backward through
  the fused LML, and the GP ``solve`` method.
- ``ab`` (``BASELINE_CSRC``: another checkout's ``csrc/``, e.g. the parent
  unpacked by ``git archive`` under ``build/``): ``occupancy`` of this
  tree (both block sizes), then at :data:`TIMED` each kernel of the
  baseline, of this tree (its own instances) and of this tree with every
  packed instance at 256 and at 512 threads (K4 and K5 pinned to the
  two-barrier and to the band factor at every batch), bare ctypes launches
  on the same inputs: which outputs are bitwise equal to the baseline's
  and to this tree's, and each build's times, timed in one order and then
  in the reverse order (CUDA events, median of 20 after warm-up).
- ``wrappers`` (``ROOT``: checkouts' roots, e.g. the parent unpacked under
  ``build/`` and this tree's): the ``wrapper`` lines of each checkout's
  package, each in a process of its own with ``PYTHONPATH`` on its root,
  in the order given and then in the reverse order, every checkout's
  kernels built first.
- ``latency``: clocks a dependent iteration of a pivot step of the 8 × 8
  diagonal block (``chol_block_factor``) alone and beside 7 and 15 warps
  of trailing tiles, of ``__syncthreads`` at 256 and 512 threads, of a
  hand-off and back by named barriers and by mbarriers, and of the IEEE
  sqrt and reciprocal and division chains (:data:`LATENCY`).

The stamped, occupancy and block-size builds come from a copy of
``csrc/`` with patches and a reader (``gp_ns_probe.variant_library``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
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
TIMED = ((100, 160), (100, 192), (100, 224), (100, 256), (200, 224),
         (1600, 224), (1600, 256))
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
# `threads` (256 or 512, the templated instances; for K4 and K5, 256 is
# the two-barrier instance and 512 the band factor's, chol_band_plan).
CHOL_OCCUPANCY = _OCC + """
extern "C" int cmi_probe_band_occupancy(int which, int n, int threads,
                                        int* out) {
  const size_t m = static_cast<size_t>(chol_packed_floats(n)) * sizeof(float);
  out[3] = static_cast<int>(m);
  const void* fn = threads == 512 ? (const void*)chol_factor_band_kernel<true>
                                  : (const void*)chol_factor_band_kernel<false>;
  return probe_band_occupancy(fn, threads, m, out);
}
"""
GP_OCCUPANCY = _OCC + """
extern "C" int cmi_probe_band_occupancy(int which, int n, int threads,
                                        int* out) {
  const bool wide = threads == 512;
  const void* fn =
      which == 1 ? (wide ? (const void*)gp_chol_band_kernel<true>
                         : (const void*)gp_chol_band_kernel<false>)
      : which == 2 ? (wide ? (const void*)gp_lml_band_kernel<false, 512>
                           : (const void*)gp_lml_band_kernel<false, 256>)
                   : (wide ? (const void*)gp_lml_band_kernel<true, 512>
                           : (const void*)gp_lml_band_kernel<true, 256>);
  const size_t smem =
      which == 1 ? (wide ? chol_band_floats(n, true)
                         : chol_packed_floats(n) + 2ull * n) * sizeof(float)
                 : gp_lml_band_floats(n, which == 3) * sizeof(float);
  out[3] = static_cast<int>(smem);
  return probe_band_occupancy(fn, threads, smem, out);
}
"""
# (name, unit, which, kernel symbol as ptxas prints it with the block size
# "{t}" or, for K4 and K5, the band factor "{b}" (1 at 512 threads))
KERNELS = (("K4", "cholesky.cu", 0, "chol_factor_band_kernelILb{b}E"),
           ("K5", "gp.cu", 1, "gp_chol_band_kernelILb{b}E"),
           ("K10", "gp.cu", 2, "gp_lml_band_kernelILb0ELi{t}E"),
           ("K10_emit_w", "gp.cu", 3, "gp_lml_band_kernelILb1ELi{t}E"))
THREADS = (256, 512)
# chol_band_threads' body and chol_band_plan's test for the two-barrier
# factor, and the bodies that pin every packed instance to one block size
# (the ab mode's 256 and 512 builds: K4 and K5 on the two-barrier factor
# and on the band factor at every batch).
BAND_THREADS = "  return 2 * (smem + 1024) <= 233472 ? 256 : 512;\n"
BAND_PLAN = ("  if (batch > chol_sm_count(device) &&\n"
             "      chol_band_threads(two_barrier) == "
             "chol_plan_threads(false))\n")


def _threads_patch(threads: int):
    return {"cholesky_common.cuh": (
        [(BAND_THREADS, f"  return {threads};\n", 1),
         (BAND_PLAN, f"  if ({str(threads == 256).lower()})\n", 1)], "")}


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
# The band factor's steps (chol_factor_band), for thread 0 (the panel
# warp's lane 0: ids 0 to 2) and thread 32 (the first tile warp's lane 0:
# ids 3 to 7), each the clocks since the thread's previous step.
_TSTEP_DEFS = """__shared__ unsigned long long chol_tstep_last;
__device__ __forceinline__ void chol_tstep(int s) {
  if (blockIdx.x == 0 && threadIdx.x == 32) {
    const unsigned long long t = clock64();
    if (s >= 0) chol_step_sh[s] += t - chol_tstep_last;
    chol_tstep_last = t;
  }
}

"""
BAND_STEPS = [
    ("// A trailing-update tile: 64 rows",
     chol_probe._STEP_DEFS + _TSTEP_DEFS
     + "// A trailing-update tile: 64 rows", 1),
    ("      if (k0 > 0) chol_bar_sync(kColumnTaken, blockDim.x);\n",
     "      if (k0 > 0) chol_bar_sync(kColumnTaken, blockDim.x);\n"
     "      chol_step(0);\n", 1),
    ("  chol_block_factor<NB>(b, inv);\n#pragma unroll\n"
     "  for (int i = 0; i < NB; ++i)\n    if (lane == i && i < w) {\n",
     "  chol_block_factor<NB>(b, inv);\n  chol_step(1);\n#pragma unroll\n"
     "  for (int i = 0; i < NB; ++i)\n    if (lane == i && i < w) {\n", 1),
    ("                               n, nr, lay);\n"
     "      if (k0 + NB < n) chol_bar_arrive(kPanelReady);\n",
     "                               n, nr, lay);\n      chol_step(2);\n"
     "      if (k0 + NB < n) chol_bar_arrive(kPanelReady);\n", 1),
    ("      chol_bar_sync(kPanelReady, blockDim.x);\n",
     "      chol_bar_sync(kPanelReady, blockDim.x);\n      chol_tstep(3);\n",
     1),
    ("        __syncwarp();\n        for (int q = tw; q < pieces; q += ntw)\n",
     "        chol_tstep(4);\n        __syncwarp();\n"
     "        for (int q = tw; q < pieces; q += ntw)\n", 1),
    ("      chol_bar_arrive(kColumnTaken);\n"
     "      chol_bar_sync(kStripDone, blockDim.x - 32);\n",
     "      chol_tstep(5);\n      chol_bar_arrive(kColumnTaken);\n"
     "      chol_bar_sync(kStripDone, blockDim.x - 32);\n"
     "      chol_tstep(6);\n", 1),
    ("        t -= cols;\n      }\n    }\n  }\n  __syncthreads();\n}\n",
     "        t -= cols;\n      }\n      chol_tstep(7);\n    }\n  }\n"
     "  __syncthreads();\n}\n", 1),
]
STEP_NAMES = {0: "factor, panel warp: waiting for the next column "
                 "(kColumnTaken)",
              1: "factor, panel warp: the diagonal block's loads and pivots",
              2: "factor, panel warp: the block's and inv's stores, the "
                 "strip's first 8 rows",
              3: "factor, tile warp 0: waiting for the panel (kPanelReady)",
              4: "factor, tile warp 0: the block's loads and its pieces' "
                 "strip rows",
              5: "factor, tile warp 0: its pieces of the next panel's column",
              6: "factor, tile warp 0: waiting for every strip row "
                 "(kStripDone)",
              7: "factor, tile warp 0: its tiles of the rest of the panel",
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
_STEPS_START = "  chol_step(-1);\n  chol_tstep(-1);\n"
K4_STAMPS = [
    ('#include "cholesky_common.cuh"\n', chol_probe._STAMP_DEFS, 1),
    ("  const CholPacked lay;\n  float* out =", "  const CholPacked lay;\n"
     + _START + "  float* out =", 1),
    ("  __syncthreads();\n  if constexpr (kBand) {\n",
     "  __syncthreads();\n  chol_stamp();\n" + _STEPS_START
     + "  if constexpr (kBand) {\n", 1),
    ("    chol_factor(smem, n, lay);\n  }\n  for (int i = threadIdx.x",
     "    chol_factor(smem, n, lay);\n  }\n  chol_stamp();\n"
     "  for (int i = threadIdx.x", 1),
    ("      for (int j = lane; j < n; j += 32) dst[j] = j <= i ? src[j] : "
     "0.f;\n    }\n  }\n}\n",
     "      for (int j = lane; j < n; j += 32) dst[j] = j <= i ? src[j] : "
     "0.f;\n    }\n  }\n" + _END + "}\n", 1),
]
K4_PHASES = ("load", "factor", "L's store (float4 rows after the factor)")
K5_STAMPS = [
    ("  extern __shared__ __align__(16) float smem[];\n"
     "  if constexpr (kBand) {\n    gp_chol_border_body<T>(",
     "  extern __shared__ __align__(16) float smem[];\n" + _START
     + "  if constexpr (kBand) {\n    gp_chol_border_body<T>(", 1),
    ("  __syncthreads();\n  chol_factor_band<true>(K, n);  // "
     "ends with a barrier\n",
     "  __syncthreads();\n  chol_stamp();\n" + _STEPS_START
     + "  chol_factor_band<true>(K, n);\n  chol_stamp();\n", 1),
    ("    const float* u = warp == 0 ? yd : ya;\n    float s = 0.f;\n"
     "    for (int i = lane; i < n; i += 32) s = fmaf(ya[i], u[i], s);\n"
     "#pragma unroll\n"
     "    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, "
     "s, o);\n"
     "    if (lane == 0) out[2 * sys + warp] = warp == 0 ? s : e[sys] - s;\n"
     "  }\n}\n",
     "    const float* u = warp == 0 ? yd : ya;\n    float s = 0.f;\n"
     "    for (int i = lane; i < n; i += 32) s = fmaf(ya[i], u[i], s);\n"
     "#pragma unroll\n"
     "    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, "
     "s, o);\n"
     "    if (lane == 0) out[2 * sys + warp] = warp == 0 ? s : e[sys] - s;\n"
     "  }\n" + _END + "}\n", 1),
]
K5_PHASES = ("load (K and the border)", "factor with the border",
             "dot products")
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
     "  __syncthreads();\n  chol_stamp();\n" + _STEPS_START
     + "  chol_factor(K, n, lay);\n  chol_stamp();\n", 1),
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


# The ``latency`` probe, appended to a copy of cholesky.cu.  lat_pivots:
# warp 0 factors one 8 x 8 diagonal block (chol_block_factor, the pivot
# steps of the factor's panel warp) `iters` times, each factor fed by the
# last (its first pivot takes the previous result times 0), alone in its
# block (T = 32) or beside T / 32 - 1 warps running trailing tiles
# (chol_tile on a packed 256 x 256 matrix) until it is done.  lat_bar: a
# loop of __syncthreads of T threads; lat_handoff: warp 0 and the other
# warps hand a token back and forth, one round trip an iteration, by two
# named barriers (bar.arrive on one side, bar.sync on the other, the
# factor's hand-offs) or by two mbarriers (one elected lane a warp
# arrives, every lane waits on the phase).  lat_chain: dependent IEEE sqrt
# and reciprocal (a pivot's scalar chain), and IEEE divisions.
LATENCY = r"""
__device__ unsigned long long lat_out[16];

template <int T, bool TILES>
__global__ void __launch_bounds__(T > 32 ? T : 32)
    lat_pivots(const float* a, float* sink, int iters, int slot) {
  extern __shared__ __align__(16) float smem[];
  __shared__ volatile int done;
  const CholPacked lay;
  const int n = 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  chol_load(a, smem, n, lay, [](int, int, float v) { return v; });
  if (threadIdx.x == 0) done = 0;
  __syncthreads();
  if (warp == 0) {
    float b0[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) b0[i][j] = smem[lay.row(i) + j];
    float z = 0.f;
    const unsigned long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
      float b[8][8], inv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) b[i][j] = b0[i][j];
      b[0][0] = __fadd_rn(b[0][0], __fmul_rn(z, 0.f));
      chol_block_factor<8>(b, inv);
      z = __fadd_rn(b[7][7], inv[7]);
    }
    const unsigned long long t1 = clock64();
    if (lane == 0) {
      lat_out[slot] = t1 - t0;
      done = 1;
    }
    sink[threadIdx.x] = z;
  } else if (TILES) {
    for (int t = warp; !done; t += T / 32 - 1)
      chol_tile_rows<8, true>(
          smem, smem, smem, [=](int i, int j) { return i < n && j <= i; },
          64 + 64 * (t % 3), 8 + 8 * (t % 7), 0, n, lay);
  }
}

template <int T>
__global__ void lat_bar(int iters, int slot) {
  const unsigned long long t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) lat_out[slot] = clock64() - t0;
}

template <int T, bool MBAR>
__global__ void lat_handoff(int iters, int slot) {
  __shared__ uint64_t bars[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        static_cast<unsigned>(__cvta_generic_to_shared(bars))));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
        static_cast<unsigned>(__cvta_generic_to_shared(bars + 1))),
                 "r"(T / 32 - 1));
  }
  __syncthreads();
  auto arrive = [&](int b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
        static_cast<unsigned>(__cvta_generic_to_shared(bars + b))) : "memory");
  };
  auto wait = [&](int b, unsigned parity) {
    unsigned ok;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ok)
          : "r"(static_cast<unsigned>(__cvta_generic_to_shared(bars + b))),
            "r"(parity)
          : "memory");
    } while (!ok);
  };
  const unsigned long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (warp == 0) {
      if (MBAR) {
        if (lane == 0) arrive(0);
        wait(1, i & 1);
      } else {
        asm volatile("bar.arrive 1, %0;" ::"n"(T) : "memory");
        asm volatile("bar.sync 2, %0;" ::"n"(T) : "memory");
      }
    } else {
      if (MBAR) {
        wait(0, i & 1);
        if (lane == 0) arrive(1);
      } else {
        asm volatile("bar.sync 1, %0;" ::"n"(T) : "memory");
        asm volatile("bar.arrive 2, %0;" ::"n"(T) : "memory");
      }
    }
  }
  if (threadIdx.x == 0) lat_out[slot] = clock64() - t0;
}

template <int W>
__global__ void lat_chain(float* sink, int iters, int slot) {
  float x = threadIdx.x * 0.001f + 2.f;
  const unsigned long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (W == 0) x = __fadd_rn(__frcp_rn(__fsqrt_rn(x)), 2.f);
    if (W == 1) x = __fadd_rn(__fdiv_rn(3.f, x), 2.f);
    if (W == 2) x = __fadd_rn(x, 2.f);
  }
  if (threadIdx.x == 0) lat_out[slot] = clock64() - t0;
  sink[threadIdx.x] = x;
}

extern "C" int cmi_chol_latency(const float* a, float* sink, double* out) {
  const int iters = 4096, piv = 512;
  const int smem = chol_packed_floats(256) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lat_pivots<32, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lat_pivots<256, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lat_pivots<512, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lat_pivots<32, false><<<1, 32, smem>>>(a, sink, piv, 0);
  lat_pivots<256, true><<<1, 256, smem>>>(a, sink, piv, 1);
  lat_pivots<512, true><<<1, 512, smem>>>(a, sink, piv, 2);
  lat_bar<256><<<1, 256>>>(iters, 3);
  lat_bar<512><<<1, 512>>>(iters, 4);
  lat_handoff<256, false><<<1, 256>>>(iters, 5);
  lat_handoff<512, false><<<1, 512>>>(iters, 6);
  lat_handoff<256, true><<<1, 256>>>(iters, 7);
  lat_handoff<512, true><<<1, 512>>>(iters, 8);
  lat_chain<0><<<1, 32>>>(sink, iters, 9);
  lat_chain<1><<<1, 32>>>(sink, iters, 10);
  lat_chain<2><<<1, 32>>>(sink, iters, 11);
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long h[16];
  err = cudaMemcpyFromSymbol(h, lat_out, sizeof(h));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int w = 0; w < 3; ++w) out[w] = double(h[w]) / piv / 8;
  for (int w = 3; w < 12; ++w) out[w] = double(h[w]) / iters;
  return static_cast<int>(cudaGetLastError());
}
"""
LATENCY_CASES = ("pivot step alone (1 warp)",
                 "pivot step beside 7 tile warps (256 threads)",
                 "pivot step beside 15 tile warps (512 threads)",
                 "__syncthreads, 256 threads", "__syncthreads, 512 threads",
                 "named-barrier hand-off round trip, 256 threads",
                 "named-barrier hand-off round trip, 512 threads",
                 "mbarrier hand-off round trip, 256 threads",
                 "mbarrier hand-off round trip, 512 threads",
                 "IEEE sqrt + reciprocal + fadd (dependent)",
                 "IEEE division + fadd (dependent)", "fadd (dependent)")


def latency(dev, card: str) -> None:
    """The ``latency`` probe (see the module docstring)."""
    lib = variant_library("chol_band_latency",
                          {"cholesky.cu": ([], LATENCY)},
                          units=("cholesky.cu",))
    fn = lib.cmi_chol_latency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = torch.tensor(make_spd_batch(1, 256, np.random.default_rng(9356))[0],
                     dtype=torch.float32, device=dev).contiguous()
    sink = torch.empty(1024, device=dev)
    out = (ctypes.c_double * len(LATENCY_CASES))()
    for _ in range(2):  # the first launch of each loads its module
        cuda_build.check(fn(a.data_ptr(), sink.data_ptr(),
                            ctypes.cast(out, ctypes.c_void_p)), "latency")
    print(json.dumps({"probe": "latency", "clocks": dict(zip(
        LATENCY_CASES, [float(x) for x in out])), "card": card}), flush=True)


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
                sym = symbol.format(t=threads, b=int(threads == 512))
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
    """The stamped builds of K4 (cholesky.cu) and of K5 and K10 (gp.cu)."""
    steps = ([*BAND_STEPS, *W_STEPS], "")
    k4 = variant_library("chol_band_k4_stamped", {
        "cholesky.cu": (K4_STAMPS, chol_probe.STAMP_READER),
        "cholesky_common.cuh": steps}, units=("cholesky.cu",))
    gp = variant_library("chol_band_gp_stamped", {
        "gp.cu": ([*K10_STAMPS, *K5_STAMPS], chol_probe.STAMP_READER),
        "cholesky_common.cuh": steps}, units=("gp.cu",))
    return k4, gp


def _stamped_runs(k4, gp, x: dict) -> dict:
    a, flat = x["a"], x["flat"]
    ga, b, c, d, ge = flat
    batch, n = b.shape[0], b.shape[-1]
    device, stream = cuda_build.launch_args(b)
    l, w = torch.empty_like(a), torch.empty_like(b)
    out = torch.empty((batch, 2), device=b.device)
    alpha = torch.empty_like(c)

    def run_k4():
        cuda_build.check(k4.cmi_chol_factor(a.data_ptr(), l.data_ptr(),
                                            batch, n, device, stream), "k4")

    def run_k5():
        cuda_build.check(gp.cmi_gp_fused(
            ga.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            ge.data_ptr(), out.data_ptr(), batch, n, device, stream), "k5")

    def run_k10():
        cuda_build.check(gp.cmi_gp_lml(
            b.data_ptr(), c.data_ptr(), d.data_ptr(), out.data_ptr(),
            w.data_ptr(), alpha.data_ptr(), batch, n, 1, device, stream),
            "k10")
    return {"K4": (k4, run_k4, K4_PHASES), "K5": (gp, run_k5, K5_PHASES),
            "K10_emit_w": (gp, run_k10, K10_PHASES)}


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
    order = list(libs) + list(libs)[::-1]
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
            for k in order:
                ms[k].append(median_ms(runs[k][name]))
            rows[name] = {"bitwise_equal_outputs": same, "ms": ms}
        print(json.dumps({"probe": "ab", "case": f"{batch}x{n}",
                          "kernels": rows, "card": card}), flush=True)


def wrapper_times(dev, card: str) -> None:
    """The ``wrapper`` lines: each kernel through its wrapper at
    :data:`TIMED`, from the package this process imported."""
    for batch, n in TIMED:
        calls = _timed_calls(_inputs(batch, n, dev))
        print(json.dumps({"probe": "wrapper", "case": f"{batch}x{n}",
                          **{k: median_ms(f) for k, f in calls.items()},
                          "csrc": str(cuda_build.CSRC_DIR), "card": card}),
              flush=True)


def wrappers(roots: list[Path], card: str) -> None:
    """The ``wrappers`` probe (see the module docstring)."""
    envs = {r: {**os.environ, "PYTHONPATH": str(r)} for r in roots}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from cuda_matrix_inversion_tpu_torch.ops "
         "import cuda_build; cuda_build.build()"], cwd=r, env=envs[r])
        for r in roots]
    if any(b.wait() for b in builds):
        raise SystemExit("a checkout's kernels did not build")
    for r in roots + roots[::-1]:
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "wrapper-times"],
            cwd=r, env=envs[r], capture_output=True, text=True, check=True)
        for line in run.stdout.splitlines():
            print(json.dumps({**json.loads(line), "root": str(r)}),
                  flush=True)


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
    if sys.argv[1:2] == ["wrappers"]:
        wrappers([Path(r).resolve() for r in sys.argv[2:]], card)
        return 0
    if sys.argv[1:2] == ["wrapper-times"]:
        wrapper_times(dev, card)
        return 0
    if sys.argv[1:2] == ["latency"]:
        latency(dev, card)
        return 0
    print(json.dumps({"probe": "occupancy", **occupancy(), "card": card}),
          flush=True)
    wrapper_times(dev, card)
    k4, gp_lib = _stamped()
    for batch, n in SPLIT:
        runs = _stamped_runs(k4, gp_lib, _inputs(batch, n, dev))
        for name, (lib, run, phases) in runs.items():
            print(json.dumps({"probe": "clock_split", "kernel": name,
                              "case": f"{batch}x{n}",
                              **clock_split(lib, run, phases),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
