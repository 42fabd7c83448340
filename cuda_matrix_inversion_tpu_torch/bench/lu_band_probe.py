"""Probes of K2's cluster instance (``csrc/lu_band.cu``, 129 ≤ n ≤ 256)
on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe
    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe routes [OTHER_ROOT]
    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe ab BASELINE_CSRC [OTHER_CSRC ...]
    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe latency

Prints one JSON line a probe (``routes``, ``ab`` and ``latency`` alone
with their arguments):

- ``occupancy``: for each instance (NP = 160, 192, 224, 256: clusters of
  NP / 32 CTAs), the threads a CTA, the registers a thread and the local
  memory (``cudaFuncGetAttributes``), the shared memory a CTA asks for,
  and ``cudaOccupancyMaxActiveClusters`` (the clusters the card holds at
  once); ``ptxas -v``'s lines.
- ``wrapper``: the kernel through ``cuda_lu.lu_inverse_cuda`` at
  :data:`TIMED` (median of 20 CUDA-event timings after 3 warm-up calls).
- ``clock_split``: two observers in every CTA of the first cluster,
  thread 0 (a tile thread) and lane 0 of the panel warp, stamping
  ``clock64`` (rank 0's thread 0 also ``%globaltimer``) at the steps of
  :data:`STEPS`; a step that repeats (a panel, a back-pass block) is
  summed over its repeats; µs at the SM clock the two timers give, median
  of 5 launches, for each rank and observer, at :data:`SPLIT`.  The stamps
  cost the observers time, so a split CTA runs longer than the unstamped
  kernel.
- ``routes``: at :data:`TIMED` (1600 = 100 draws repeated, the general
  class ``make_square_batch``), the ``lu_pallas`` lane (K2's cluster
  instance and the fp64 polish), the kernel alone, the route the lane
  took before (the blocked LU on K9, ``lu_bign.inverse_lu_big``), the
  plain version (``lu_inverse_plain``), ``torch.linalg.inv``, each lane's
  gate (max‖AA⁻¹−I‖∞ in fp64 on the 100 draws); with ``OTHER_ROOT``
  (another checkout, such as the parent's unpacked with ``git archive``
  under ``build/``) that checkout's ``lu_pallas`` lane on the same draws,
  timed in a process of its own.
- ``ab`` (``BASELINE_CSRC``: another checkout's ``csrc/``, e.g. the parent
  unpacked by ``git archive`` under ``build/``; more trees may follow):
  the occupancy of the baseline's and this tree's builds, then at
  :data:`TIMED` every tree's cluster instance on the same inputs as bare
  ctypes launches in one process: whether ``inv`` and ``ipiv`` are bitwise
  equal to the baseline's on the finite members (and non-finite on the
  same ones), and the times in the order baseline, the others, this, this,
  the others backwards, baseline (CUDA events, median of 20 after
  warm-up).  Exit code 1 if an output differs.
- ``latency``: clocks an iteration of the operations a pivot step chains
  (a dependent redux reduction, a barrier of 4 warps, FFMA, a shuffle,
  MUFU.RCP, a shared load, an IEEE division, a redux with a store, a
  barrier and a load), each in a loop of its own on 4 warps of one block,
  and this tree's ``panel_factor`` alone (128 threads, one panel of NP =
  256 repeated), clocks a panel step.

The stamped and the occupancy builds come from a copy of ``csrc/`` with
patches and a reader (``gp_ns_probe.variant_library``).
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

from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import (
    median_ms,
    variant_library,
)
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_lu, lu_bign
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

UNITS = ("lu_band.cu",)
BAND_NP = (160, 192, 224, 256)
TIMED = ((100, 160), (100, 192), (100, 224), (100, 256), (1600, 256))
SPLIT = ((100, 256), (1600, 256), (100, 160))

# Clock bookkeeping: two observers in each CTA of cluster 0, thread 0 (a
# tile thread) and thread kTileThreads (panel thread 0), each add
# the clocks since their previous stamp to step s (lb_step); lb_finish
# closes the last step after a barrier and copies each observer's sums to
# row 2 rank + observer of lb_probe, and rank 0's thread 0 the globaltimer
# and clock at both ends to row 16.
_DEFS = """
#include <cooperative_groups.h>
__device__ unsigned long long lb_probe[17][20];
__shared__ unsigned long long lb_sh[2][21];
__device__ __forceinline__ int lb_obs() {
  if (blockIdx.x >= cooperative_groups::this_cluster().num_blocks())
    return -1;
  return threadIdx.x == 0 ? 0 : threadIdx.x == kTileThreads ? 1 : -1;
}
__device__ __forceinline__ void lb_start() {
  const int o = lb_obs();
  if (o >= 0) {
    for (int i = 0; i < 20; ++i) lb_sh[o][i] = 0;
    lb_sh[o][20] = clock64();
    if (blockIdx.x == 0 && o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      lb_probe[16][0] = g;
      lb_probe[16][2] = lb_sh[0][20];
    }
  }
}
__device__ __forceinline__ void lb_step(int s) {
  const int o = lb_obs();
  if (o >= 0) {
    const unsigned long long t = clock64();
    lb_sh[o][s] += t - lb_sh[o][20];
    lb_sh[o][20] = t;
  }
}
__device__ __forceinline__ void lb_finish(int s) {
  __syncthreads();
  const int o = lb_obs();
  if (o >= 0) {
    lb_step(s);
    for (int i = 0; i < 20; ++i) lb_probe[2 * blockIdx.x + o][i] = lb_sh[o][i];
    if (blockIdx.x == 0 && o == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      lb_probe[16][1] = g;
      lb_probe[16][3] = clock64();
    }
  }
}
"""
STAMP_READER = """
extern "C" int cmi_lb_stamps(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, lb_probe, sizeof(lb_probe)));
}
"""
OCCUPANCY = """
template <int NP>
int lb_figures(int* out) {
  auto kernel = lu_band_kernel<NP>;
  const size_t smem = LuBand<NP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(LuBand<NP>::C * 132);
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = LuBand<NP>::C;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = clusters;
  out[4] = kBandThreads;
  return 0;
}
extern "C" int cmi_probe_lu_band(int* out) {
  int err = lb_figures<160>(out);
  if (!err) err = lb_figures<192>(out + 5);
  if (!err) err = lb_figures<224>(out + 10);
  if (!err) err = lb_figures<256>(out + 15);
  return err;
}
"""

# The steps of the split, and the (anchor, replacement, count) patches of
# lu_band.cu that stamp them: the tile observer's steps, the panel warp's,
# and those both take.
STEPS = ("load the slab, mbarriers, first cluster barrier",
         "tile: thread 0's wait for the next panel's slot",
         "tile: the panel on the slab (map, owner's columns, U12, rows past)",
         "tile: the tile warps' barrier",
         "tile: U12 stores, the slot's release, the hand-over",
         "U to the workspace, cluster barrier",
         "back pass, tile: wait for a block's triangle",
         "back pass, tile: the block's terms on the rows above",
         "write",
         "panel: wait for the tile warps' hand-over (panel p - 2)",
         "panel: at a change of owner, wait for the positions and panel "
         "p - 1's slot",
         "panel: its columns, apply panel p - 1",
         "panel: factor (4 columns)",
         "panel: store the slot, push it",
         "back pass, panel: wait for the block's rows",
         "back pass, panel: the block's triangle",
         "end of the factor: wait for every warp",
         "end of the back pass: wait for every warp",
         "panel: wait for the slot's release (empty barrier)")
TILE_STEPS = (1, 2, 3, 4, 6, 7)
PANEL_STEPS = (9, 10, 11, 12, 18, 13, 14, 15)
STAMPS = [
    ("constexpr int kYOff = 32;        // Y's first float in a slab row\n",
     "constexpr int kYOff = 32;        // Y's first float in a slab row\n"
     + _DEFS, 1),
    ("  const size_t mat = blockIdx.x / C;\n",
     "  const size_t mat = blockIdx.x / C;\n  lb_start();\n", 1),
    ("  cluster_sync();\n\n  if (tid >= kTileThreads)\n",
     "  cluster_sync();\n  lb_step(0);\n\n  if (tid >= kTileThreads)\n", 1),
    ("    if (tid == 0 && g + 1 < B::kAll)\n"
     "      mbar_wait(full + (g + 1) % kPanels, ((g + 1) / kPanels) & 1);\n"
     "    named_sync<kTileThreads>(1);\n",
     "    lb_step(2);\n    if (tid == 0 && g + 1 < B::kAll)\n"
     "      mbar_wait(full + (g + 1) % kPanels, ((g + 1) / kPanels) & 1);\n"
     "    lb_step(1);\n    named_sync<kTileThreads>(1);\n    lb_step(3);\n",
     1),
    ("      named_arrive<kBandThreads>(2 + (g & 1));\n",
     "      named_arrive<kBandThreads>(2 + (g & 1));\n    lb_step(4);\n", 1),
    ("    if (p >= 2) named_sync<kBandThreads>(2 + (p & 1));\n",
     "    if (p >= 2) named_sync<kBandThreads>(2 + (p & 1));\n"
     "    lb_step(9);\n", 1),
    ("    }\n#pragma unroll\n    for (int t = 0; t < kPanelT; ++t) {\n"
     "      const int s = pt + kPanelThreads * t;\n      v[t] = s < NP",
     "    }\n    lb_step(10);\n#pragma unroll\n"
     "    for (int t = 0; t < kPanelT; ++t) {\n"
     "      const int s = pt + kPanelThreads * t;\n      v[t] = s < NP", 1),
    ("    if (rank > 0) mbar_wait_cluster(empty + jj, 0);\n",
     "    if (rank > 0) mbar_wait_cluster(empty + jj, 0);\n"
     "    lb_step(18);\n", 1),
    ("    panel_factor<NP>(v, pos, k0, pt, reinterpret_cast<int*>(P + 4 * "
     "NP), xc,\n                     psl, lp);\n",
     "    lb_step(11);\n    panel_factor<NP>(v, pos, k0, pt, "
     "reinterpret_cast<int*>(P + 4 * NP), xc,\n                     psl, "
     "lp);\n    lb_step(12);\n", 1),
    ("                peer_addr(posbar, rank + 1));\n",
     "                peer_addr(posbar, rank + 1));\n    lb_step(13);\n", 1),
    ("  __syncthreads();\n\n  // U into the workspace",
     "  __syncthreads();\n  lb_step(16);\n\n  // U into the workspace", 1),
    ("  // or writes a peer's shared memory past this barrier\n"
     "  cluster_sync();\n",
     "  // or writes a peer's shared memory past this barrier\n"
     "  cluster_sync();\n  lb_step(5);\n", 1),
    ("      named_sync<kBandThreads>(4);  // the block's rows have the terms "
     "below\n",
     "      named_sync<kBandThreads>(4);  // the block's rows have the terms "
     "below\n      lb_step(14);\n", 1),
    ("      named_arrive<kBandThreads>(5);  // the block solved\n",
     "      named_arrive<kBandThreads>(5);  // the block solved\n"
     "      lb_step(15);\n", 1),
    ("      named_sync<kBandThreads>(5);  // block b solved\n",
     "      named_sync<kBandThreads>(5);  // block b solved\n"
     "      lb_step(6);\n", 1),
    ("      for (int i = wid >> 3; i < r0 - 8; i += kBackWorkers / 8) "
     "terms(i);\n",
     "      for (int i = wid >> 3; i < r0 - 8; i += kBackWorkers / 8) "
     "terms(i);\n      lb_step(7);\n", 1),
    ("  __syncthreads();\n\n  // the inverse, rows by position",
     "  __syncthreads();\n  lb_step(17);\n\n  // the inverse, rows by "
     "position", 1),
    ("    for (int i = tid; i < n; i += kBandThreads) ipiv[mat * n + i] = "
     "s_ipiv[i];\n}\n",
     "    for (int i = tid; i < n; i += kBandThreads) ipiv[mat * n + i] = "
     "s_ipiv[i];\n  lb_finish(8);\n}\n", 1),
]

# The ``latency`` probe, appended to a copy of lu_band.cu: each case a loop
# of 4096 dependent iterations on 4 warps (the case a template argument: a
# run-time switch in the loop costs more than the operations), and
# panel_factor on 128 threads, one panel repeated 200 times from the same
# registers.
LATENCY = """
__device__ unsigned long long lat_out[16];
template <int W>
__global__ void lat_kernel(float* sink, int iters) {
  __shared__ float buf[1024];
  __shared__ unsigned long long keys[8];
  const int tid = threadIdx.x;
  float x = tid * 0.001f + 1.f;
  unsigned u = tid;
  int idx = tid;
  for (int i = tid; i < 1024; i += blockDim.x) buf[i] = (i * 7 + 1) % 1024;
  __syncthreads();
  const unsigned long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (W == 0) u = __reduce_max_sync(0xffffffffu, u + i);
    if (W == 1) asm volatile("bar.sync 6, 128;" ::: "memory");
    if (W == 2) x = __fmaf_rn(x, 1.0001f, 0.5f);
    if (W == 3) x = __shfl_sync(0xffffffffu, x, (tid + 1) & 31) + 1.f;
    if (W == 4) x = div_rcp(x) + 1.f;
    if (W == 5) idx = static_cast<int>(buf[idx & 1023]);
    if (W == 6) x = 3.f / x + 1.f;
    if (W == 7) {
      u = __reduce_max_sync(0xffffffffu, u + i);
      if ((tid & 31) == 0) keys[tid >> 5] = u;
      asm volatile("bar.sync 6, 128;" ::: "memory");
      u = static_cast<unsigned>(keys[i & 3]) + 1;
    }
  }
  const unsigned long long t1 = clock64();
  if (tid == 0) lat_out[W] = t1 - t0;
  sink[tid] = x + u + idx;
}
__global__ void lat_factor(const float* a, float* sink, int iters) {
  constexpr int NP = 256;
  __shared__ PanelXchg xc;
  __shared__ int tab[16];
  const int pt = threadIdx.x;
  float4 v0[kPanelT], v[kPanelT], pr[4];
  int pos0[kPanelT], pos[kPanelT], psl[4];
  for (int t = 0; t < kPanelT; ++t) {
    const int s = pt + kPanelThreads * t;
    v0[t] = ld4(a + 4 * s);
    pos0[t] = s;
  }
  unsigned long long t0 = 0;
  for (int it = 0; it <= iters; ++it) {
    named_sync<kPanelThreads>(6);
    if (it == 1) t0 = clock64();
    for (int t = 0; t < kPanelT; ++t) {
      v[t] = v0[t];
      pos[t] = pos0[t];
    }
    panel_factor<NP>(v, pos, 0, pt, tab, &xc, psl, pr);
  }
  named_sync<kPanelThreads>(6);
  if (pt == 0) lat_out[8] = clock64() - t0;
  float acc = 0.f;
  for (int t = 0; t < kPanelT; ++t) acc += v[t].x + v[t].w + pos[t];
  sink[pt] = acc + psl[0] + pr[3].x;
}
extern "C" int cmi_lb_latency(const float* a, float* sink, double* out) {
  const int iters = 4096;
  lat_kernel<0><<<1, 128>>>(sink, iters);
  lat_kernel<1><<<1, 128>>>(sink, iters);
  lat_kernel<2><<<1, 128>>>(sink, iters);
  lat_kernel<3><<<1, 128>>>(sink, iters);
  lat_kernel<4><<<1, 128>>>(sink, iters);
  lat_kernel<5><<<1, 128>>>(sink, iters);
  lat_kernel<6><<<1, 128>>>(sink, iters);
  lat_kernel<7><<<1, 128>>>(sink, iters);
  lat_factor<<<1, kPanelThreads>>>(a, sink, 200);
  unsigned long long h[16];
  cudaError_t err = cudaMemcpyFromSymbol(h, lat_out, sizeof(h));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int w = 0; w < 8; ++w) out[w] = double(h[w]) / iters;
  out[8] = double(h[8]) / 200 / 4;
  return static_cast<int>(cudaGetLastError());
}
"""
LATENCY_CASES = ("redux (dependent)", "bar.sync of 4 warps", "ffma (dependent)",
                 "shfl + fadd", "div_rcp (MUFU.RCP, 2 FFMA) + fadd",
                 "shared load chase", "IEEE division + fadd",
                 "redux, store, bar.sync, load",
                 "panel_factor<256> alone, a step")

# Timed in another checkout's process by ``routes OTHER_ROOT``: its
# lu_pallas lane on this probe's draws, one JSON line of ms by shape.
_OTHER_LANE = """
import json, sys
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm
from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import median_ms
lane = get_inverse_algorithm("lu_pallas")
out = {}
for path in sys.argv[1:]:
    a = torch.from_numpy(np.load(path)).cuda()
    out[path] = median_ms(lambda: lane(a))
print(json.dumps(out))
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def _draws(batch: int, n: int, dev) -> tuple:
    """(100 draws as NumPy, the batch on the device: the draws repeated)."""
    a = make_square_batch(100, n, np.random.default_rng(7800 + n)).astype(
        np.float32)
    at = torch.tensor(a, device=dev).repeat(batch // 100, 1, 1).contiguous()
    return a, at


def occupancy(src: Path = cuda_build.CSRC_DIR, name: str = "occ") -> dict:
    """The occupancy figures of the instances built from ``src``."""
    lib = variant_library(f"lu_band_{name}", {"lu_band.cu": ([], OCCUPANCY)},
                          src=src, units=UNITS, flags=("-Xptxas", "-v"))
    fn = lib.cmi_probe_lu_band
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (5 * len(BAND_NP)))()
    cuda_build.check(fn(ctypes.cast(out, ctypes.c_void_p)), "occupancy")
    lines = lib.compiler_log.splitlines()
    ptxas = [x.strip() for i, line in enumerate(lines)
             if "Compiling entry function" in line and "lu_band" in line
             for x in lines[i:i + 4] if "registers" in x or "spill" in x]
    return {"instances": {f"NP{np_}": {
        "ctas_a_cluster": np_ // 32, "threads": out[5 * i + 4],
        "registers": out[5 * i], "local_bytes": out[5 * i + 1],
        "smem_bytes": out[5 * i + 2], "max_active_clusters": out[5 * i + 3]}
        for i, np_ in enumerate(BAND_NP)}, "ptxas": ptxas}


def clock_split(lib, a) -> dict:
    """Median over 5 launches of each step, for each rank of cluster 0 and
    each observer (the tile thread, the panel warp's lane 0)."""
    fn = lib.cmi_lb_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batch, n = a.shape[0], a.shape[-1]
    clusters = cuda_lu.band_np(n) // 32
    inv = torch.empty_like(a)
    ipiv = torch.empty((batch, n), dtype=torch.int32, device=a.device)
    ws = torch.empty((batch, cuda_lu.band_np(n) ** 2), device=a.device)
    device, stream = cuda_build.launch_args(a)
    stamps = (ctypes.c_ulonglong * (17 * 20))()
    rows, ghz = [], []
    for _ in range(5):
        cuda_build.check(lib.cmi_lu_inverse_band(
            a.data_ptr(), inv.data_ptr(), ipiv.data_ptr(), ws.data_ptr(),
            batch, n, device, stream), "stamped lu band")
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)), "stamps")
        rate = ((stamps[16 * 20 + 3] - stamps[16 * 20 + 2])
                / (stamps[16 * 20 + 1] - stamps[16 * 20 + 0]))  # clocks / ns
        ghz.append(rate)
        rows.append([[[stamps[20 * (2 * r + o) + s] / rate / 1e3
                       for s in range(len(STEPS))] for o in range(2)]
                     for r in range(clusters)])
    med = np.median(np.array(rows), axis=0)

    def named(m, steps):
        return {STEPS[s]: float(m[s]) for s in steps}

    shared = (0, 16, 5, 17, 8)
    return {"sm_clock_ghz": float(np.median(ghz)),
            "ranks": [{"cta_us": float(m[0].sum()),
                       "tile": named(m[0], shared[:2] + TILE_STEPS
                                     + shared[2:]),
                       "panel": named(m[1], shared[:2] + PANEL_STEPS
                                      + shared[2:])}
                      for m in med]}


def routes(dev, card: str, other: Path | None) -> None:
    """One line a shape of :data:`TIMED` (``routes`` in the docstring)."""
    lane = get_inverse_algorithm("lu_pallas")
    other_ms = {}
    if other is not None:
        tmp = cuda_build.BUILD_DIR / "lu_band_routes"
        tmp.mkdir(parents=True, exist_ok=True)
        paths = []
        for batch, n in TIMED:
            path = tmp / f"a_{batch}x{n}.npy"
            np.save(path, _draws(batch, n, "cpu")[1].numpy())
            paths.append(str(path))
        res = subprocess.run([sys.executable, "-c", _OTHER_LANE, *paths],
                             cwd=other, capture_output=True, text=True,
                             check=True)
        other_ms = json.loads(res.stdout.strip().splitlines()[-1])
    for batch, n in TIMED:
        a, at = _draws(batch, n, dev)

        def gate(fn):
            return identity_error_inf(a, fn(at)[:100].cpu().numpy())

        row = {"probe": "routes", "case": f"{batch}x{n}",
               "lu_pallas_lane": {"ms": median_ms(lambda: lane(at)),
                                  "gate": gate(lane)},
               "kernel_ms": median_ms(lambda: cuda_lu.lu_inverse_cuda(at)),
               "blocked_route": {
                   "ms": median_ms(lambda: lu_bign.inverse_lu_big(at)),
                   "gate": gate(lu_bign.inverse_lu_big)},
               "plain_ms": median_ms(lambda: cuda_lu.lu_inverse_plain(at),
                                     calls=5, warmup=1),
               "torch_linalg_inv_ms": median_ms(
                   lambda: torch.linalg.inv(at))}
        if other is not None:
            row["other_lu_pallas_ms"] = other_ms[str(
                cuda_build.BUILD_DIR / "lu_band_routes"
                / f"a_{batch}x{n}.npy")]
        print(json.dumps({**row, "card": card}), flush=True)


def _bare(lib, a):
    """A bare ctypes launch of ``lib``'s cluster instance on ``a`` into
    buffers of its own; returns ``(inv, ipiv)``."""
    batch, n = a.shape[0], a.shape[-1]
    inv = torch.empty_like(a)
    ipiv = torch.empty((batch, n), dtype=torch.int32, device=a.device)
    ws = torch.empty((batch, cuda_lu.band_np(n) ** 2), device=a.device)
    device, stream = cuda_build.launch_args(a)

    def run():
        cuda_build.check(lib.cmi_lu_inverse_band(
            a.data_ptr(), inv.data_ptr(), ipiv.data_ptr(), ws.data_ptr(),
            batch, n, device, stream), "lu band")
        return inv, ipiv
    return run


def ab(trees: list[Path], dev, card: str) -> int:
    """The ``ab`` probe: returns 1 if an output differs from the
    baseline's (``trees[0]``)."""
    srcs = {"baseline": trees[0]}
    srcs.update((str(t), t) for t in trees[1:])
    srcs["this"] = cuda_build.CSRC_DIR
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        libs = {k: pool.submit(variant_library, f"lu_band_ab_{i}", {},
                               src, UNITS)
                for i, (k, src) in enumerate(srcs.items())}
        occ = {k: pool.submit(occupancy, srcs[k], f"occ_{k}")
               for k in ("baseline", "this")}
        libs = {k: f.result() for k, f in libs.items()}
        for k, f in occ.items():
            print(json.dumps({"probe": "occupancy", "build": k,
                              **f.result(), "card": card}), flush=True)
    bad = 0
    for batch, n in TIMED:
        at = _draws(batch, n, dev)[1]
        runs = {k: _bare(lib, at) for k, lib in libs.items()}
        outs = {k: [t.clone() for t in run()] for k, run in runs.items()}
        torch.cuda.synchronize()
        x0, p0 = outs["baseline"]
        ok = torch.isfinite(x0).all(dim=(1, 2))
        same = {}
        for k, (x1, p1) in outs.items():
            same[k] = (torch.equal(torch.isfinite(x1).all(dim=(1, 2)), ok)
                       and torch.equal(x0[ok], x1[ok])
                       and torch.equal(p0[ok], p1[ok]))
            bad |= not same[k]
        ms = {k: [] for k in libs}
        for k in list(libs) + list(libs)[::-1]:
            ms[k].append(median_ms(runs[k]))
        print(json.dumps({"probe": "ab", "case": f"{batch}x{n}",
                          "inv_ipiv_bitwise_equal": same, "ms": ms,
                          "card": card}), flush=True)
    return int(bad)


def latency(dev, card: str) -> None:
    """The ``latency`` probe (see the module docstring)."""
    lib = variant_library("lu_band_latency", {"lu_band.cu": ([], LATENCY)},
                          units=UNITS)
    fn = lib.cmi_lb_latency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = torch.tensor(_draws(100, 256, "cpu")[0][0, :, :4].copy(),
                     device=dev).contiguous()
    sink = torch.empty(1024, device=dev)
    out = (ctypes.c_double * 9)()
    for _ in range(2):  # the first launch of each loads its module
        cuda_build.check(fn(a.data_ptr(), sink.data_ptr(),
                            ctypes.cast(out, ctypes.c_void_p)), "latency")
    print(json.dumps({"probe": "latency", "clocks": dict(zip(
        LATENCY_CASES, [float(x) for x in out])), "card": card}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    if sys.argv[1:2] == ["routes"]:
        routes(dev, card, Path(sys.argv[2]) if len(sys.argv) > 2 else None)
        return 0
    if sys.argv[1:2] == ["ab"]:
        return ab([Path(x) for x in sys.argv[2:]], dev, card)
    if sys.argv[1:2] == ["latency"]:
        latency(dev, card)
        return 0
    print(json.dumps({"probe": "occupancy", **occupancy(), "card": card}),
          flush=True)
    stamped = variant_library("lu_band_stamped",
                              {"lu_band.cu": (STAMPS, STAMP_READER)},
                              units=UNITS)
    for batch, n in TIMED:
        at = _draws(batch, n, dev)[1]
        print(json.dumps({"probe": "wrapper", "case": f"{batch}x{n}",
                          "ms": median_ms(
                              lambda: cuda_lu.lu_inverse_cuda(at)),
                          "card": card}), flush=True)
    for batch, n in SPLIT:
        at = _draws(batch, n, dev)[1]
        print(json.dumps({"probe": "clock_split", "case": f"{batch}x{n}",
                          **clock_split(stamped, at), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
