"""Probes of the Newton-Schulz kernels' cluster instances at 129 ≤ n ≤ 224
on one card: K8 and K11 on the slab loop (``csrc/ns_cluster_rounds.cuh``),
K1 and K6 on the 2 × 2 quadrant loop (``csrc/ns_quad_rounds.cuh``).

    python -m cuda_matrix_inversion_tpu_torch.bench.ns_band_probe [BASELINE_CSRC]
    python -m cuda_matrix_inversion_tpu_torch.bench.ns_band_probe ab BASELINE_CSRC
    python -m cuda_matrix_inversion_tpu_torch.bench.ns_band_probe routes

Prints one JSON line a probe (``routes`` alone with that argument, and
``baseline`` alone with ``ab``):

- ``routes``: the routes the fixed Newton-Schulz lanes and the GP method
  ``pallas_ns`` took at 129 ≤ n ≤ 224 before K1 and K6 served that band,
  timed at :data:`BAND_TIMED` (1600 = 100 draws repeated): spd10 and spd
  through the Schur recursion down to K1 at n = 128, pan500 by batched
  split3 products, pan by the adaptive loop, and ``pallas_ns`` by K5's
  Schur route; beside them ``torch.linalg.inv`` and the GP ``solve``
  method, and each route's gate (max‖AA⁻¹−I‖∞ in fp64; GP: the largest
  error of mean and var against the fp64 closed form).  Median of 20
  CUDA-event timings after 3 warm-up calls.

- ``dsmem``: one CTA copying 16-row chunks of a bf16 slab (16 × (NP + 8)
  values, the band loop's k-chunk) into its own shared memory, 16 bytes a
  thread and load, from a peer CTA of its cluster (``ld.shared::cluster``)
  against the same bytes from device memory that L2 holds (``ld.global.cg``),
  every CTA of a full grid of clusters at once; GB/s a CTA (median) and
  for the card, and ns a chunk, at NP = 160, 192, 224 and C = NP / 32.
- ``clusters``: ``cudaOccupancyMaxActiveClusters`` for a kernel of 256
  threads at each cluster size 4 … 8 with the slab instances' shared
  memory (``band_smem_bytes``, both schedules), and for the cluster
  kernels themselves (``ns_band_kernel`` for K8, ``ns_quad_kernel`` for
  K1, ``gp_warm_band_kernel``, ``gp_ns_quad_kernel``): the shared memory
  each launch asks for, their registers, local memory
  (``cudaFuncGetAttributes``), the clusters the card holds at once and
  ``ptxas -v``'s lines (spills).
- ``clock_split``: K8's cluster instance with thread 0 of block 0 (rank 0
  of the first cluster) stamping ``clock64`` and ``%globaltimer`` after
  each step of the band loop (:data:`BAND_PHASES`: each store and cluster
  barrier, and inside each walk over the peer chunks the barriers armed
  and pushes issued, the own chunks, each wait for a peer's pushed chunks
  and the work on them, each window's barrier; ``walks`` groups them by
  walk, the fp32 residual being the fifth of the six walks of the
  default 2 + 1 rounds); each interval in µs, median of 5 launches, K8 bf16 and split3
  at 100×224, bf16 at 1600×224, 100×160 and 1×224 (one cluster on an
  idle card: the walks without the other clusters' traffic).
- ``quad_split``: K1's quadrant instance with thread 0 of block 0 (the
  diagonal CTA (0, 0) of the first cluster) stamping after the stage, the
  seed, each product (A X, X T, the residual), each store of T or R and
  each publish of X (:data:`QUAD_PHASES`); µs, median
  of 5 launches, spd10 at 100×224, 1600×224 and 1×224 (one cluster on an
  idle card) and pan500 at 100×224: a product's interval against the
  slab loop's walks above.
- ``baseline`` (when ``BASELINE_CSRC``, another checkout's ``csrc/``, is
  given): K8 (bf16, split3) and K11 of that checkout against this tree's
  on the same inputs at 100×224, 1600×224, 100×160 and 100×192 (the
  drifted batches of ``chip_smoke.py`` phase 5), and K1 in each fixed
  lane (pan500 on the κ = 500 nonsymmetric class, the others on the SPD
  class) and K6 on the same shapes: whether the outputs are bitwise equal
  and their largest difference (a design that sums in another order
  differs by rounding), and bare launches timed baseline, this, this,
  baseline.

The micro-benchmark's source is written under ``build/`` and compiled with
the kernels' flags; the band kernels' figures come from a copy of
``csrc/`` with a reader appended (``gp_ns_probe.variant_library``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench.gp_ns_probe import (
    STAMP_DEFS,
    _k6_launcher,
    _launcher,
    clock_split,
    median_ms,
    stamped_edits,
    variant_library,
)
from cuda_matrix_inversion_tpu_torch.bench.ns_probe import (
    _ab,
    k1_launcher,
    k8_launcher,
)
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_nonsym_cond,
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.models import gp
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_gp,
    linalg,
    schur,
)
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu_torch.ops.registry import LANES

BAND_NP = (160, 192, 224)
BAND_TIMED = ((100, 224), (1600, 224), (100, 160), (100, 192))

# The band loop's clock split: the interval that ends at stamp id k, and
# the patches (anchor, replacement, count) a file that place the stamps.
# Every walk over the peer chunks (``over_chunks``) stamps the arming of
# its barriers and the pushes issued (12), its own two chunks (13), each
# wait for a peer's two chunks (14) and their MMAs or FMAs (15), each
# window's cluster barrier and pushes (16), and its closing block barrier
# (17); :func:`walks` groups them by walk.
BAND_PHASES = {18: "load X0, stage A",
               1: "before the rounds",
               2: "publish X, cluster barrier",
               4: "lo: store T, cluster barrier",
               6: "lo: publish X, cluster barrier",
               7: "hi: store R", 8: "hi: cluster barrier",
               10: "hi: publish X, cluster barrier", 11: "write X",
               12: "walk: arm, push", 13: "walk: own chunks",
               14: "walk: wait for a peer's chunks",
               15: "walk: a peer's chunks",
               16: "walk: window cluster barrier, push",
               17: "walk: closing block barrier"}
WALK_IDS = (12, 13, 14, 15, 16, 17)
BAND_STAMPS = {
    "ns_common.cuh": [("#pragma once\n", STAMP_DEFS, 1)],
    "ns_cluster_rounds.cuh": [
        ("  publish(0);\n\n  float acc[1][NT][4];\n",
         "  publish(0);\n  ns_stamp(2);\n\n  float acc[1][NT][4];\n", 1),
        ("    if constexpr (SPLIT3) store_tile_bf16<1, NT, true>(acc, sm.Tl, "
         "LDB, w);\n    cluster_sync();\n",
         "    if constexpr (SPLIT3) store_tile_bf16<1, NT, true>(acc, sm.Tl, "
         "LDB, w);\n    cluster_sync();\n    ns_stamp(4);\n", 1),
        ("      band_mma_one<NP>(xm, sm.Xh, sm.T, sm, rank, parity, w);\n"
         "    publish(r + 1);\n",
         "      band_mma_one<NP>(xm, sm.Xh, sm.T, sm, rank, parity, w);\n"
         "    publish(r + 1);\n    ns_stamp(6);\n", 1),
        ("      store_tile_bf16(acc, sm.T, LDB, w);\n    }\n"
         "    cluster_sync();\n",
         "      store_tile_bf16(acc, sm.T, LDB, w);\n    }\n"
         "    ns_stamp(7);\n    cluster_sync();\n    ns_stamp(8);\n", 1),
        ("        xm[0][j][q] = __fadd_rn(xm[0][j][q], acc[0][j][q]);\n"
         "    publish(r + 1);\n",
         "        xm[0][j][q] = __fadd_rn(xm[0][j][q], acc[0][j][q]);\n"
         "    publish(r + 1);\n    ns_stamp(10);\n", 1),
        ("  push(1);\n", "  push(1);\n  ns_stamp(12);\n", 1),
        ("        cluster_sync();\n        push(first);\n",
         "        cluster_sync();\n        push(first);\n"
         "        ns_stamp(16);\n", 1),
        ("      mbar_wait(sm.bars + d - 1, parity);\n",
         "      mbar_wait(sm.bars + d - 1, parity);\n      ns_stamp(14);\n", 1),
        ("    body(c, chunk);\n",
         "    body(c, chunk);\n    if (j == 1) ns_stamp(13);\n"
         "    if (j > 1 && (j & 1)) ns_stamp(15);\n", 1),
        ("  parity ^= 1;\n  __syncthreads();\n",
         "  parity ^= 1;\n  __syncthreads();\n  ns_stamp(17);\n", 1),
    ],
    "newton_schulz.cu": [
        ("  band_load_x<NP>(xm, x0 + base, n, rank, w);\n",
         "  ns_stamp(0);\n  band_load_x<NP>(xm, x0 + base, n, rank, w);\n",
         1),
        ("  band_stage(sm, n, rank, [=](int i, int j) { return ab[i * n + j]; "
         "});\n",
         "  band_stage(sm, n, rank, [=](int i, int j) { return ab[i * n + j]; "
         "});\n  ns_stamp(18);\n", 1),
        ("  band_rounds<NP, SPLIT3>(xm, sm, prm, w, rank);\n",
         "  ns_stamp(1);\n  band_rounds<NP, SPLIT3>(xm, sm, prm, w, rank);\n",
         1),
        ("  band_store_x(sm, x + base, n, rank);\n}\n",
         "  band_store_x(sm, x + base, n, rank);\n  __syncthreads();\n"
         "  ns_stamp(11);\n}\n", 1),
    ],
}


# The quadrant loop's clock split (K1's ns_quad_kernel), as BAND_STAMPS.
QUAD_PHASES = {30: "stage A (and A's remote bf16 part)",
               31: "seed over the cluster (3 cluster barriers)",
               41: "publish: cluster barrier after the last product",
               32: "publish X, cluster barrier",
               33: "lo: A X",
               34: "lo: store T, cluster barrier",
               35: "lo: X T",
               36: "hi: residual",
               37: "hi: cluster barriers, X's bf16 parts",
               40: "hi: split A X, store R, cluster barrier",
               38: "hi: X R",
               39: "write X"}
QUAD_STAMPS = {
    "ns_common.cuh": [("#pragma once\n", STAMP_DEFS, 1)],
    "ns_quad_rounds.cuh": [
        ("    if (r > 0 && !turn) cluster_sync();\n",
         "    if (r > 0 && !turn) cluster_sync();\n"
         "    if (r > 0 && !turn) ns_stamp(41);\n", 1),
        ("    cluster_sync();\n  };\n  const bf16* xh",
         "    cluster_sync();\n    ns_stamp(32);\n  };\n  const bf16* xh", 1),
        ("      ax_one(acc);\n    if (w.active)\n",
         "      ax_one(acc);\n    ns_stamp(33);\n    if (w.active)\n", 1),
        ("    store_t(acc);\n    xt(xm);\n",
         "    store_t(acc);\n    ns_stamp(34);\n    xt(xm);\n"
         "    ns_stamp(35);\n", 1),
        ("      quad_residual<NP, SPLIT3>(sm, c, bars, src, n);\n",
         "      quad_residual<NP, SPLIT3>(sm, c, bars, src, n);\n"
         "      ns_stamp(36);\n", 1),
        ("          store_tile_bf16<1, NT, true>(xm, sm.slot(kXL), LD, w);\n"
         "      }\n      cluster_sync();\n    } else {\n",
         "          store_tile_bf16<1, NT, true>(xm, sm.slot(kXL), LD, w);\n"
         "      }\n      cluster_sync();\n      ns_stamp(37);\n    } else {\n",
         1),
        ("      store_t(acc);\n    }\n    xt(acc);\n",
         "      store_t(acc);\n      ns_stamp(40);\n    }\n    xt(acc);\n"
         "    ns_stamp(38);\n", 1),
    ],
    "newton_schulz.cu": [
        ("  quad_stage<NP, SPLIT3>(sm, c, src, n, !prm.init_spd);\n",
         "  ns_stamp(0);\n  quad_stage<NP, SPLIT3>(sm, c, src, n, "
         "!prm.init_spd);\n  ns_stamp(30);\n", 1),
        ("  quad_seed<NP>(xm, sm, c, n, prm.init_spd, red, w);\n",
         "  quad_seed<NP>(xm, sm, c, n, prm.init_spd, red, w);\n"
         "  ns_stamp(31);\n", 1),
        ("  quad_store_x(sm, c, x + base, n);\n}\n",
         "  quad_store_x(sm, c, x + base, n);\n  __syncthreads();\n"
         "  ns_stamp(39);\n}\n", 1),
    ],
}


def walks(sequence) -> list:
    """A clock split's ``sequence_us`` grouped by walk over the peer chunks,
    in order: each walk's µs arming and pushing, on its own chunks, waiting
    for each peer's chunks, on each peer's chunks, in window barriers, in
    its closing barrier, and in all."""
    names = {BAND_PHASES[k]: k for k in WALK_IDS}
    out, cur = [], None
    for name, us in sequence:
        k = names.get(name)
        if k is None:
            continue
        if k == 12:
            cur = {"push_us": 0.0, "own_us": 0.0, "wait_us": [],
                   "peer_us": [], "window_us": 0.0}
        if cur is None:
            continue
        if k == 12:
            cur["push_us"] += us
        elif k == 13:
            cur["own_us"] += us
        elif k == 14:
            cur["wait_us"].append(us)
        elif k == 15:
            cur["peer_us"].append(us)
        elif k == 16:
            cur["window_us"] += us
        else:
            cur["close_us"] = us
            cur["total_us"] = (cur["push_us"] + cur["own_us"]
                               + sum(cur["wait_us"]) + sum(cur["peer_us"])
                               + cur["window_us"] + us)
            out.append(cur)
            cur = None
    return out


# The copy micro-benchmark: each CTA fills its slab, then copies `reps`
# chunks from its peer rank + 1 (mode 0) or from device memory (mode 1)
# into a local buffer, one barrier a chunk, and thread 0 records the
# globaltimer interval.
DSMEM_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(256, 1)
    copy_kernel(const uint4* __restrict__ g, int vec, int reps, int mode,
                unsigned long long* ns, unsigned* sink) {
  extern __shared__ __align__(16) uint4 smem[];
  uint4* slab = smem;           // 2 chunks, the peer's source
  uint4* local = smem + 2 * vec;  // the copy's destination
  const int tid = threadIdx.x;
  namespace cg = cooperative_groups;
  const unsigned rank = cg::this_cluster().block_rank();
  const unsigned csize = cg::this_cluster().num_blocks();
  for (int v = tid; v < 2 * vec; v += 256)
    slab[v] = make_uint4(v, rank, v ^ rank, 7);
  cluster_sync();
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer) : "r"(smem_u32(slab)), "r"((rank + 1) % csize));
  const uint4* gsrc = g + static_cast<size_t>(blockIdx.x % 64) * 2 * vec;
  unsigned x = 0;
  __syncthreads();
  const unsigned long long t0 = now_ns();
  for (int r = 0; r < reps; ++r) {
    const int off = (r & 1) * vec;
    for (int v = tid; v < vec; v += 256) {
      uint4 u;
      if (mode == 0) {
        asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                     : "r"(peer + 16 * (off + v)));
      } else {
        u = __ldcg(gsrc + off + v);
      }
      local[v] = u;
      x ^= u.x ^ u.w;
    }
    __syncthreads();
  }
  const unsigned long long t1 = now_ns();
  cluster_sync();
  if (tid == 0) ns[blockIdx.x] = t1 - t0;
  atomicXor(sink, x);
}

}  // namespace

extern "C" int probe_copy(const void* g, int vec, int reps, int mode,
                          int csize, int clusters, void* ns, void* sink) {
  const size_t smem = 3ull * vec * 16;
  cudaError_t err = cudaFuncSetAttribute(
      copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, copy_kernel,
                           static_cast<const uint4*>(g), vec, reps, mode,
                           static_cast<unsigned long long*>(ns),
                           static_cast<unsigned*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `csize` CTAs of 256 threads with `smem` bytes each that the
// card holds at once.
extern "C" int probe_max_clusters(int csize, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (csize > 8) {
    err = cudaFuncSetAttribute(
        copy_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * 132);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, copy_kernel, &cfg));
}
"""

# Appended to copies of newton_schulz.cu and gp.cu: for each band
# instance, registers, local bytes, shared memory and the clusters the
# card holds at once.
BAND_READER = """
namespace {{
template <typename Kernel>
int band_figures(Kernel kernel, int np, bool split3, int csize, size_t smem,
                 int* out) {{
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(csize * 132);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = csize;
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
  return 0;
}}
}}  // namespace

extern "C" int cmi_probe_band(int* out) {{
  int err = 0;
  {calls}
  return err;
}}
"""
# K8 and K1 (the slab and the quadrant instances); K11 and K6.
NS_KERNELS = [f"{k}<{np}, {s}>" for k in ("ns_band_kernel", "ns_quad_kernel")
              for np in BAND_NP for s in ("false", "true")]
GP_KERNELS = [f"{k}<{np}>" for k in ("gp_warm_band_kernel",
                                     "gp_ns_quad_kernel") for np in BAND_NP]


def _kernel_np_split3(kernel: str) -> tuple:
    """(NP, split3) of a cluster kernel's name, ``ns_band_kernel<224,
    false>`` (NP, SPLIT3) or ``gp_warm_band_kernel<160>``."""
    args = [x.strip() for x in kernel.split("<")[1].rstrip(">").split(",")]
    return int(args[0]), len(args) > 1 and args[-1] == "true"


def _reader(kernels) -> str:
    calls = []
    for i, k in enumerate(kernels):
        np_, s3 = _kernel_np_split3(k)
        split3 = "true" if s3 else "false"
        if "quad" in k:
            csize, smem = "kQuadCtas", f"quad_smem_bytes({np_})"
        else:
            csize, smem = f"{np_} / kSlab", f"band_smem_bytes({np_}, {split3})"
        calls.append(f"if (!err) err = band_figures({k}, {np_}, {split3}, "
                     f"{csize}, {smem}, out + {4 * i});")
    return BAND_READER.format(calls="\n  ".join(calls))


def _band_figures(unit: str, kernels) -> dict:
    lib = variant_library(f"band_{unit.split('.')[0]}",
                          {unit: ([], _reader(kernels))}, units=(unit,),
                          flags=("-Xptxas", "-v"))
    fn = lib.cmi_probe_band
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (4 * len(kernels)))()
    cuda_build.check(fn(ctypes.cast(out, ctypes.c_void_p)), "band figures")
    lines = lib.compiler_log.splitlines()
    ptxas = [x.strip() for i, line in enumerate(lines)
             if "Compiling entry function" in line
             and ("band" in line or "quad" in line)
             for x in lines[i:i + 4] if "registers" in x or "spill" in x]
    return {"kernels": {k: {"registers": out[4 * i],
                            "local_bytes": out[4 * i + 1],
                            "smem_bytes": out[4 * i + 2],
                            "max_active_clusters": out[4 * i + 3]}
                        for i, k in enumerate(kernels)},
            "ptxas": ptxas}


def _copy_lib() -> ctypes.CDLL:
    root = cuda_build.BUILD_DIR / "probe_dsmem"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "dsmem.cu"
    src.write_text(DSMEM_SRC)
    lib = root / "libdsmem.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
           str(lib), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed: {log.stdout}{log.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    cdll.probe_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    for fn in (cdll.probe_copy, cdll.probe_max_clusters):
        fn.restype = ctypes.c_int
    return cdll


def _band_smem(np_: int, split3: bool = False) -> int:
    """``band_smem_bytes`` (csrc/ns_cluster_rounds.cuh) in Python."""
    ldb, ldf = np_ + 8, np_ + 4
    chunks = (12 if np_ == 224 else 20 if np_ == 192 else 16 if split3
              else 4)
    return (2 * 32 * ldf * 4 + 4 * 32 * ldb * 2 + 16 * ldb * 2 * chunks
            + 8 * 8 + (2 * np_ + 2 * (np_ // 32)) * 4)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if sys.argv[1:] == ["routes"]:
        routes(dev, card)
        return 0
    if sys.argv[1:2] == ["ab"]:
        _baseline(_baseline_libs(Path(sys.argv[2])), dev, card)
        return 0
    lib = _copy_lib()

    sizes = {}
    for csize in range(4, 9):
        row = {}
        for np_ in BAND_NP:
            for split3 in (False, True):
                smem = _band_smem(np_, split3)
                out = ctypes.c_int()
                cuda_build.check(lib.probe_max_clusters(
                    csize, smem, ctypes.byref(out)), "max clusters")
                row[f"smem_{smem}"] = out.value
        sizes[str(csize)] = row
    print(json.dumps({"probe": "clusters", "generic_256_threads": sizes,
                      "newton_schulz.cu": _band_figures(
                          "newton_schulz.cu", NS_KERNELS),
                      "gp.cu": _band_figures("gp.cu", GP_KERNELS),
                      "card": card}), flush=True)

    reps = 256
    for np_ in BAND_NP:
        csize = np_ // 32
        vec = 16 * (np_ + 8) * 2 // 16  # 16-byte vectors a chunk
        out = ctypes.c_int()
        cuda_build.check(lib.probe_max_clusters(csize, 3 * vec * 16,
                                                ctypes.byref(out)), "max")
        clusters = out.value
        g = torch.randint(0, 1 << 30, (64 * 2 * vec * 4,), dtype=torch.int32,
                          device=dev)
        sink = torch.zeros(1, dtype=torch.int32, device=dev)
        row = {"np": np_, "cluster": csize, "clusters": clusters,
               "chunk_bytes": 16 * vec, "reps": reps}
        for mode, name in ((0, "peer_dsmem"), (1, "l2")):
            ns = torch.zeros(clusters * csize, dtype=torch.int64, device=dev)
            runs = []
            for _ in range(5):
                cuda_build.check(lib.probe_copy(
                    g.data_ptr(), vec, reps, mode, csize, clusters,
                    ns.data_ptr(), sink.data_ptr()), "copy")
                torch.cuda.synchronize()
                t = ns.double().cpu()
                runs.append((float(t.median()), float(t.max())))
            med = statistics.median(r[0] for r in runs)
            worst = statistics.median(r[1] for r in runs)
            nbytes = 16.0 * vec * reps
            row[name] = {"ns_per_chunk": med / reps,
                         "gbps_per_cta": nbytes / med,
                         "gbps_card": nbytes * clusters * csize / worst}
        print(json.dumps({"probe": "dsmem", **row, "card": card}),
              flush=True)
    stamped = variant_library(
        "band_stamped", stamped_edits(BAND_STAMPS, "newton_schulz.cu"),
        units=("newton_schulz.cu",))
    for batch, n, prec in ((100, 224, "bf16"), (100, 224, "split3"),
                           (1600, 224, "bf16"), (100, 160, "bf16"),
                           (1, 224, "bf16")):
        rng = np.random.default_rng(batch + n)
        base = torch.tensor((make_spd_batch if prec == "bf16"
                             else make_square_batch)(batch, n, rng),
                            dtype=torch.float32, device=dev)
        a, x0 = _drifted(base, 1e-3 if prec == "bf16" else 1e-4, batch,
                         prec == "bf16")
        split = clock_split(stamped, k8_launcher(
            stamped, a, x0, prec == "split3"), BAND_PHASES)
        print(json.dumps({"probe": "clock_split",
                          "case": f"K8 {prec} {batch}x{n}", **split,
                          "walks": walks(split["sequence_us"]),
                          "card": card}), flush=True)
    quad = variant_library(
        "quad_stamped", stamped_edits(QUAD_STAMPS, "newton_schulz.cu"),
        units=("newton_schulz.cu",))
    for lane, batch in (("newton_schulz_spd10_pallas", 100),
                        ("newton_schulz_spd10_pallas", 1600),
                        ("newton_schulz_spd10_pallas", 1),
                        ("newton_schulz_pan500_pallas", 100)):
        sched = LANES[lane]["schedule"]
        rng = np.random.default_rng(324 + batch)
        a = torch.tensor(make_nonsym_cond(batch, 224, 500.0, rng)
                         if sched.split3 else make_spd_batch(batch, 224, rng),
                         dtype=torch.float32, device=dev)
        split = clock_split(quad, k1_launcher(quad, a, sched), QUAD_PHASES)
        print(json.dumps({"probe": "quad_split",
                          "case": f"K1 {lane} {batch}x224", **split,
                          "card": card}), flush=True)
    if len(sys.argv) > 1:
        _baseline(_baseline_libs(Path(sys.argv[1])), dev, card)
    return 0


def _baseline_libs(src: Path) -> dict:
    """The kernels of another checkout's ``csrc/`` and of this tree."""
    base = variant_library("band_baseline", src=src,
                           units=("newton_schulz.cu", "gp.cu"))
    return {"baseline": base, "this": cuda_build.library()}


def band_routes() -> dict:
    """The routes of the fixed Newton-Schulz lanes at 129 ≤ n ≤ 224 before
    K1 served the band, by lane: callables of one float32 batch."""
    def schur_k1(lane):
        base = functools.partial(ns.inverse_newton_schulz_fixed,
                                 **LANES[lane]["keywords"])
        return lambda a: schur.spd_blocked_inverse(
            a, base, max_base_n=cuda_build.MAX_N)

    return {"newton_schulz_spd10_pallas":
                schur_k1("newton_schulz_spd10_pallas"),
            "newton_schulz_spd_pallas": schur_k1("newton_schulz_spd_pallas"),
            "newton_schulz_pallas": ns.inverse_newton_schulz,
            "newton_schulz_pan500_pallas":
                ns.inverse_newton_schulz_pan500_batched}


def routes(dev, card: str) -> None:
    """One line a shape of :data:`BAND_TIMED`: each band route's time and
    gate (``routes`` in the module's docstring)."""
    for batch, n in BAND_TIMED:
        rng = np.random.default_rng(7400 + n)
        reps = batch // 100

        def tile(x):
            return torch.tensor(x, dtype=torch.float32, device=dev).repeat(
                reps, *([1] * (x.ndim - 1))).contiguous()

        spd = make_spd_batch(100, n, rng)
        gen = make_nonsym_cond(100, n, 500.0, rng)
        g = make_gp_batch(100, n, rng)
        row = {"probe": "routes", "case": f"{batch}x{n}"}
        for lane, fn in band_routes().items():
            a = gen if lane.endswith("pan500_pallas") else spd
            at = tile(a)
            x = fn(at)[:100].cpu().numpy()
            row[lane] = {"ms": median_ms(lambda: fn(at)),
                         "gate": identity_error_inf(a, x)}
        at = tile(spd)
        row["torch_linalg_inv_ms"] = median_ms(lambda: torch.linalg.inv(at))
        t = [tile(g[k]) for k in "abcde"]
        mean, var = cuda_gp.gp_schur_route(*t)
        row["pallas_ns"] = {
            "ms": median_ms(lambda: cuda_gp.gp_schur_route(*t)),
            "route": "gp_schur_route (K5's route here before its packed "
                     "instance: Schur on K3)",
            "abs_err": max(float(np.abs(mean[:100].cpu().numpy()
                                        - g["means"]).max()),
                           float(np.abs(var[:100].cpu().numpy()
                                        - g["variances"]).max()))}
        row["gp_solve_ms"] = median_ms(lambda: gp.gp_mean_variance(
            *t, method="solve"))
        print(json.dumps({**row, "card": card}), flush=True)


def _drifted(a, delta: float, seed: int, symmetric: bool):
    """``a`` drifted by a relative 2-norm ``delta`` (symmetrised for SPD
    input), and the exact inverse of ``a``."""
    a64 = a.double()
    noise = torch.tensor(np.random.default_rng(seed).standard_normal(
        a.shape), device=a.device)
    if symmetric:
        noise = (noise + noise.mT) / 2
    scale = (torch.linalg.matrix_norm(a64, ord=2)
             / torch.linalg.matrix_norm(noise, ord=2))
    return ((a64 + delta * scale[:, None, None] * noise).float(),
            torch.linalg.inv(a64).float().contiguous())


def _baseline(libs: dict, dev, card: str) -> None:
    """K8 (bf16 and split3), K11, K1 in each fixed lane and K6 of the
    baseline against this tree's at BAND_TIMED, one line each."""
    for batch, n in BAND_TIMED:
        rng = np.random.default_rng(batch + n)
        spd, gen = (torch.tensor(f(batch, n, rng), dtype=torch.float32,
                                 device=dev)
                    for f in (make_spd_batch, make_square_batch))
        for prec, base, delta in (("bf16", spd, 1e-3), ("split3", gen, 1e-4)):
            a, x0 = _drifted(base, delta, batch, prec == "bf16")
            _ab(libs, lambda lib: k8_launcher(lib, a, x0, prec == "split3"),
                f"K8 {prec} {batch}x{n}", card, False)
        g = make_gp_batch(batch, n, rng)
        t = [torch.tensor(g[k], dtype=torch.float32, device=dev)
             for k in "abcde"]
        x0 = torch.linalg.inv(linalg.add_diagonal(t[1], t[2]).double()
                              ).float().contiguous()
        flat = cuda_gp._flat(*t, max_n=cuda_build.WARM_MAX_N)
        _ab(libs, lambda lib: _launcher(lib, flat, x0),
            f"K11 gp_{batch}x{n}", card, False)
        _ab(libs, lambda lib: _k6_launcher(lib, flat), f"K6 gp_{batch}x{n}",
            card, False)
        pan500 = torch.tensor(make_nonsym_cond(batch, n, 500.0, rng),
                              dtype=torch.float32, device=dev)
        for lane in band_routes():
            sched = LANES[lane]["schedule"]
            a = pan500 if sched.split3 else spd
            _ab(libs, lambda lib: k1_launcher(lib, a, sched),
                f"K1 {lane} {batch}x{n}", card, False)


if __name__ == "__main__":
    raise SystemExit(main())
