"""Probes of K2's cluster instance (``csrc/lu_band.cu``, 129 ≤ n ≤ 256)
on one card.

    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe
    python -m cuda_matrix_inversion_tpu_torch.bench.lu_band_probe routes [OTHER_ROOT]

Prints one JSON line a probe (``routes`` alone with that argument):

- ``occupancy``: for each instance (NP = 160, 192, 224, 256: clusters of
  NP / 32 CTAs of 256 threads), the registers a thread and the local
  memory (``cudaFuncGetAttributes``), the shared memory a CTA asks for,
  and ``cudaOccupancyMaxActiveClusters`` (the clusters the card holds at
  once); ``ptxas -v``'s lines.
- ``wrapper``: the kernel through ``cuda_lu.lu_inverse_cuda`` at
  :data:`TIMED` (median of 20 CUDA-event timings after 3 warm-up calls).
- ``clock_split``: thread 0 of every CTA of the first cluster stamping
  ``clock64`` (rank 0 also ``%globaltimer``) at the steps of
  :data:`STEPS`; a step that repeats (a panel, a back-pass block) is
  summed over its repeats; µs at the SM clock the two timers give, median
  of 5 launches, for each rank, at :data:`SPLIT`.  The stamps cost the
  observers time, so a split CTA runs longer than the unstamped kernel.
- ``routes``: at :data:`TIMED` (1600 = 100 draws repeated, the general
  class ``make_square_batch``), the ``lu_pallas`` lane (K2's cluster
  instance and the fp64 polish), the kernel alone, the route the lane
  took before (the blocked LU on K9, ``lu_bign.inverse_lu_big``), the
  plain version (``lu_inverse_plain``), ``torch.linalg.inv``, each lane's
  gate (max‖AA⁻¹−I‖∞ in fp64 on the 100 draws); with ``OTHER_ROOT``
  (another checkout, such as the parent's unpacked with ``git archive``
  under ``build/``) that checkout's ``lu_pallas`` lane on the same draws,
  timed in a process of its own.

The stamped and the occupancy builds come from a copy of ``csrc/`` with
patches and a reader (``gp_ns_probe.variant_library``).
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
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_square_batch
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_lu, lu_bign
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

UNITS = ("lu_band.cu",)
BAND_NP = (160, 192, 224, 256)
TIMED = ((100, 160), (100, 192), (100, 224), (100, 256), (1600, 256))
SPLIT = ((100, 256), (1600, 256), (100, 160))

# Clock bookkeeping: thread 0 of each CTA of cluster 0 adds the clocks
# since its previous stamp to step s (lb_step); lb_finish closes the last
# step after a barrier and copies the sums to row `rank` of lb_probe, and
# rank 0 the globaltimer and clock at both ends to row 8.
_DEFS = """
#include <cooperative_groups.h>
__device__ unsigned long long lb_probe[9][16];
__shared__ unsigned long long lb_sh[17];
__device__ __forceinline__ bool lb_obs() {
  return threadIdx.x == 0 &&
         blockIdx.x < cooperative_groups::this_cluster().num_blocks();
}
__device__ __forceinline__ void lb_start() {
  if (lb_obs()) {
    for (int i = 0; i < 16; ++i) lb_sh[i] = 0;
    lb_sh[16] = clock64();
    if (blockIdx.x == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      lb_probe[8][0] = g;
      lb_probe[8][2] = lb_sh[16];
    }
  }
}
__device__ __forceinline__ void lb_step(int s) {
  if (lb_obs()) {
    const unsigned long long t = clock64();
    lb_sh[s] += t - lb_sh[16];
    lb_sh[16] = t;
  }
}
__device__ __forceinline__ void lb_finish(int s) {
  __syncthreads();
  if (lb_obs()) {
    lb_step(s);
    for (int i = 0; i < 16; ++i) lb_probe[blockIdx.x][i] = lb_sh[i];
    if (blockIdx.x == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      lb_probe[8][1] = g;
      lb_probe[8][3] = clock64();
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
  return 0;
}
extern "C" int cmi_probe_lu_band(int* out) {
  int err = lb_figures<160>(out);
  if (!err) err = lb_figures<192>(out + 4);
  if (!err) err = lb_figures<224>(out + 8);
  if (!err) err = lb_figures<256>(out + 12);
  return err;
}
"""

# The steps of the split, and the (anchor, replacement, count) patches of
# lu_band.cu that stamp them.
STEPS = ("load the slab, mbarriers, first cluster barrier",
         "owner change: cluster barrier, arm the slots' barriers",
         "own panel: mirror, factor (4 columns), barrier, pushes",
         "a peer's panel: wait for its push",
         "stage the rows that move, barrier",
         "gather, U12, the owner's panel columns, barrier",
         "the rows past the panel: 4 steps, barrier",
         "U to the workspace, cluster barrier",
         "back pass: wait for U's block, barrier",
         "back pass: the block's triangle, barrier",
         "back pass: the rows above, barrier",
         "write")
STAMPS = [
    ("#include \"lu_common.cuh\"\n", "#include \"lu_common.cuh\"\n" + _DEFS,
     1),
    ("  const size_t mat = blockIdx.x / C;\n",
     "  const size_t mat = blockIdx.x / C;\n  lb_start();\n", 1),
    ("  // every CTA's mbarriers initialised before any push (W10)\n"
     "  cluster_sync();\n",
     "  // every CTA's mbarriers initialised before any push (W10)\n"
     "  cluster_sync();\n  lb_step(0);\n", 1),
    ("    if (!own && tid < kPanels) mbar_arm(bars + tid, B::kSlotBytes);\n",
     "    if (!own && tid < kPanels) mbar_arm(bars + tid, B::kSlotBytes);\n"
     "    lb_step(1);\n", 1),
    ("                    peer_addr(bars + j, peer));\n        }\n",
     "                    peer_addr(bars + j, peer));\n        }\n"
     "        lb_step(2);\n", 1),
    ("        mbar_wait(bars + j, parity);\n",
     "        mbar_wait(bars + j, parity);\n        lb_step(3);\n", 1),
    ("        st4(St + e * 64 + 4 * q, ld4(S + row * kLdS + 4 * q));\n"
     "      }\n      __syncthreads();\n",
     "        st4(St + e * 64 + 4 * q, ld4(S + row * kLdS + 4 * q));\n"
     "      }\n      __syncthreads();\n      lb_step(4);\n", 1),
    ("      // the rows past the panel take its 4 steps, in order, on quads\n",
     "      lb_step(5);\n"
     "      // the rows past the panel take its 4 steps, in order, on quads\n",
     1),
    ("          st4(S + i * kLdS + 4 * q, v);\n        }\n      }\n"
     "      __syncthreads();\n",
     "          st4(S + i * kLdS + 4 * q, v);\n        }\n      }\n"
     "      __syncthreads();\n      lb_step(6);\n", 1),
    ("  // or writes a peer's shared memory past this barrier\n"
     "  cluster_sync();\n",
     "  // or writes a peer's shared memory past this barrier\n"
     "  cluster_sync();\n  lb_step(7);\n", 1),
    ("    cp_async_wait<B::kRing - 1>();\n    __syncthreads();\n",
     "    cp_async_wait<B::kRing - 1>();\n    __syncthreads();\n"
     "    lb_step(8);\n", 1),
    ("        st4(S + (r0 + r) * kLdS + kYOff + 4 * yq, y[r]);\n    }\n"
     "    __syncthreads();\n",
     "        st4(S + (r0 + r) * kLdS + kYOff + 4 * yq, y[r]);\n    }\n"
     "    __syncthreads();\n    lb_step(9);\n", 1),
    ("    __syncthreads();\n    fetch(kb - B::kRing);\n",
     "    __syncthreads();\n    lb_step(10);\n    fetch(kb - B::kRing);\n", 1),
    ("    for (int i = tid; i < n; i += kBandThreads) ipiv[mat * n + i] = "
     "s_ipiv[i];\n}\n",
     "    for (int i = tid; i < n; i += kBandThreads) ipiv[mat * n + i] = "
     "s_ipiv[i];\n  lb_finish(11);\n}\n", 1),
]

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


def occupancy() -> dict:
    lib = variant_library("lu_band_occ", {"lu_band.cu": ([], OCCUPANCY)},
                          units=UNITS, flags=("-Xptxas", "-v"))
    fn = lib.cmi_probe_lu_band
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (4 * len(BAND_NP)))()
    cuda_build.check(fn(ctypes.cast(out, ctypes.c_void_p)), "occupancy")
    lines = lib.compiler_log.splitlines()
    ptxas = [x.strip() for i, line in enumerate(lines)
             if "Compiling entry function" in line and "lu_band" in line
             for x in lines[i:i + 4] if "registers" in x or "spill" in x]
    return {"instances": {f"NP{np_}": {
        "ctas_a_cluster": np_ // 32, "registers": out[4 * i],
        "local_bytes": out[4 * i + 1], "smem_bytes": out[4 * i + 2],
        "max_active_clusters": out[4 * i + 3]}
        for i, np_ in enumerate(BAND_NP)}, "ptxas": ptxas}


def clock_split(lib, a) -> dict:
    """Median over 5 launches of each step, for each rank of cluster 0."""
    fn = lib.cmi_lb_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batch, n = a.shape[0], a.shape[-1]
    clusters = cuda_lu.band_np(n) // 32
    inv = torch.empty_like(a)
    ipiv = torch.empty((batch, n), dtype=torch.int32, device=a.device)
    ws = torch.empty((batch, cuda_lu.band_np(n) ** 2), device=a.device)
    device, stream = cuda_build.launch_args(a)
    stamps = (ctypes.c_ulonglong * (9 * 16))()
    rows, ghz = [], []
    for _ in range(5):
        cuda_build.check(lib.cmi_lu_inverse_band(
            a.data_ptr(), inv.data_ptr(), ipiv.data_ptr(), ws.data_ptr(),
            batch, n, device, stream), "stamped lu band")
        torch.cuda.synchronize()
        cuda_build.check(fn(ctypes.cast(stamps, ctypes.c_void_p)), "stamps")
        rate = ((stamps[8 * 16 + 3] - stamps[8 * 16 + 2])
                / (stamps[8 * 16 + 1] - stamps[8 * 16 + 0]))  # clocks / ns
        ghz.append(rate)
        rows.append([[stamps[16 * r + s] / rate / 1e3
                      for s in range(len(STEPS))] for r in range(clusters)])
    med = np.median(np.array(rows), axis=0)
    return {"sm_clock_ghz": float(np.median(ghz)),
            "ranks": [{"cta_us": float(m.sum()),
                       "steps_us": dict(zip(STEPS, map(float, m)))}
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    if sys.argv[1:2] == ["routes"]:
        routes(dev, card, Path(sys.argv[2]) if len(sys.argv) > 2 else None)
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
