"""Build the hand-written Hopper kernels and bind them through ctypes.

``csrc/*.cu`` hold plain C entry points; ``csrc/*.cuh`` hold the device
code that several of them share.  At first use the ``.cu`` files are
compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` a file, all started
together, and linked into one shared library under
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``.  The file name carries a hash of the flags and of every source
and header, so an edited file builds anew and an unchanged tree is loaded
from the cache.
Nothing here runs at import time: the CPU test suite imports every module
on hosts that have no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0, because a refused launch (too
much shared memory, too many threads) never runs and a later
``torch.cuda.synchronize()`` does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Largest matrix dimension the shared-memory-resident kernels take.  Each
# kernel holds its matrices in one block's shared memory, of which a block
# may opt into 227 KB: K1, K8, K6 and K11 keep A (K) in fp32 and four
# bf16 n×n tiles (200.5 KB at n = 128; K6 and K11 201.5 with [d a]); K2
# keeps its tiles in registers and one n×ld buffer (83 KB at 128, with
# the panel, the staged rows and the tables) and states its own larger
# ceiling, LU_MAX_N; K3 and K10 with ``emit_w`` two n×ld
# (``csrc/cholesky_common.cuh::chol_ld``, 132 at n = 128: 135 KB); K4, K5
# and K10 one n×ld (68 KB, three blocks an SM) and state their own larger
# ceiling, CHOL_MAX_N.  K7 keeps one n×n buffer
# too and states its own larger ceiling, GAUSS_JORDAN_MAX_N = 192
# (148 KB), the JAX kernel's.  K9 keeps one n×pw panel and checks its own ceiling
# (``lu_bign.panel_smem_bytes``).
MAX_N = 128
# Largest n the Newton-Schulz kernels K1, K6, K8 and K11 take, the JAX
# kernels' ceiling (the name dates from the warm kernels K8 and K11, the
# first to serve it): past MAX_N each matrix runs on one thread-block
# cluster at NP = 160, 192 or 224 (:data:`NS_BAND_NP`): K8 and K11 on NP /
# 32 CTAs, a 32-row slab of the matrix in each CTA's shared memory
# (``csrc/ns_cluster_rounds.cuh``); K1 and K6 on four CTAs, an NP / 2
# quadrant in each (``csrc/ns_quad_rounds.cuh``).
WARM_MAX_N = 224
# The padded sizes of the Newton-Schulz kernels' cluster instances.
NS_BAND_NP = (160, 192, 224)
# Largest n K2 takes, the JAX kernel's ceiling: past MAX_N each matrix runs
# on one thread-block cluster of NP / 32 CTAs (NP = 160, 192, 224, 256),
# a 32-column slab of the matrix and of its inverse in each CTA's shared
# memory (``csrc/lu_band.cu``).
LU_MAX_N = 256
# Largest n the Cholesky kernels K4, K5 and K10 take, the JAX kernels'
# ceiling: past MAX_N each matrix stays in one block's shared memory as
# its packed lower triangle (``csrc/cholesky_common.cuh::CholPacked``,
# rows in groups of 8 with an odd float4 stride: 34,816 floats, 136 KB,
# at n = 256 against 266 KB for the n×chol_ld square), beside K5's two
# vectors (2n floats, 138 KB in all) or K10's (3n with ``emit_w``, whose
# W = L⁻¹ replaces L in place: 139 KB).  One block an SM at 256, two up
# to 224 (105 KB; the register cap of two blocks holds n = 160 at two
# too).  K3 keeps MAX_N: past it both packages invert through Schur.
CHOL_MAX_N = 256

_VP = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the entry points (all return cudaError_t as int).
_SIGNATURES = {
    # a, x, batch, n, init_spd, lo, hi, split3, polish_highest,
    # two_c (device float*), c_sq (device float*), device, stream,
    # quad_np (host int*, or None)
    "cmi_ns_inverse": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP, _VP, _I,
                       _VP, _IP],
    # a, inv, ipiv, batch, n, device, stream
    "cmi_lu_inverse": [_VP, _VP, _VP, _I, _I, _I, _VP],
    # a, inv, ipiv, ws (batch x NP x NP floats of scratch), batch, n,
    # device, stream
    "cmi_lu_inverse_band": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    # a, l, batch, n, device, stream
    "cmi_chol_factor": [_VP, _VP, _I, _I, _I, _VP],
    # a, inv, batch, n, device, stream
    "cmi_chol_inverse": [_VP, _VP, _I, _I, _I, _VP],
    # a, b, c, d, e, out, batch, n, device, stream
    "cmi_gp_fused": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    # a, b, c, d, e, out, batch, n, lo, hi, two_c (device float*),
    # c_sq (device float*), device, stream, quad_np (host int*, or None)
    "cmi_gp_fused_ns": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP,
                        _VP, _I, _VP, _IP],
    # a, inv, batch, n, device, stream
    "cmi_gauss_jordan": [_VP, _VP, _I, _I, _I, _VP],
    # a, x0, x, batch, n, lo, hi, split3, device, stream
    "cmi_ns_warm": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # a, b, c, d, e, out, batch, n, x0, kinv, lo, hi, device, stream
    "cmi_gp_fused_warm": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _I,
                          _I, _I, _VP],
    # b, c, d, out, w, alpha, batch, n, emit_w, device, stream
    "cmi_gp_lml": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # work, perm, ipiv, ldi, udi, batch, n, k0, pw, device, stream
    "cmi_lu_panel": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of "
        "cuda_matrix_inversion_tpu_torch are built from csrc/*.cu at first "
        "use and need the CUDA toolkit")


def _sources() -> list[Path]:
    """The translation units ``nvcc`` compiles."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcmi_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library (no-op when
    the library for these sources exists).  Returns its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objdir = out.with_suffix(f".{os.getpid()}.objs")
    objdir.mkdir()
    objs = [objdir / f"{src.stem}.o" for src in _sources()]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for obj, src in zip(objs, _sources())]
    link_cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                *map(str, objs)]
    procs = []
    try:
        for cmd in compile_cmds:
            procs.append((cmd, _start(cmd)))
        for cmd, proc in procs:
            _finish(cmd, proc)
        _finish(link_cmd, _start(link_cmd))
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:  # a sibling failed: stop the rest
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(cmd: list[str], proc: subprocess.Popen) -> None:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_kernel_input(a: torch.Tensor, what: str,
                       max_n: int = MAX_N) -> None:
    """Shape check shared by the kernels' wrappers: a ``(batch, n, n)``
    batch with 1 ≤ n ≤ ``max_n`` (the kernel's ceiling, :data:`MAX_N`
    unless it states its own).  Larger n is rejected, never rerouted:
    lifting the ceiling is kernel work, not a silent detour."""
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"{what}: expected (batch, n, n), got {tuple(a.shape)}")
    n = a.shape[-1]
    if not 1 <= n <= max_n:
        raise ValueError(
            f"{what}: n = {n} is outside the kernel's range 1..{max_n} "
            f"(the matrix must fit the shared memory of one thread block "
            f"or cluster)")


def launch_args(a: torch.Tensor) -> tuple[int, int]:
    """(device index, raw stream handle) for launching on ``a``'s device
    on PyTorch's current stream."""
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def check_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32 on a CUDA device."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{what}: needs float32 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")


def on_device(a: torch.Tensor, what: str, cuda_fn, plain_fn, *args):
    """``cuda_fn(*args)`` when ``a`` lies on a CUDA device, the plain
    version ``plain_fn(*args)`` when it lies on the CPU; any other device
    raises.  A CUDA tensor never takes the plain version."""
    if a.device.type == "cuda":
        return cuda_fn(*args)
    if a.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"{what}: unsupported device {a.device}")
