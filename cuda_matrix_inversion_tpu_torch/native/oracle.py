"""ctypes bindings for the native LAPACK+OpenMP oracle (``oracle.cpp``).

Counterpart of ``cuda_matrix_inversion_tpu/native/oracle.py``: the C++
twin of :mod:`cuda_matrix_inversion_tpu_torch.ops.cpu_reference`
(reference ``src/inverse.c``), registered as ``lu_native_cpu`` /
``cholesky_native_cpu`` once the shared library loads.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
# (path, mtime) of the last FAILED load: a present-but-unloadable .so
# (missing liblapack at runtime, corrupt build) would otherwise re-dlopen
# on every registry query, since _populate_native retries until the rows
# register.  Retried only when the .so changes.
_failed_load: Optional[tuple] = None


def _load() -> Optional[ctypes.CDLL]:
    # Only successful loads are cached unconditionally: a stale/missing
    # .so may be rebuilt later in the process (ensure_built), and
    # lib_path() is a cheap stat.
    global _lib, _failed_load
    if _lib is not None:
        return _lib
    import os

    from cuda_matrix_inversion_tpu_torch.native.build import lib_path

    path = lib_path()
    if path is None:
        return None
    mtime = os.path.getmtime(path)
    if _failed_load == (path, mtime):
        return None
    try:
        lib = ctypes.CDLL(path)
        for name, dt in (("oracle_inverse_lu_f32", np.float32),
                         ("oracle_inverse_lu_f64", np.float64),
                         ("oracle_inverse_chol_f32", np.float32),
                         ("oracle_inverse_chol_f64", np.float64)):
            fn = getattr(lib, name)
            fn.argtypes = [
                np.ctypeslib.ndpointer(dtype=dt, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            fn.restype = ctypes.c_int64
        for name, dt in (("oracle_gp_f32", np.float32),
                         ("oracle_gp_f64", np.float64)):
            fn = getattr(lib, name)
            nd = np.ctypeslib.ndpointer(dtype=dt, flags="C_CONTIGUOUS")
            fn.argtypes = [nd, nd, nd, nd, nd, nd, nd,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int64
        lib.oracle_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib
    except (OSError, AttributeError):
        _failed_load = (path, mtime)
        return None


def available() -> bool:
    return _load() is not None


def _run(kind: str, a: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native oracle not built "
                           "(python -m cuda_matrix_inversion_tpu_torch.native.build)")
    a = np.ascontiguousarray(a)
    if a.dtype == np.float64:
        fn = getattr(lib, f"oracle_inverse_{kind}_f64")
    else:
        a = a.astype(np.float32, copy=True) if a.dtype != np.float32 else a.copy()
        fn = getattr(lib, f"oracle_inverse_{kind}_f32")
    if a.dtype == np.float64:
        a = a.copy()
    bad = fn(a, a.shape[0], a.shape[1])
    if bad != 0:
        raise np.linalg.LinAlgError(
            f"native {kind} inversion failed at batch index {bad - 1}")
    return a


def inverse_lu(a: np.ndarray) -> np.ndarray:
    """Batched LU inversion (ref ``inverse_lu_blas_omp``, ``inverse.c:71-86``)."""
    return _run("lu", a)


def inverse_cholesky(a: np.ndarray) -> np.ndarray:
    """Batched SPD inversion (ref ``inverse_chol_blas_omp``, ``inverse.c:100-107``)."""
    return _run("chol", a)


def gp_mean_variance(a, b, c, d, e, solve: bool = True, want: str = "both"):
    """Batched GP mean/variance on the native C++/LAPACK/OpenMP oracle.

    The gauss_cpu.c equivalent (``calcluateMean[Solve]CPU`` /
    ``calcluateVariance[Solve]CPU``, ``src/gauss_cpu.c:23-277``) with the
    variance sign fixed to the documented formula.  Vectors may arrive as
    (batch, n) or (batch, n, 1); returns (means, variances) as (batch,)
    arrays in the input dtype (f32/f64).

    ``want``: "both" computes mean AND variance off one factorization
    (cheapest for combined callers); "mean"/"variance" run the reference's
    distinct single-output workloads (factorize + one RHS) — the bench CLI
    uses those so its two CPU timer rows measure what the reference's do.
    The unwanted output array is returned untouched (zeros).
    """
    wants = {"both": 0, "mean": 1, "variance": 2}
    if want not in wants:
        raise KeyError(f"want must be one of {sorted(wants)}, got {want!r}")
    lib = _load()
    if lib is None:
        raise RuntimeError("native oracle not built "
                           "(python -m cuda_matrix_inversion_tpu_torch.native.build)")
    b = np.ascontiguousarray(b)
    dt = np.float64 if b.dtype == np.float64 else np.float32
    b = b.astype(dt, copy=False)
    batch, n = b.shape[0], b.shape[-1]
    if batch == 0:
        return np.empty(0, dtype=dt), np.empty(0, dtype=dt)
    flat = lambda v: np.ascontiguousarray(  # noqa: E731
        np.asarray(v, dtype=dt).reshape(batch, -1)[:, :n])
    av, cv, dv = flat(a), flat(c), flat(d)
    ev = np.ascontiguousarray(np.asarray(e, dtype=dt).reshape(batch))
    mean = np.zeros(batch, dtype=dt)
    var = np.zeros(batch, dtype=dt)
    fn = lib.oracle_gp_f64 if dt == np.float64 else lib.oracle_gp_f32
    bad = fn(av, np.ascontiguousarray(b.reshape(-1)), cv, dv, ev, mean, var,
             batch, n, 1 if solve else 0, wants[want])
    if bad != 0:
        raise np.linalg.LinAlgError(
            f"native GP pipeline failed at batch index {bad - 1} (K not SPD?)")
    return mean, var


def num_threads() -> int:
    lib = _load()
    return int(lib.oracle_num_threads()) if lib else 0
