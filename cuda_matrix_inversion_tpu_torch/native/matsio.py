"""ctypes bindings for the native ``.mats`` parser (``matsio.cpp``).

Counterpart of ``cuda_matrix_inversion_tpu/native/matsio.py``.  The port's
:mod:`cuda_matrix_inversion_tpu_torch.io.mats` does not call it: the
Python parser there is the semantics reference this one is tested against.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    # Only successful loads are cached: a stale/missing .so may be rebuilt
    # later in the process (ensure_built), and lib_path() is a cheap stat.
    global _lib
    if _lib is not None:
        return _lib
    from cuda_matrix_inversion_tpu_torch.native.build import lib_path

    path = lib_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path, use_errno=True)
        lib.matsio_header.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.matsio_header.restype = ctypes.c_int
        lib.matsio_read.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.matsio_read.restype = ctypes.c_int64
        lib.matsio_write.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.matsio_write.restype = ctypes.c_int
        lib.matsio_replicate.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.matsio_replicate.restype = None
        _lib = lib
        return _lib
    except (OSError, AttributeError):
        # AttributeError: a loadable .so missing expected symbols (partial
        # rebuild) must degrade to the Python parser, same as oracle.py
        return None


def available() -> bool:
    return _load() is not None


def read_mats(path: str) -> np.ndarray:
    lib = _load()
    assert lib is not None
    num = ctypes.c_int64()
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    rc = lib.matsio_header(path.encode(), ctypes.byref(num), ctypes.byref(m), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"matsio: cannot parse header of {path}")
    count = num.value * m.value * n.value
    out = np.empty(count, dtype=np.float64)
    got = lib.matsio_read(path.encode(), out, count)
    if got != count:
        raise IOError(f"matsio: {path}: expected {count} values, parsed {got}")
    return out.reshape(num.value, m.value, n.value)


def write_mats(path: str, arr: np.ndarray, precision: int = 17) -> None:
    lib = _load()
    assert lib is not None
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
    num, m, n = arr.shape
    rc = lib.matsio_write(path.encode(), arr.reshape(-1), num, m, n, precision)
    if rc != 0:
        err = ctypes.get_errno()
        raise IOError(f"matsio: failed writing {path}"
                      + (f" ({os.strerror(err)})" if err else ""))


def replicate(arr: np.ndarray, times: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
    out = np.empty((times * src.shape[0],) + src.shape[1:], dtype=np.float64)
    lib.matsio_replicate(src.reshape(-1), out.reshape(-1), src.size, times)
    return out
