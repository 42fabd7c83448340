"""``.mats`` text fixture format: reader, writer, test-folder loader.

Copies of ``read_mats``, ``write_mats`` and ``read_test_folder`` from
``cuda_matrix_inversion_tpu/io/mats.py`` (NumPy only; the port cannot
import the JAX package where JAX is missing).  The JAX module's optional
native parser is not carried: this is its always-available fallback, and
``tests/test_torch_gp.py`` pins the copies to the originals.

Format: a header line ``numMatrices\\tm\\tn``, then for each matrix ``m``
lines of ``n`` tab-separated values (one matrix row per line), parsed into
a C-contiguous ``(num, m, n)`` ndarray.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.types import default_dtype

MAX_MATS_FILE_BYTES = 512 * 1024 * 1024

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _check(ok: bool, msg: str, *args) -> None:
    if not ok:
        raise ValueError(msg % args)


def read_mats(path: str, dtype=None,
              max_bytes: int = MAX_MATS_FILE_BYTES) -> np.ndarray:
    """Read a ``.mats`` file → ``(num, m, n)`` ndarray.  ``dtype=None`` is
    the NumPy counterpart of :func:`..types.default_dtype` (bfloat16 has
    none: pass a dtype)."""
    size = os.path.getsize(path)
    _check(size <= max_bytes, "%s is %d bytes; cap is %d", path, size,
           max_bytes)
    with open(path, "rb") as f:
        text = f.read()
    header_end = text.index(b"\n")
    header = text[:header_end].split()
    _check(len(header) == 3, "%s: bad .mats header %r", path,
           text[:header_end])
    num, m, n = (int(tok) for tok in header)
    body = np.array(text[header_end + 1:].split(), dtype=np.float64)
    _check(body.size == num * m * n,
           "%s: expected %d values (%d×%d×%d), found %d",
           path, num * m * n, num, m, n, body.size)
    if dtype is None:
        if default_dtype() not in _NUMPY_DTYPES:
            raise ValueError(f"default dtype {default_dtype()} has no NumPy "
                             f"counterpart; pass dtype= to read_mats")
        dtype = _NUMPY_DTYPES[default_dtype()]
    return np.ascontiguousarray(body.reshape(num, m, n).astype(dtype))


def write_mats(path: str, matrices: np.ndarray, precision: int = 17) -> None:
    """Write a ``(num, m, n)`` batch (or one ``(m, n)`` matrix) in ``.mats``
    format."""
    arr = np.asarray(matrices)
    if arr.ndim == 2:
        arr = arr[None]
    _check(arr.ndim == 3, "write_mats wants (num, m, n); got %r", arr.shape)
    num, m, n = arr.shape
    with open(path, "w") as f:
        f.write(f"{num}\t{m}\t{n}\n")
        np.savetxt(f, arr.reshape(num * m, n), fmt=f"%.{precision}g",
                   delimiter="\t")


def read_test_folder(folder: str, kind: str = "auto",
                     dtype=None) -> Dict[str, np.ndarray]:
    """Load a fixture directory with cross-file shape validation.

    ``kind='inverse'`` → ``{a, aInv}``; ``kind='gaussian'`` → the 7 GP
    files ``a, b, c, d, e, means, variances``.  ``'auto'`` picks
    ``gaussian`` when ``b.mats`` exists.
    """
    if kind == "auto":
        kind = ("gaussian" if os.path.exists(os.path.join(folder, "b.mats"))
                else "inverse")

    if kind == "inverse":
        a = read_mats(os.path.join(folder, "a.mats"), dtype)
        out = {"a": a}
        inv_path = os.path.join(folder, "aInv.mats")
        if os.path.exists(inv_path):
            a_inv = read_mats(inv_path, dtype)
            _check(a.shape == a_inv.shape, "a/aInv shape mismatch: %r vs %r",
                   a.shape, a_inv.shape)
            out["aInv"] = a_inv
        _check(a.shape[1] == a.shape[2],
               "inverse fixtures must be square; got %r", a.shape)
        return out

    if kind == "gaussian":
        names = ("a", "b", "c", "d", "e", "means", "variances")
        out = {nm: read_mats(os.path.join(folder, f"{nm}.mats"), dtype)
               for nm in names}
        num, n, _ = out["b"].shape
        _check(out["b"].shape == (num, n, n), "b must be square: %r",
               out["b"].shape)
        for nm in ("a", "c", "d"):
            _check(out[nm].shape == (num, n, 1),
                   "%s must be (num, n, 1)=(%d,%d,1); got %r", nm, num, n,
                   out[nm].shape)
        for nm in ("e", "means", "variances"):
            _check(out[nm].shape == (num, 1, 1),
                   "%s must be (num,1,1); got %r", nm, out[nm].shape)
        return out

    raise ValueError(f"unknown fixture kind {kind!r}")
