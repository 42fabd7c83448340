"""Scalar/dtype configuration and the batched-matrix container.

Counterpart of ``cuda_matrix_inversion_tpu/types.py``: a runtime-selectable
default dtype (fp32/fp64/bf16) and a shaped host batch container.  The
default dtype here is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.io.replicate import replicate_matrices

_DEFAULT_DTYPE = torch.float32

_SUPPORTED = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def default_dtype() -> torch.dtype:
    """The framework-wide default scalar dtype."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Switch the default precision: a ``torch.dtype``, a NumPy dtype or
    one of the names ``float32``, ``float64``, ``bfloat16``."""
    global _DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _SUPPORTED:
        raise ValueError(
            f"unsupported dtype {name!r}; pick one of {sorted(_SUPPORTED)}")
    _DEFAULT_DTYPE = _SUPPORTED[name]


@dataclasses.dataclass
class MatrixBatch:
    """A host-side batch of equally-shaped matrices.

    Data is a C-contiguous ``(batch, m, n)`` ndarray; row ``i`` of matrix
    ``k`` is ``data[k, i, :]``.
    """

    data: np.ndarray  # (batch, m, n)

    def __post_init__(self):
        arr = np.asarray(self.data)
        if arr.ndim == 2:  # a single matrix → batch of one
            arr = arr[None]
        if arr.ndim != 3:
            raise ValueError(f"MatrixBatch wants (batch, m, n); got {arr.shape}")
        self.data = np.ascontiguousarray(arr)

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def m(self) -> int:
        return self.data.shape[1]

    @property
    def n(self) -> int:
        return self.data.shape[2]

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "MatrixBatch":
        return MatrixBatch(self.data.astype(dtype))

    def replicate(self, times: int) -> "MatrixBatch":
        """Duplicate the whole batch ``times``× (ref ``replicateMatrices``,
        ``src/helper.cu:54-72``)."""
        return MatrixBatch(replicate_matrices(self.data, times))

    def __getitem__(self, k) -> np.ndarray:
        return self.data[k]

    def __len__(self) -> int:
        return self.batch_size


def as_batch(x, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Coerce input to a C-contiguous (batch, m, n) ndarray."""
    if isinstance(x, MatrixBatch):
        x = x.data
    arr = np.asarray(x, dtype=dtype)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected (batch, m, n), got shape {arr.shape}")
    return np.ascontiguousarray(arr)
