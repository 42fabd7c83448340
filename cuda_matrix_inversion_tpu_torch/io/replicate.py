"""Batch replication — scales fixture batches for benchmarking.

Reference counterpart: ``replicateMatrices`` (``src/helper.cu:54-72``), a
host memcpy fan-out used by both bench CLIs to grow 100-matrix fixtures to
100×dups matrices.

A copy of ``cuda_matrix_inversion_tpu/io/replicate.py`` (NumPy only; the
port cannot import the JAX package where JAX is missing);
``tests/test_torch_slice.py`` pins it to the original.
"""

from __future__ import annotations

import numpy as np


def replicate_matrices(matrices: np.ndarray, times: int) -> np.ndarray:
    """Tile a ``(num, m, n)`` batch ``times``× along the batch axis."""
    arr = np.asarray(matrices)
    if times < 1:
        raise ValueError(f"times must be >= 1, got {times}")
    if times == 1:
        return np.ascontiguousarray(arr)
    return np.ascontiguousarray(np.tile(arr, (times, 1, 1)))
