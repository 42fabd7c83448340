"""The accuracy gate metric.

Copy of ``identity_error_inf`` from
``cuda_matrix_inversion_tpu/bench/reporting.py`` (NumPy only; the port
cannot import the JAX package where JAX is missing).
"""

from __future__ import annotations

import numpy as np


def identity_error_inf(a: np.ndarray, a_inv: np.ndarray) -> float:
    """The gate metric: max ‖AA⁻¹−I‖∞ over the batch, computed in fp64
    (the fp32 gate is < 1e-4)."""
    a64 = np.asarray(a, dtype=np.float64)
    prod = a64 @ np.asarray(a_inv, dtype=np.float64)
    n = a.shape[-1]
    resid = np.abs(prod - np.eye(n))
    return float(resid.sum(axis=-1).max())  # ∞-norm = max row sum
