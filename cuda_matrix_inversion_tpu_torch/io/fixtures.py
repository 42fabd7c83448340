"""Deterministic NumPy fixture batches.

Copies of ``make_spd_batch`` and ``make_square_batch`` from
``cuda_matrix_inversion_tpu/io/fixtures.py``.  The port carries its own
copies because importing the JAX package imports JAX, which the machine
with the GPU does not have; ``tests/test_torch_slice.py`` pins each copy
to its original.
"""

from __future__ import annotations

import numpy as np


def make_spd_batch(num: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    """Random symmetric diagonally-dominant SPD batch ``R + Rᵀ + dim·I``
    with R uniform(0, 1), in float64."""
    r = rng.random((num, dim, dim))
    return r + np.transpose(r, (0, 2, 1)) + dim * np.eye(dim)


def make_square_batch(num: int, dim: int, rng: np.random.Generator,
                      kappa_cap: float | None = None) -> np.ndarray:
    """Random general (nonsymmetric, sign-mixed) square batch in float64.

    Zero-mean Gaussian entries, so partial pivoting really swaps rows.
    Draws are rejected until their 2-norm condition number is at most
    ``kappa_cap`` (default ``4·dim``), so the fp32 gate measures the
    algorithm and not the draw.
    """
    cap = 4.0 * dim if kappa_cap is None else kappa_cap
    out = np.empty((num, dim, dim))
    got = 0
    while got < num:
        # draw only the deficit, padded ~30% for the rejection rate
        draw = min(num, max(4, int(1.3 * (num - got)) + 1))
        cand = rng.standard_normal((draw, dim, dim))
        ok = cand[np.linalg.cond(cand) <= cap]
        take = min(num - got, ok.shape[0])
        out[got:got + take] = ok[:take]
        got += take
    return out
