"""Deterministic NumPy fixture batches.

Copies of ``make_spd_batch``, ``make_square_batch`` and
``generate_gaussian_fixtures`` from ``cuda_matrix_inversion_tpu/io/fixtures.py``,
and of the κ-controlled nonsymmetric class of
``cuda_matrix_inversion_tpu/bench/chip_tests.py`` (``make_nonsym_cond``).
The port carries its own copies because importing the JAX package imports
JAX, which the machine with the GPU does not have;
``tests/test_torch_slice.py``, ``tests/test_torch_gp.py`` and
``tests/test_torch_lu_bign.py`` pin each copy to its original.
"""

from __future__ import annotations

import os

import numpy as np

from cuda_matrix_inversion_tpu_torch.io.mats import write_mats


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


def make_nonsym_cond(batch: int, n: int, kappa: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Nonsymmetric float32 batch with exact 2-norm condition number
    ``kappa``: a geomspace spectrum between two independent orthogonal
    factors (copy of ``bench/chip_tests.py::_make_nonsym_cond``)."""
    q1, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    s = np.geomspace(1.0 / kappa, 1.0, n)
    return ((q1 * s[None, None, :]) @ q2).astype(np.float32)


def make_gp_batch(num: int, dim: int, rng: np.random.Generator) -> dict:
    """One GP fixture set in memory, float64: ``a, c, d`` (num, dim, 1),
    ``b`` (num, dim, dim) SPD, ``e`` (num, 1, 1), and the fp64 ground
    truth ``means = aᵀK⁻¹d``, ``variances = e − aᵀK⁻¹a`` with
    K = B + diag(c), each (num, 1, 1)."""
    a = rng.random((num, dim, 1))
    b = make_spd_batch(num, dim, rng)
    c = rng.random((num, dim, 1))
    d = rng.random((num, dim, 1))
    e = rng.random((num, 1, 1))
    k_inv = np.linalg.inv(b + np.eye(dim) * c[:, :, 0][:, None, :])
    at = np.transpose(a, (0, 2, 1))
    return {"a": a, "b": b, "c": c, "d": d, "e": e,
            "means": at @ (k_inv @ d), "variances": e - at @ (k_inv @ a)}


def generate_gaussian_fixtures(path: str, dim: int, num: int = 100,
                               seed: int = 0) -> None:
    """The 7-file GP fixture set (``a b c d e means variances`` ``.mats``)."""
    os.makedirs(path, exist_ok=True)
    data = make_gp_batch(num, dim, np.random.default_rng(seed + 1000 + dim))
    for name, arr in data.items():
        write_mats(os.path.join(path, f"{name}.mats"), arr)
