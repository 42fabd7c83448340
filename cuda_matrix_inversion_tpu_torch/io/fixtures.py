"""Deterministic NumPy fixture batches and the ``.mats`` fixture tree.

Copies of ``cuda_matrix_inversion_tpu/io/fixtures.py`` (the batch makers,
the ``generate_*`` writers and the command line), and of the κ-controlled
nonsymmetric class of ``cuda_matrix_inversion_tpu/bench/chip_tests.py``
(``make_nonsym_cond``).  The port carries its own copies because importing
the JAX package imports JAX, which the machine with the GPU does not have;
``tests/test_torch_slice.py``, ``tests/test_torch_gp.py``,
``tests/test_torch_lu_bign.py`` and ``tests/test_torch_bench_cli.py`` pin
each copy to its original (the tree file for file, byte for byte).

    python -m cuda_matrix_inversion_tpu_torch.io.fixtures ROOT \
        [--dims 8 16 32 64 128] [--num 100] [--seed 0]

writes ``inverse_{num}_{d}x{d}`` (``a``, ``aInv``), ``gaussian_{num}_{d}x{d}``
(the seven GP files) and ``square_5_{d}x{d}`` (general matrices, κ ≤ 4d)
for each dimension, ``singular/`` (hand-written singular 3×3 cases) and
``spd_100_64_64.mats``.
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


def generate_inverse_fixtures(path: str, dim: int, num: int = 100,
                              seed: int = 0) -> None:
    """``a.mats`` (SPD) and its float64 inverse ``aInv.mats``."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed + dim)
    a = make_spd_batch(num, dim, rng)
    write_mats(os.path.join(path, "a.mats"), a)
    write_mats(os.path.join(path, "aInv.mats"), np.linalg.inv(a))


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


def generate_square_fixtures(path: str, dim: int, num: int = 5,
                             seed: int = 0) -> None:
    """``a.mats`` + ``aInv.mats`` for the general-square family (5
    matrices a dimension by default)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed + 500 + dim)
    a = make_square_batch(num, dim, rng)
    write_mats(os.path.join(path, "a.mats"), a)
    write_mats(os.path.join(path, "aInv.mats"), np.linalg.inv(a))


def singular_demo_batch() -> np.ndarray:
    """Hand-written 3×3 batch for the failure paths: matrix 0 is regular,
    matrix 1 is rank 2 (row 2 = row 0 + row 1), matrix 2 has a zero
    column."""
    regular = np.array([[4.0, 1.0, 0.0],
                        [1.0, 5.0, 2.0],
                        [0.0, 2.0, 6.0]])
    rank2 = np.array([[1.0, 2.0, 3.0],
                      [4.0, 5.0, 6.0],
                      [5.0, 7.0, 9.0]])  # row2 = row0 + row1
    zerocol = np.array([[1.0, 0.0, 2.0],
                        [3.0, 0.0, 4.0],
                        [5.0, 0.0, 6.0]])
    return np.stack([regular, rank2, zerocol])


def generate_singular_fixtures(path: str) -> None:
    """``singular_batch.mats`` plus one ``.txt`` file a matrix in the
    reference prototypes' stdin format (``n``, then n rows)."""
    os.makedirs(path, exist_ok=True)
    batch = singular_demo_batch()
    write_mats(os.path.join(path, "singular_batch.mats"), batch)
    for name, m in (("regular_3x3", batch[0]),
                    ("singular_rank2_3x3", batch[1]),
                    ("singular_zerocol_3x3", batch[2])):
        with open(os.path.join(path, f"{name}.txt"), "w") as f:
            f.write(f"{m.shape[0]}\n")
            for row in m:
                f.write("\t".join(f"{v:.1f}" for v in row) + "\n")


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


def generate_all(root: str, dims=(8, 16, 32, 64, 128), num: int = 100,
                 seed: int = 0) -> None:
    """The whole fixture tree (see the module docstring)."""
    for dim in dims:
        generate_inverse_fixtures(
            os.path.join(root, f"inverse_{num}_{dim}x{dim}"), dim, num, seed)
        generate_gaussian_fixtures(
            os.path.join(root, f"gaussian_{num}_{dim}x{dim}"), dim, num, seed)
        generate_square_fixtures(
            os.path.join(root, f"square_5_{dim}x{dim}"), dim, 5, seed)
    generate_singular_fixtures(os.path.join(root, "singular"))
    rng = np.random.default_rng(seed + 424242)
    write_mats(os.path.join(root, "spd_100_64_64.mats"),
               make_spd_batch(100, 64, rng))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Generate the .mats benchmark fixtures")
    p.add_argument("root", help="output directory")
    p.add_argument("--dims", type=int, nargs="+", default=[8, 16, 32, 64, 128])
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    generate_all(args.root, tuple(args.dims), args.num, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
