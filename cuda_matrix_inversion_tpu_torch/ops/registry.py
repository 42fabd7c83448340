"""Algorithm registry for batched inversion — counterpart of
``cuda_matrix_inversion_tpu/ops/registry.py``.

Lane names and keyword arguments are the JAX registry's, so tests and
bench rosters map one to one.  The lanes' keyword arguments, with each
fixed Newton-Schulz lane's resolved schedule (round counts and the
per-round scalars of ``scaled_round_coeffs``), are the system's only
state: :func:`build_lane_table` derives that table from keyword
dictionaries, and the CPU tests feed it the JAX registry's
``functools.partial.keywords`` and require the result to equal
:data:`LANES` exactly.

Every algorithm takes and returns a ``(batch, n, n)`` tensor on any
supported device.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping

from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_cholesky,
    cuda_gauss_jordan,
    cuda_lu,
    double_single,
    linalg,
    lu_bign,
    newton_schulz,
)

# Keyword arguments of every lane, as the JAX registry binds them.
LANE_KEYWORDS: dict[str, dict] = {
    "newton_schulz_spd10_pallas": {"init": "spd", "lo_iters": 4,
                                   "hi_iters": 2, "mu_min": 0.03},
    "newton_schulz_spd_pallas": {"init": "spd"},
    "newton_schulz_pallas": {},
    "newton_schulz_pan500_pallas": {"precision": "split3"},
    "newton_schulz": {},
    "newton_schulz_spd": {"init": "spd"},
    "lu_pallas": {},
    "gauss_pallas": {},
    "lu": {},
    "cholesky": {},
    "cholesky_pallas": {},
    "lu_bign_pallas": {},
    "lu_hiacc": {"algorithm": "lu_pallas", "iters": 3},
}

_FUNCTIONS: dict[str, Callable] = {
    "newton_schulz_spd10_pallas": newton_schulz.inverse_newton_schulz_fixed,
    "newton_schulz_spd_pallas": newton_schulz.inverse_newton_schulz_fixed,
    "newton_schulz_pallas": newton_schulz.inverse_newton_schulz_fixed,
    "newton_schulz_pan500_pallas": newton_schulz.inverse_newton_schulz_fixed,
    "newton_schulz": newton_schulz.inverse_newton_schulz,
    "newton_schulz_spd": newton_schulz.inverse_newton_schulz,
    "lu_pallas": cuda_lu.inverse_lu,
    "gauss_pallas": cuda_gauss_jordan.inverse_gauss_jordan,
    "lu": linalg.inverse_lu,
    "cholesky": linalg.inverse_cholesky,
    "cholesky_pallas": cuda_cholesky.inverse_cholesky,
    "lu_bign_pallas": lu_bign.inverse_lu_big,
    "lu_hiacc": double_single.inverse_hiacc,
}


def _plain(v):
    """NumPy scalars (``.item()``) to Python values."""
    return v.item() if hasattr(v, "item") else v


def build_lane_table(keywords: Mapping[str, Mapping]) -> dict[str, dict]:
    """Lane table from per-lane keyword dictionaries (plain dicts or NumPy
    scalars): ``{name: {"keywords": {...}, "schedule": Schedule | None}}``,
    where fixed Newton-Schulz lanes carry their resolved schedule."""
    table = {}
    for name, kw in keywords.items():
        if name not in _FUNCTIONS:
            raise KeyError(f"unknown lane {name!r}")
        kw = {k: _plain(v) for k, v in kw.items()}
        fixed = _FUNCTIONS[name] is newton_schulz.inverse_newton_schulz_fixed
        table[name] = {
            "keywords": kw,
            "schedule": newton_schulz.resolve_schedule(**kw) if fixed else None,
        }
    return table


LANES = build_lane_table(LANE_KEYWORDS)


def get_inverse_algorithm(name: str) -> Callable:
    if name not in LANES:
        raise KeyError(f"unknown inversion algorithm {name!r}; have "
                       f"{list_inverse_algorithms()}")
    return functools.partial(_FUNCTIONS[name], **LANES[name]["keywords"])


def list_inverse_algorithms(cpu: bool | None = None) -> list[str]:
    """Registered lane names.  ``cpu=True`` lists the host-oracle lanes,
    which the port does not have yet."""
    return [] if cpu else sorted(LANES)
