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

Device algorithms take and return a ``(batch, n, n)`` tensor on any
supported device.  :func:`register_inverse` adds a lane at run time, as
the JAX registry's does: a device lane beside :data:`LANES` (with no
keywords and no schedule), or a host lane (``cpu=True``) in a table of
its own.  The host lanes are the LAPACK oracle of :mod:`.cpu_reference`
(``lu_cpu``, ``cholesky_cpu``, ``gauss_cpu``) and, once its library loads,
the native one (``lu_native_cpu``, ``cholesky_native_cpu``): NumPy in,
NumPy out, on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping

from cuda_matrix_inversion_tpu_torch.ops import (
    cpu_reference,
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
# Host lanes — analog of inverse_lu_blas / inverse_chol_blas.
_CPU_ALGORITHMS: dict[str, Callable] = {
    "lu_cpu": cpu_reference.inverse_lu,
    "cholesky_cpu": cpu_reference.inverse_cholesky,
    "gauss_cpu": cpu_reference.inverse_gauss_jordan,
}
# Lanes whose device path runs one of the port's kernels (the JAX
# registry's pallas=True lanes: the *_pallas lanes, and lu_hiacc on K2).
_PALLAS_ALGORITHMS = {name for name in LANES if name.endswith("_pallas")}
_PALLAS_ALGORITHMS.add("lu_hiacc")


def register_inverse(name: str, fn: Callable, cpu: bool = False,
                     pallas: bool = False) -> None:
    """Add (or replace) lane ``name``: a device lane, or with ``cpu=True``
    a host lane; ``pallas`` marks a lane that runs a kernel."""
    if cpu:
        _CPU_ALGORITHMS[name] = fn
    else:
        _FUNCTIONS[name] = fn
        LANES[name] = {"keywords": {}, "schedule": None}
    if pallas:
        _PALLAS_ALGORITHMS.add(name)


def is_pallas_algorithm(name: str) -> bool:
    """True when lane ``name``'s device path runs one of the port's
    kernels."""
    return name in _PALLAS_ALGORITHMS


def _populate_native() -> None:
    """Register the native oracle's lanes once its library loads.  Retried
    on every listing and host-lane lookup until then, since the library
    may be built later in the process (``oracle.available()`` stats three
    files while it is missing: never on a device lane's lookup)."""
    if "lu_native_cpu" in _CPU_ALGORITHMS:
        return
    from cuda_matrix_inversion_tpu_torch.native import oracle

    if oracle.available():
        register_inverse("lu_native_cpu", oracle.inverse_lu, cpu=True)
        register_inverse("cholesky_native_cpu", oracle.inverse_cholesky,
                         cpu=True)


def get_inverse_algorithm(name: str) -> Callable:
    if name in LANES:
        return functools.partial(_FUNCTIONS[name], **LANES[name]["keywords"])
    _populate_native()
    if name in _CPU_ALGORITHMS:
        return _CPU_ALGORITHMS[name]
    raise KeyError(f"unknown inversion algorithm {name!r}; have "
                   f"{list_inverse_algorithms()}")


def list_inverse_algorithms(cpu: bool | None = None) -> list[str]:
    """Registered lane names: the device lanes (``cpu=False``), the host
    lanes (``cpu=True``), or both (``None``: the device lanes, then the
    host lanes), each group sorted."""
    _populate_native()
    if cpu is True:
        return sorted(_CPU_ALGORITHMS)
    if cpu is False:
        return sorted(LANES)
    return sorted(LANES) + sorted(_CPU_ALGORITHMS)
