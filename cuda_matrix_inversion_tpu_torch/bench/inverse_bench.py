"""Batched-inversion benchmark CLI.

Counterpart of ``cuda_matrix_inversion_tpu/bench/inverse_bench.py`` and of
the reference's ``src/inverse_bench.c``: argv contract
``TEST_FOLDER NUM_REPS NUM_DUPLICATES [-csv]`` (``inverse_bench.c:276-303``),
the algorithms benchmarked side by side over replicated fixtures with
Welford stats and an average-L1-error column against the float64 inverse
(``bench_parallel``, ``inverse_bench.c:76-238``).

    python -m cuda_matrix_inversion_tpu_torch.bench.inverse_bench \\
        TEST_FOLDER NUM_REPS NUM_DUPLICATES [-csv] [--algorithms ...] \\
        [--dtype float32|float64] [--transfers] [--device cuda|cpu]

Timing:

* host rows (names ending in ``_cpu``) run on NumPy arrays, timed on the
  host clock;
* device rows run on the batch staged on ``--device`` once, untimed: one
  untimed warm-up call (the kernels' build and first launch), then each
  rep between two CUDA events on the current stream (the host clock on
  ``--device cpu``);
* ``--transfers`` times NumPy in → lane → NumPy out on the host clock,
  the reference's convention (``report/report.tex:104``).

Alongside the reference's L1 column, human mode prints the gate metric
max ‖AA⁻¹−I‖∞ (fp64) for each row.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench.reporting import (
    BenchReporter,
    identity_error_inf,
    l1_total,
    print_device_info,
)
from cuda_matrix_inversion_tpu_torch.io.mats import read_test_folder
from cuda_matrix_inversion_tpu_torch.io.replicate import replicate_matrices
from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)
from cuda_matrix_inversion_tpu_torch.utils.errors import EnsureError, ensure
from cuda_matrix_inversion_tpu_torch.utils.timer import time_reps

# Default roster — the analog of the six-way comparison in
# ``inverse_bench.c:84-89``.  Host rows are the LAPACK oracle; the native
# rows are the multithreaded-CPU rows (``lu_blas_omp_cpu`` analog), skipped
# silently when the C++ oracle is not built.
DEFAULT_ALGORITHMS = (
    "lu_cpu",
    "cholesky_cpu",
    "lu_native_cpu",
    "cholesky_native_cpu",
    "lu",
    "cholesky",
    "gauss_pallas",
    "lu_pallas",
    "cholesky_pallas",
    "newton_schulz_pallas",
    "newton_schulz_spd_pallas",
    "newton_schulz_spd10_pallas",
)

# Roster for the general-square (non-SPD) fixture family: the pivoting
# lanes, the κ ≲ 500 split-precision Newton-Schulz lane, the blocked LU at
# any n and the fp64-class refinement (the SPD-only rows would fail the
# gate on purpose).
GENERAL_ALGORITHMS = (
    "lu_cpu",
    "gauss_cpu",
    "lu_native_cpu",
    "lu",
    "gauss_pallas",
    "lu_pallas",
    "newton_schulz_pan500_pallas",
    "lu_bign_pallas",
    "lu_hiacc",
)

# The ONLY rows that may be skipped silently when unregistered: the
# optional C++ oracle.  Every other unknown name is an error, as the
# reference aborts on bad input (``inverse_bench.c:254-270``): a bench
# that no-ops on a typo publishes an empty table.
OPTIONAL_ALGORITHMS = frozenset({"lu_native_cpu", "cholesky_native_cpu"})


def resolve_algorithms(requested, available) -> list:
    """Split comma lists, validate against the registry, fail loudly on
    unknown names; drop unbuilt OPTIONAL rows silently."""
    names: list = []
    for item in requested:
        names.extend(s for s in str(item).split(",") if s)
    unknown = [n for n in names
               if n not in available and n not in OPTIONAL_ALGORITHMS]
    ensure(not unknown,
           "unknown inversion algorithm(s) %s; available: %s",
           unknown, sorted(available))
    return [n for n in names if n in available]


def run_bench(
    folder: str,
    num_reps: int,
    num_duplicates: int,
    csv: bool = False,
    algorithms=DEFAULT_ALGORITHMS,
    dtype=np.float32,
    transfers: bool = False,
    stream=None,
    device="cuda",
) -> BenchReporter:
    dev = resolve_device(device)
    data = read_test_folder(folder, kind="inverse", dtype=dtype)
    a = replicate_matrices(data["a"], num_duplicates)
    a_inv_ref = (replicate_matrices(data["aInv"], num_duplicates)
                 if "aInv" in data else None)
    num_matrices, n, _ = a.shape

    stream = stream or sys.stdout
    rep = BenchReporter(num_matrices, n, num_reps, csv=csv, stream=stream)
    if not csv:
        print_device_info(stream, dev)

    a_dev = None
    for name in resolve_algorithms(algorithms, set(list_inverse_algorithms())):
        fn = get_inverse_algorithm(name)
        entry = rep.entry(name)
        if name.endswith("_cpu"):
            inv = None
            for _ in range(num_reps):
                entry.timer.start()
                inv = fn(a)
                entry.timer.stop()
        elif transfers:
            def round_trip():
                return fn(torch.from_numpy(a).to(dev)).cpu().numpy()

            round_trip()  # the build and first launch stay outside
            inv = None
            for _ in range(num_reps):
                entry.timer.start()
                inv = round_trip()
                entry.timer.stop()
        else:
            if a_dev is None:
                a_dev = torch.tensor(a, device=dev)
            inv = time_reps(entry.timer, lambda: fn(a_dev), num_reps,
                            dev).cpu().numpy()

        if a_inv_ref is not None:
            entry.total_error = l1_total(inv, a_inv_ref)
        extra = {"max ||AA^-1 - I||_inf": f"{identity_error_inf(a, inv):.3e}"}
        rep.report(name, extra_metrics=extra)
    return rep


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="inverse_bench",
        description="Batched matrix inversion benchmark (PyTorch/CUDA "
                    "rebuild of src/inverse_bench.c)",
    )
    p.add_argument("test_folder")
    p.add_argument("num_reps", type=int)
    p.add_argument("num_duplicates", type=int)
    p.add_argument("-csv", action="store_true", dest="csv")
    p.add_argument("--algorithms", nargs="+", default=list(DEFAULT_ALGORITHMS))
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--transfers", action="store_true",
                   help="time NumPy in -> lane -> NumPy out per rep "
                        "(reference parity) instead of device-resident")
    p.add_argument("--device", default="cuda",
                   help="device of the device rows (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def run_argv(argv=None, stream=None) -> BenchReporter:
    """What :func:`main` runs: parse the command line, run the bench
    (its rows printed to ``stream``) and return the reporter, whose
    entries hold each row's timer, error and extra metrics."""
    args = _parser().parse_args(argv)
    return run_bench(
        args.test_folder,
        args.num_reps,
        args.num_duplicates,
        csv=args.csv,
        algorithms=args.algorithms,
        dtype=np.dtype(args.dtype),
        transfers=args.transfers,
        device=args.device,
        stream=stream,
    )


def main(argv=None) -> int:
    try:
        run_argv(argv)
    except EnsureError as e:
        print(f"inverse_bench: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
