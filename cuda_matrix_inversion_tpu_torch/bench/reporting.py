"""Benchmark reporting: the reference's two output formats, byte-compatible.

Reference counterparts: the ``BENCH_REPORT`` macro family
(``src/inverse_bench.c:41-74``, ``src/gauss_bench.cu:478-532``) and the
``TIMER_LOG`` phase CSV (``include/timer.h:8-9``).

Formats produced:

* csv, reps==1:  ``numMatrices N numReps name total_ms avg_error``
* csv, reps>1:   ``numMatrices N numReps name total_ms mean_ms var_ms avg_error``
* human:         ``name - B NxN matrices, replicated R times, runtime ...``
* detailed phase lines: ``name,numMatrices,n,ms,ns``

so the reference's MATLAB analysis scripts (``results/generate_plots.m``,
``plotdimension.m``) parse our output unchanged.

A copy of ``cuda_matrix_inversion_tpu/bench/reporting.py`` (the JAX
package cannot be imported where JAX is missing), with
:func:`print_device_info` reading the CUDA device;
``tests/test_torch_bench_cli.py`` holds each line and column to the
original's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional, TextIO

import numpy as np

from cuda_matrix_inversion_tpu_torch.utils.timer import Timer


def format_ms(ms: float) -> str:
    """Milliseconds for the human-readable rows, never as a bare ``0.0000``.

    A published ``runtime 0.0000 ms`` reads as "free" when it means "below
    the 4-decimal resolution": values under 10 µs
    switch to µs resolution, and exact zero — a measurement below the
    timer's granularity entirely — says so.
    """
    if ms == 0.0:
        return "<timer-granularity"
    if abs(ms) < 0.01:
        return f"{ms * 1e3:.4f} us"
    return f"{ms:.4f} ms"


def l1_total(x: np.ndarray, ref: np.ndarray) -> float:
    """Total L1 distance over the whole batch (ref ``vec_diff``+``vec_sum``,
    ``src/gauss_bench.cu:470-476``) — this is what ``BenchEntry.total_error``
    stores; the reporter divides by numMatrices exactly once
    (``inverse_bench.c:55-62``)."""
    return float(np.abs(np.asarray(x, dtype=np.float64)
                        - np.asarray(ref, dtype=np.float64)).sum())


def l1_error(x: np.ndarray, ref: np.ndarray, num_matrices: int) -> float:
    """Average per-matrix L1 distance (ref ``inverse_bench.c:49-51``)."""
    return l1_total(x, ref) / num_matrices


def identity_error_inf(a: np.ndarray, a_inv: np.ndarray) -> float:
    """The upgraded gate metric: max ‖AA⁻¹−I‖∞ over the batch
    (BASELINE.json: < 1e-4 fp32)."""
    a64 = np.asarray(a, dtype=np.float64)
    prod = a64 @ np.asarray(a_inv, dtype=np.float64)
    n = a.shape[-1]
    resid = np.abs(prod - np.eye(n))
    return float(resid.sum(axis=-1).max())  # ∞-norm = max row sum


@dataclass
class BenchEntry:
    name: str
    timer: Timer
    total_error: float = 0.0
    # the extra metrics of the row's last report (human mode prints them)
    extra: dict = field(default_factory=dict)

    @property
    def total_ms(self) -> float:
        return self.timer.stats.total * 1e3

    @property
    def mean_ms(self) -> float:
        return self.timer.stats.mean * 1e3

    @property
    def var_ms(self) -> float:
        return self.timer.stats.variance * 1e6


@dataclass
class BenchReporter:
    num_matrices: int
    n: int
    num_reps: int
    csv: bool = False
    stream: TextIO = field(default_factory=lambda: sys.stdout)
    entries: dict = field(default_factory=dict)

    def entry(self, name: str) -> BenchEntry:
        if name not in self.entries:
            self.entries[name] = BenchEntry(name, Timer(name))
        return self.entries[name]

    def report(self, name: str, extra_metrics: Optional[dict] = None) -> None:
        e = self.entries[name]
        e.extra = dict(extra_metrics or {})
        avg_err = e.total_error / self.num_matrices
        if self.csv:
            if self.num_reps > 1:
                print(
                    f"{self.num_matrices} {self.n} {self.num_reps} {name} "
                    f"{e.total_ms:e} {e.mean_ms:e} {e.var_ms:e} {avg_err:e}",
                    file=self.stream,
                )
            else:
                print(
                    f"{self.num_matrices} {self.n} {self.num_reps} {name} "
                    f"{e.total_ms:e} {avg_err:e}",
                    file=self.stream,
                )
        else:
            if self.num_reps > 1:
                print(
                    f"{name} - {self.num_matrices} {self.n}x{self.n} matrices, "
                    f"replicated {self.num_reps} times, "
                    f"runtime {format_ms(e.total_ms)} "
                    f"({format_ms(e.mean_ms)} average, "
                    f"{e.var_ms:.4e} ms^2 variance), "
                    f"average error {avg_err:.4e}",
                    file=self.stream,
                )
            else:
                print(
                    f"{name} - {self.num_matrices} {self.n}x{self.n} matrices, "
                    f"replicated {self.num_reps} times, "
                    f"runtime {format_ms(e.total_ms)}, "
                    f"average error {avg_err:.4e}",
                    file=self.stream,
                )
        if extra_metrics and not self.csv:
            for k, v in extra_metrics.items():
                print(f"  {k}: {v}", file=self.stream)

    def report_all(self) -> None:
        for name in self.entries:
            self.report(name)


def print_device_info(stream: TextIO = None, device="cuda") -> None:
    """Device line (ref ``printDevProp``, ``src/gauss_bench.cu:535-575``):
    the CUDA device's name and ``nvidia-smi``'s name and power limit, or
    ``cpu`` for a CPU run."""
    import subprocess

    import torch

    stream = stream or sys.stdout
    device = torch.device(device)
    if device.type != "cuda":
        print("device: cpu", file=stream)
        return
    index = device.index if device.index is not None else 0
    print(f"device: {torch.cuda.get_device_name(index)} id={index} "
          f"platform=cuda count={torch.cuda.device_count()}", file=stream)
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return
    print(f"  nvidia-smi: {smi.stdout.strip()}", file=stream)


def parse_csv_rows(csv_path: str) -> list:
    """Parse ``numMatrices n reps name total_ms [mean_ms var_ms] err`` rows
    into dicts (phase-log lines are skipped)."""
    rows = []
    with open(csv_path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if len(parts) < 6:
                continue
            try:
                row = {
                    "lineno": lineno,
                    "num_matrices": int(parts[0]),
                    "n": int(parts[1]),
                    "reps": int(parts[2]),
                    "name": parts[3],
                    "total_ms": float(parts[4]),
                    "err": float(parts[-1]),
                    "line": line,
                }
            except ValueError:
                continue
            row["mean_ms"] = (float(parts[5]) if len(parts) >= 8
                              else row["total_ms"] / max(row["reps"], 1))
            rows.append(row)
    return rows


def audit_outliers(csv_path: str, k: float = 3.0) -> list:
    """Flag sweep rows that are >k× intra-algorithm outliers.

    A stall during one config lands an inflated row in the permanent CSV
    with nothing marking it.  Noise only ever *inflates* a time, so each
    (algorithm, n) sibling row gives an upper bound on what any other
    batch size may honestly cost.  Total batch time is
    at most linear in the batch count, but never decreasing: sibling j
    bounds row i at ``mean_ms_j × max(1, num_i / num_j)``.  (The earlier
    per-matrix-flat rule is the num_i ≥ num_j half of this; it misfired
    on the ``square_5_*`` family, where a 5-matrix launch legitimately
    costs many× more *per matrix* than an 80-matrix one — fixed launch
    cost amortizes, it doesn't vanish.)  A row above ``k`` × its tightest
    sibling bound is noise, not a measurement.

    Returns flag dicts: the parsed row plus ``ratio`` and
    ``bound_ms`` (the tightest sibling-implied batch-total bound).
    Rows with no sibling are never flagged.
    """
    rows = parse_csv_rows(csv_path)
    groups: dict = {}
    for r in rows:
        groups.setdefault((r["name"], r["n"]), []).append(r)
    flags = []
    for (_, _), grp in groups.items():
        if len(grp) < 2:
            continue
        for r in grp:
            bounds = [q["mean_ms"] * max(1.0, r["num_matrices"]
                                         / q["num_matrices"])
                      for q in grp if q is not r]
            bound = min(bounds)
            if bound > 0 and r["mean_ms"] > k * bound:
                flags.append({**r, "ratio": r["mean_ms"] / bound,
                              "bound_ms": bound})
    return sorted(flags, key=lambda f: -f["ratio"])


def write_errors_companion(csv_path: str, out_path: str = None) -> str:
    """Write the reference's separate ``*-errors.txt`` companion file.

    The reference ships runtime+error pairs in their own file
    (``results/inverse-bench-errors.txt``: ``numMatrices
    n dups name total_ms avg_error``) next to the per-rep timer CSV; our
    main CSV embeds the error as its last column, so the companion is
    derived: ``numMatrices n numReps name total_ms avg_error`` — one row
    per benchmark, same leading-triple + name keys, directly consumable
    by the reference's error-bar tooling.
    """
    import os

    if out_path is None:
        root, ext = os.path.splitext(csv_path)
        out_path = f"{root}-errors{ext or '.txt'}"
    rows = []
    with open(csv_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue  # phase-log or malformed line
            batch, n, reps, name = parts[0], parts[1], parts[2], parts[3]
            total_ms, err = parts[4], parts[-1]
            rows.append(f"{batch} {n} {reps} {name} {total_ms} {err}\n")
    with open(out_path, "w") as f:
        f.writelines(rows)
    return out_path
