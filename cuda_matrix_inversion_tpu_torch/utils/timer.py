"""Monotonic timers with Welford online statistics and the reference CSV schema.

Reference counterpart: ``include/timer.h`` — ``TIMER_INIT/START/STOP``
(``timer.h:88-104``), ``TIMER_ACC`` Welford accumulation (``timer.h:106-111``),
``TIMER_LOG`` emitting ``name,numMatrices,n,ms,ns`` CSV lines (``timer.h:8-9``).
The same CSV schema is kept byte-compatible so the reference's MATLAB
post-processing (``results/generate_plots.m``) still parses our logs.

A copy of ``cuda_matrix_inversion_tpu/utils/timer.py`` on the host clock.
CUDA work is asynchronous, so ``Timer.stop`` takes optional tensors and
synchronises the CUDA device of each — the reference's
``cudaDeviceSynchronize`` before stopping kernel timers
(``src/gauss_bench.cu:192``, ``src/inverse_cholesky_gpu.cu:226``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, TextIO

import torch


@dataclass
class WelfordAccumulator:
    """Online mean/variance over benchmark reps (ref ``TIMER_ACC``,
    ``timer.h:106-111``)."""

    count: int = 0
    mean: float = 0.0
    _m2: float = 0.0
    total: float = 0.0

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        return self._m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)


@dataclass
class Timer:
    """A named phase timer (ref ``TIMER_INIT`` family, ``timer.h:88-132``)."""

    name: str
    stats: WelfordAccumulator = field(default_factory=WelfordAccumulator)
    _t0: Optional[float] = None
    last_seconds: float = 0.0

    def start(self) -> None:
        self._t0 = time.monotonic_ns()

    def stop(self, *block_on) -> float:
        """Stop; first synchronise the CUDA device of every tensor given
        (≈ cudaDeviceSynchronize).  CPU tensors need no wait."""
        for t in block_on:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        if self._t0 is None:
            raise RuntimeError(f"Timer {self.name!r} stopped before start")
        elapsed_ns = time.monotonic_ns() - self._t0
        self._t0 = None
        self.last_seconds = elapsed_ns / 1e9
        self.stats.add(self.last_seconds)
        return self.last_seconds

    def add(self, seconds: float) -> None:
        """Record one sample measured elsewhere (a CUDA event pair)."""
        self.last_seconds = seconds
        self.stats.add(seconds)

    def log_line(self, num_matrices: int, n: int) -> str:
        """One ``name,numMatrices,n,ms,ns`` CSV line (ref ``TIMER_LOG``,
        ``timer.h:8-9``): ms is fractional, ns is the full nanosecond
        total — matching ``results/gauss-bench.txt`` rows like
        ``means_cpu,100,128,15.9314,15931426``."""
        ns = int(round(self.last_seconds * 1e9))
        return f"{self.name},{num_matrices},{n},{ns / 1e6:.4f},{ns}"

    def log(self, num_matrices: int, n: int, stream: Optional[TextIO] = None) -> None:
        import sys

        print(self.log_line(num_matrices, n), file=stream or sys.stdout)


class timed:
    """Context manager sugar: ``with timed(timer) as t: ...``; tensors
    appended to ``t.block_on`` are waited for before the timer stops."""

    def __init__(self, timer: Timer):
        self.timer = timer
        self.block_on = []

    def __enter__(self):
        self.timer.start()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.timer.stop(*self.block_on)
        return False


def time_reps(timer: Timer, fn: Callable[[], object], reps: int, device):
    """Call ``fn()`` once untimed (the kernels' build and first launch stay
    outside the timer), then ``reps`` times, timing each call into
    ``timer``: between two CUDA events on the current stream when
    ``device`` is a CUDA device, on the host clock otherwise.  Returns the
    last call's result."""
    device = torch.device(device)
    out = fn()
    if device.type != "cuda":
        for _ in range(reps):
            timer.start()
            out = fn()
            timer.stop()
        return out
    stream = torch.cuda.current_stream(device)
    stream.synchronize()
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn()
        end.record(stream)
        end.synchronize()
        timer.add(start.elapsed_time(end) / 1e3)
    return out
