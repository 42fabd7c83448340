"""Serving engines: shape-bucketed batched linear algebra on one device.

Counterpart of ``cuda_matrix_inversion_tpu/engine.py``.  Requests of any
batch size and matrix size are padded to the nearest registered
(batch-bucket, dim-bucket) with identity blocks (exact un-padding) and
dispatched to the callable bound for that bucket, so the kernels see a
small fixed set of shapes:

* :class:`InversionEngine` — ``inverse`` through a registry lane, and
  ``inverse_warm``, the warm-start refinement of a previous inverse (K8);
* :class:`GPEngine` — ``mean_variance`` through a ``models.gp`` method,
  ``mean_variance_warm`` (K11), and the hyper-parameter ``fit`` (K10 by
  default in fp32).

PyTorch runs eagerly, so there is nothing to compile ahead of a request:
``_lower`` binds the bucket's callable and ``warmup`` runs it once on
identity / zero inputs, which builds the kernel library and initialises the
device libraries before the first request.  Every engine takes ``device``
(``None`` is the card, and raises without one; CPU callers pass ``"cpu"``).
Safe for concurrent callers: the bucket caches sit behind a lock, and each
request works on its own tensors.
"""

from __future__ import annotations

import functools
import threading
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.models.gp import gp_mean_variance
from cuda_matrix_inversion_tpu_torch.models.gp_fit import (
    GPFitResult,
    fit_gp_scales,
)
from cuda_matrix_inversion_tpu_torch.ops import linalg
from cuda_matrix_inversion_tpu_torch.ops.cuda_gp import (
    gp_mean_variance_fused_warm,
)
from cuda_matrix_inversion_tpu_torch.ops.host_api import (
    SingularBatchError,
    resolve_device,
)
from cuda_matrix_inversion_tpu_torch.ops.newton_schulz import (
    inverse_newton_schulz_warm,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

# The JAX package's buckets (copies; a CPU test pins them).
DEFAULT_DIM_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
DEFAULT_BATCH_BUCKETS = (8, 32, 128, 512, 2048)
# Warm requests bucket against these, as in the JAX package: the warm
# kernels K8 and K11 serve n <= 224 (cuda_build.WARM_MAX_N; one thread-block
# cluster a matrix past 128).
WARM_DIM_BUCKETS = (8, 16, 32, 64, 128, 160, 192, 224)


def _round_up(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")


class _BucketedEngine:
    """Shared machinery: bucket rounding, the (batch, dim) → bound callable
    cache, warmup, and identity/zero padding helpers.  Subclasses implement
    ``_lower(batch_b, dim_b) -> callable`` and ``_warm_inputs``."""

    def __init__(self, dim_buckets=DEFAULT_DIM_BUCKETS,
                 batch_buckets=DEFAULT_BATCH_BUCKETS, dtype="float32",
                 device=None):
        self.dim_buckets = dim_buckets
        self.batch_buckets = batch_buckets
        self.dtype = dtype
        self.device = resolve_device(device)
        self._compiled: Dict[Tuple[int, int], object] = {}
        self._lock = threading.Lock()

    def _get_or_compile(self, cache: Dict, batch_b: int, dim_b: int, lower):
        """Check-bind-store against ``cache`` (shared by the cold and warm
        caches; binding runs outside the lock)."""
        key = (batch_b, dim_b)
        with self._lock:
            exe = cache.get(key)
        if exe is not None:
            return exe
        exe = lower(batch_b, dim_b)
        with self._lock:
            cache[key] = exe
        return exe

    def _get_executable(self, batch_b: int, dim_b: int):
        return self._get_or_compile(self._compiled, batch_b, dim_b,
                                    self._lower)

    def _buckets_for(self, batch: int, n: int) -> Tuple[int, int]:
        return (_round_up(batch, self.batch_buckets),
                _round_up(n, self.dim_buckets))

    def _warm_buckets_for(self, batch: int, n: int,
                          served_past_ceiling: bool = False
                          ) -> Tuple[int, int]:
        """Bucketing for warm-refinement requests: the JAX package's finer
        dim buckets up to 224, where the warm kernels serve them, the
        regular buckets past it.  Past 224, unless ``served_past_ceiling``
        (the split3 warm route refines through batched products at any n),
        the request runs a cold solve and the previous inverse is
        discarded — warn."""
        if n <= WARM_DIM_BUCKETS[-1]:
            return (_round_up(batch, self.batch_buckets),
                    _round_up(n, WARM_DIM_BUCKETS))
        if not served_past_ceiling:
            warnings.warn(
                f"warm refinement serves n <= {WARM_DIM_BUCKETS[-1]}; n={n} "
                "runs a cold adaptive solve (prev inverse discarded)",
                stacklevel=3)
        return self._buckets_for(batch, n)

    def warmup(self, shapes: Sequence[Tuple[int, int]]) -> None:
        """Bind and run once, on identity / zero inputs, the bucket of each
        (batch, n) shape before serving."""
        for batch, n in shapes:
            batch_b, dim_b = self._buckets_for(batch, n)
            fn = self._get_executable(batch_b, dim_b)
            fn(*self._warm_inputs(batch_b, dim_b))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def compiled_shapes(self):
        with self._lock:
            return sorted(self._compiled)

    # -- padding and transfer helpers ---------------------------------------
    def _pad_square(self, m: np.ndarray, batch_b: int,
                    dim_b: int) -> np.ndarray:
        """(batch, n, n) → (batch_b, dim_b, dim_b); identity blocks keep
        every padded matrix invertible and un-padding exact."""
        batch, n = m.shape[0], m.shape[-1]
        dt = np.dtype(self.dtype)
        out = np.zeros((batch_b, dim_b, dim_b), dt)
        out[:batch, :n, :n] = m
        if dim_b > n:
            out[:, n:, n:] = np.eye(dim_b - n, dtype=dt)
        if batch_b > batch:
            out[batch:] = np.eye(dim_b, dtype=dt)
        return out

    def _pad_vec(self, v: np.ndarray, batch_b: int, dim_b: int) -> np.ndarray:
        batch, n = v.shape[0], v.shape[1]
        return np.pad(v.reshape(batch, n, 1),
                      ((0, batch_b - batch), (0, dim_b - n), (0, 0)))

    def _to_device(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for x in arrays]

    def _eye(self, batch_b: int, dim_b: int) -> torch.Tensor:
        dt = getattr(torch, np.dtype(self.dtype).name)
        return torch.eye(dim_b, dtype=dt, device=self.device).repeat(
            batch_b, 1, 1)

    def _zeros(self, *shape) -> torch.Tensor:
        dt = getattr(torch, np.dtype(self.dtype).name)
        return torch.zeros(shape, dtype=dt, device=self.device)


class InversionEngine(_BucketedEngine):
    """Bucketed batched-inversion service.

    Example::

        eng = InversionEngine(algorithm="newton_schulz_spd10_pallas")
        eng.warmup([(100, 128)])          # build and run once ahead of serving
        out = eng.inverse(batch)           # (b, n, n) ndarray in/out
    """

    def __init__(self, algorithm: str = "newton_schulz",
                 warm_precision: str | None = None, **kw):
        super().__init__(**kw)
        self.algorithm = algorithm
        # the bf16 warm update stalls at 2⁻⁹·κ·‖R‖ (κ ≲ 30); engines
        # serving the κ ≲ 500 general class (the pan500 lane) refine
        # through the 3-pass split instead
        if warm_precision is None:
            warm_precision = ("split3" if "pan500" in algorithm else "bf16")
        if warm_precision not in ("bf16", "split3"):
            raise ValueError(f"warm_precision must be 'bf16' or 'split3', "
                             f"got {warm_precision!r}")
        self.warm_precision = warm_precision
        self._compiled_warm: Dict[Tuple[int, int], object] = {}
        self._compiled_warm_check: Dict[Tuple[int, int], object] = {}

    def _lower(self, batch_b: int, dim_b: int):
        return get_inverse_algorithm(self.algorithm)

    def _warm_inputs(self, batch_b: int, dim_b: int):
        return (self._eye(batch_b, dim_b),)

    def warmup_warm(self, shapes) -> None:
        """Bind and run once the warm-start refinement for (batch, n)
        shapes."""
        for batch, n in shapes:
            batch_b, dim_b = self._warm_buckets_for(
                batch, n,
                served_past_ceiling=self.warm_precision == "split3")
            fn = self._get_or_compile(self._compiled_warm, batch_b, dim_b,
                                      self._lower_warm)
            eye = self._eye(batch_b, dim_b)
            fn(eye, eye)

    def _lower_warm(self, batch_b: int, dim_b: int):
        return functools.partial(inverse_newton_schulz_warm,
                                 precision=self.warm_precision)

    def _lower_warm_check(self, batch_b: int, dim_b: int):
        warm = self._lower_warm(batch_b, dim_b)

        def fn(a, x0):
            x = warm(a, x0)
            eye = torch.eye(dim_b, dtype=x.dtype, device=x.device)
            res = (linalg.matmul(a, x) - eye).abs().sum(dim=-1).amax()
            return x, res

        return fn

    def inverse_warm(self, a: np.ndarray, prev_inv: np.ndarray,
                     check: bool = False, tol: float = 1e-3) -> np.ndarray:
        """Refine ``prev_inv`` (the inverse of a nearby batch) for ``a``.

        Cheaper than a cold ``inverse`` while the relative change δ
        satisfies δ·κ(A) ≲ 0.3 — past that, call ``inverse`` again.  Shapes
        must match.  Dims bucket against ``WARM_DIM_BUCKETS``, which the
        warm kernel K8 serves up to n = 224; above it a bf16 engine warns
        and runs cold, a split3 engine refines through batched products.

        ``check=True`` also computes ‖AX − I‖∞ on the device (one extra
        fp32 product) and raises ``LinAlgError`` when it exceeds ``tol``:
        the refinement diverges to finite garbage when the batch jumped too
        far from the one ``prev_inv`` belonged to, so a finiteness check
        cannot catch it.
        """
        a = np.ascontiguousarray(np.asarray(a, dtype=self.dtype))
        prev = np.ascontiguousarray(np.asarray(prev_inv, dtype=self.dtype))
        if a.ndim == 2:
            a, prev = a[None], prev[None] if prev.ndim == 2 else prev
        if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"expected (batch, n, n), got {a.shape}")
        if a.shape != prev.shape:
            raise ValueError(f"mismatched shapes {a.shape} vs {prev.shape}")
        batch, n = a.shape[0], a.shape[-1]
        if batch == 0:
            return a.copy()
        batch_b, dim_b = self._warm_buckets_for(
            batch, n, served_past_ceiling=self.warm_precision == "split3")
        # separate caches: _compiled holds the cold buckets and feeds
        # compiled_shapes
        if check:
            fn = self._get_or_compile(self._compiled_warm_check, batch_b,
                                      dim_b, self._lower_warm_check)
        else:
            fn = self._get_or_compile(self._compiled_warm, batch_b, dim_b,
                                      self._lower_warm)
        pa, px = self._to_device(self._pad_square(a, batch_b, dim_b),
                                 self._pad_square(prev, batch_b, dim_b))
        result = fn(pa, px)  # identity pads: X = A⁻¹ there
        if check:
            out, res = result
            res = float(res)
            if not res < tol:  # NaN also fails this comparison
                raise np.linalg.LinAlgError(
                    f"warm-start refinement diverged: ||AX - I||_inf = "
                    f"{res:.3e} > {tol:.1e} — the batch moved too far from "
                    "prev_inv's; recompute with inverse()")
        else:
            out = result
        return np.ascontiguousarray(out.cpu().numpy()[:batch, :n, :n])

    def inverse(self, a: np.ndarray, check: bool = False) -> np.ndarray:
        """Invert a (batch, n, n) batch; any size within the buckets."""
        a = np.ascontiguousarray(np.asarray(a, dtype=self.dtype))
        if a.ndim == 2:
            a = a[None]
        if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"expected (batch, n, n), got {a.shape}")
        batch, n = a.shape[0], a.shape[-1]
        if batch == 0:
            return a.copy()
        batch_b, dim_b = self._buckets_for(batch, n)
        (padded,) = self._to_device(self._pad_square(a, batch_b, dim_b))
        fn = self._get_executable(batch_b, dim_b)
        result = fn(padded).cpu().numpy()[:batch, :n, :n]
        if check:
            finite = np.isfinite(result).all(axis=(1, 2))
            if not finite.all():
                raise SingularBatchError(np.nonzero(~finite)[0])
        return np.ascontiguousarray(result)


class GPEngine(_BucketedEngine):
    """Bucketed GP mean/variance service (same bucketing strategy).

    For slowly-varying per-timestep systems, ``mean_variance_warm`` refines
    the previous timestep's K⁻¹ instead of solving cold — the GP analog of
    ``InversionEngine.inverse_warm``.
    """

    def __init__(self, method: str = "solve", fit_method: str = "auto",
                 **kw):
        super().__init__(**kw)
        self.method = method
        # the fused K10 fit loop where it applies (fp32), torch.linalg
        # otherwise
        self.fit_method = (("pallas" if np.dtype(self.dtype) == np.float32
                            else "xla") if fit_method == "auto"
                           else fit_method)
        self._compiled_gp_warm: Dict[Tuple[int, int], object] = {}
        self._compiled_fit: Dict[Tuple[int, int, int, float], object] = {}

    def _lower(self, batch_b: int, dim_b: int):
        return functools.partial(gp_mean_variance, method=self.method)

    def _warm_inputs(self, batch_b: int, dim_b: int):
        vec = self._zeros(batch_b, dim_b, 1)
        return (vec, self._eye(batch_b, dim_b), vec, vec,
                self._zeros(batch_b, 1, 1))

    def _pad_gp(self, a, b, c, d, e, batch_b: int, dim_b: int):
        batch = b.shape[0]
        return self._to_device(
            self._pad_vec(a, batch_b, dim_b),
            self._pad_square(b, batch_b, dim_b),
            self._pad_vec(c, batch_b, dim_b),
            self._pad_vec(d, batch_b, dim_b),
            np.pad(e.reshape(batch, 1, 1),
                   ((0, batch_b - batch), (0, 0), (0, 0))))

    def mean_variance(self, a, b, c, d, e):
        """Batched GP mean/variance; returns two (batch, 1, 1) ndarrays."""
        dt = np.dtype(self.dtype)
        a, b, c, d, e = (np.ascontiguousarray(np.asarray(x, dtype=dt))
                         for x in (a, b, c, d, e))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0, 1, 1), dt)
            return z, z.copy()
        batch_b, dim_b = self._buckets_for(batch, n)
        fn = self._get_executable(batch_b, dim_b)
        mean, var = fn(*self._pad_gp(a, b, c, d, e, batch_b, dim_b))
        return mean.cpu().numpy()[:batch], var.cpu().numpy()[:batch]

    # -- hyper-parameter fitting --------------------------------------------
    def fit(self, b, c, d, steps: int = 150, lr: float = 0.05) -> GPFitResult:
        """Batch-bucketed hyper-parameter fit (``models/gp_fit.py``):
        learn per-system (log amp, log noise).

        Only the batch axis is bucketed: padded systems carry loss weight
        0, so their θ never moves and never enters the loss or the
        convergence trace.  The dim axis is served at its exact size:
        padding it before the scaling is not exact for the fit (an identity
        block appended to B is multiplied by e^{2θ_amp}, which makes the
        pad block's log-determinant depend on θ).  Returns a
        ``GPFitResult`` of host arrays sliced to the real batch.
        """
        dt = np.dtype(self.dtype)
        b, c, d = (np.ascontiguousarray(np.asarray(x, dtype=dt))
                   for x in (b, c, d))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0,), dt)
            return GPFitResult(z, z.copy(), z.copy(),
                               np.zeros((steps,), dt))
        batch_b = _round_up(batch, self.batch_buckets)
        bp = np.zeros((batch_b, n, n), dt)
        bp[:batch] = b
        bp[batch:] = np.eye(n, dtype=dt)
        cp = np.zeros((batch_b, n, 1), dt)
        cp[:batch] = c.reshape(batch, n, 1)
        dp = np.zeros((batch_b, n, 1), dt)
        dp[:batch] = d.reshape(batch, n, 1)
        w = np.zeros((batch_b,), dt)
        w[:batch] = 1.0

        key = (batch_b, n, steps, lr)
        with self._lock:
            fn = self._compiled_fit.get(key)
        if fn is None:
            fn = self._lower_fit(batch_b, n, steps, lr)
            with self._lock:
                self._compiled_fit[key] = fn
        res = fn(*self._to_device(bp, cp, dp, w))
        return GPFitResult(res.log_amp.cpu().numpy()[:batch],
                           res.log_noise.cpu().numpy()[:batch],
                           res.lml.cpu().numpy()[:batch],
                           res.lml_path.cpu().numpy())

    def _lower_fit(self, batch_b: int, dim_b: int, steps: int, lr: float):
        def fn(b, c, d, w):
            return fit_gp_scales(b, c, d, steps=steps, lr=lr,
                                 method=self.fit_method, weights=w)

        return fn

    # -- warm serving --------------------------------------------------------
    def _lower_gp_warm(self, batch_b: int, dim_b: int):
        return gp_mean_variance_fused_warm

    def warmup_warm(self, shapes) -> None:
        """Bind and run once the warm GP path for (batch, n) shapes."""
        for batch, n in shapes:
            batch_b, dim_b = self._warm_buckets_for(batch, n)
            fn = self._get_or_compile(self._compiled_gp_warm, batch_b, dim_b,
                                      self._lower_gp_warm)
            inputs = self._warm_inputs(batch_b, dim_b)
            fn(*inputs, inputs[1])

    def mean_variance_warm(self, a, b, c, d, e, prev_kinv):
        """Warm GP mean/variance: refine ``prev_kinv`` — the ``kinv``
        returned by the previous call for a nearby batch — instead of a
        cold solve.  Returns ``(mean, var, kinv)``; chain ``kinv`` into the
        next timestep.  Valid while the relative drift δ of
        K = B + diag(c) satisfies δ·κ(K) ≲ 0.3 (the domain of
        ``InversionEngine.inverse_warm``); start the chain with a cold
        inverse of K.
        """
        dt = np.dtype(self.dtype)
        a, b, c, d, e, prev_kinv = (
            np.ascontiguousarray(np.asarray(x, dtype=dt))
            for x in (a, b, c, d, e, prev_kinv))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0, 1, 1), dt)
            return z, z.copy(), np.zeros((0, n, n), dt)
        if prev_kinv.shape != b.shape:
            raise ValueError(
                f"prev_kinv shape {prev_kinv.shape} must match b {b.shape}")
        batch_b, dim_b = self._warm_buckets_for(batch, n)
        fn = self._get_or_compile(self._compiled_gp_warm, batch_b, dim_b,
                                  self._lower_gp_warm)
        inputs = self._pad_gp(a, b, c, d, e, batch_b, dim_b)
        # identity pad: X = K⁻¹ there
        (xp,) = self._to_device(self._pad_square(prev_kinv, batch_b, dim_b))
        mean, var, kinv = fn(*inputs, xp)
        return (mean.cpu().numpy()[:batch], var.cpu().numpy()[:batch],
                np.ascontiguousarray(kinv.cpu().numpy()[:batch, :n, :n]))
