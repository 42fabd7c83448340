"""Mixed-dimension size-bucketed batching.

Counterpart of ``cuda_matrix_inversion_tpu/parallel/bucketing.py``
(``BASELINE.json`` config 4: "mixed-dimension size-bucketed queues
(8/32/128/512) in one fused dispatch").  Each matrix goes to the smallest
bucket ≥ its dimension, padded with an identity block (the inverse of
``blockdiag(A, I)`` is ``blockdiag(A⁻¹, I)``, so un-padding is an exact
slice); the GP problems pad ``a``, ``c``, ``d`` with zeros, so the padded
rows contribute nothing.  Every bucket's stack is copied to the device
first, then the buckets run as one stacked call each, back to back on the
device's stream with no host synchronisation between them, and the results
come back together.  The JAX function's ``mesh`` argument (one bucket
sharded over several chips) waits for the port's sharding slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.models.gp import gp_mean_variance
from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

DEFAULT_BUCKETS = (8, 32, 128, 512)


def assign_buckets(sizes: Sequence[int],
                   buckets: Sequence[int] = DEFAULT_BUCKETS) -> List[int]:
    """Smallest bucket ≥ n for each size; raises past the largest."""
    out = []
    for n in sizes:
        for b in buckets:
            if n <= b:
                out.append(b)
                break
        else:
            raise ValueError(
                f"matrix dim {n} exceeds largest bucket {buckets[-1]}")
    return out


def pack_buckets(matrices: Sequence[np.ndarray],
                 buckets: Sequence[int] = DEFAULT_BUCKETS
                 ) -> Tuple[Dict[int, np.ndarray], List[Tuple[int, int, int]]]:
    """Pack ragged square matrices into per-bucket stacks:
    ``(stacks, index)`` with ``stacks[b]`` of shape ``(k_b, b, b)`` and
    ``index[i] = (bucket, position, original_n)`` for matrix ``i``."""
    assignment = assign_buckets([m.shape[-1] for m in matrices], buckets)
    stacks: Dict[int, list] = {}
    index: List[Tuple[int, int, int]] = []
    for m, b in zip(matrices, assignment):
        n = m.shape[-1]
        if m.shape != (n, n):
            raise ValueError(f"square matrices required; got {m.shape}")
        padded = np.eye(b, dtype=m.dtype)
        padded[:n, :n] = m
        pos = len(stacks.setdefault(b, []))
        stacks[b].append(padded)
        index.append((b, pos, n))
    return {b: np.stack(v) for b, v in stacks.items()}, index


def bucketed_inverse(matrices: Sequence[np.ndarray],
                     algorithm: str = "cholesky_pallas",
                     buckets: Sequence[int] = DEFAULT_BUCKETS,
                     device=None) -> List[np.ndarray]:
    """Invert a ragged list of square NumPy matrices on ``device``, one
    call of the registry lane ``algorithm`` per occupied bucket; returns
    the inverses in input order."""
    stacks, index = pack_buckets(matrices, buckets)
    dev = resolve_device(device)
    fn = get_inverse_algorithm(algorithm)
    keys = sorted(stacks)
    on_dev = [torch.from_numpy(stacks[k]).to(dev) for k in keys]
    outs = [fn(s) for s in on_dev]
    by_bucket = {k: o.cpu().numpy() for k, o in zip(keys, outs)}
    return [by_bucket[b][pos, :n, :n] for b, pos, n in index]


def bucketed_gp_mean_variance(
        problems: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]],
        method: str = "solve", buckets: Sequence[int] = DEFAULT_BUCKETS,
        device=None) -> List[Tuple[float, float]]:
    """Ragged GP mean/variance: each problem is ``(a, b, c, d, e)`` with
    its own n (``a``, ``c``, ``d`` of n entries, ``b`` n×n, ``e`` one);
    one ``models.gp.gp_mean_variance`` call per occupied bucket.  Returns
    ``(mean, var)`` floats in input order."""
    assignment = assign_buckets([p[1].shape[-1] for p in problems], buckets)
    grouped: Dict[int, list] = {}
    index: List[Tuple[int, int]] = []
    for prob, bkt in zip(problems, assignment):
        a, b, c, d, e = (np.asarray(x) for x in prob)
        n = b.shape[-1]
        bp = np.eye(bkt, dtype=b.dtype)
        bp[:n, :n] = b

        def pad_vec(v):
            return np.pad(v.reshape(n, 1), ((0, bkt - n), (0, 0)))

        entry = (pad_vec(a), bp, pad_vec(c), pad_vec(d), e.reshape(1, 1))
        pos = len(grouped.setdefault(bkt, []))
        grouped[bkt].append(entry)
        index.append((bkt, pos))
    dev = resolve_device(device)
    keys = sorted(grouped)
    on_dev = [[torch.from_numpy(np.stack([ent[j] for ent in grouped[k]])
                                ).to(dev) for j in range(5)] for k in keys]
    outs = [gp_mean_variance(*args, method=method) for args in on_dev]
    by_bucket = {k: (m.cpu().numpy(), v.cpu().numpy())
                 for k, (m, v) in zip(keys, outs)}
    return [(float(by_bucket[bkt][0][pos, 0, 0]),
             float(by_bucket[bkt][1][pos, 0, 0])) for bkt, pos in index]
