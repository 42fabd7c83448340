"""The port's streaming loader (``io/stream.py``) on the CPU against the
JAX package's: the same batch boundaries and values from the same ``.mats``
shards, a producer error raised in the consumer, ``break`` releasing the
producer, the prefetch bound, and ``stream_inverse`` against JAX's.

Inputs are drawn from ``np.random.default_rng(seed)`` here, never from the
session ``rng`` fixture.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu.io import stream as jax_stream
from cuda_matrix_inversion_tpu_torch.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu_torch.io.mats import read_mats, write_mats
from cuda_matrix_inversion_tpu_torch.io.stream import (
    DeviceBatchStream,
    stream_inverse,
)

# JAX's XLA LU and Cholesky inverses against the port's torch.linalg ones
# (the same algorithms, the LU lane with the same polish), fp32, κ ≈ 2–3:
# max-norm relative
STREAM_RTOL = 1e-5


def _shards(tmp_path, sizes, n=6, seed=51):
    rng = np.random.default_rng(seed)
    paths = []
    for i, num in enumerate(sizes):
        path = str(tmp_path / f"part{i}.mats")
        write_mats(path, make_spd_batch(num, n, rng))
        paths.append(path)
    return paths


@pytest.mark.parametrize("sizes,batch_size", [
    ((7, 7, 7, 7), 10), ((5, 13, 2), 6), ((4, 4), None), ((9,), 9),
    ((3, 3, 3), 100)])
def test_batches_match_jax_on_mats_shards(tmp_path, sizes, batch_size):
    paths = _shards(tmp_path, sizes)
    got = list(DeviceBatchStream(paths, batch_size=batch_size, device="cpu"))
    ref = [np.asarray(b) for b in jax_stream.DeviceBatchStream(
        paths, batch_size=batch_size)]
    assert [tuple(b.shape) for b in got] == [b.shape for b in ref]
    for b, r in zip(got, ref):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert b.dtype == torch.float32 and r.dtype == np.float32
        assert np.array_equal(b.numpy(), r)


def test_arrays_and_transform_like_jax():
    rng = np.random.default_rng(52)
    arrays = [rng.standard_normal((4, 3, 3)).astype(np.float32),
              rng.standard_normal((3, 3)).astype(np.float32)]
    got = list(DeviceBatchStream(arrays, device="cpu",
                                 transform=lambda x: x * 2))
    ref = [np.asarray(b) for b in jax_stream.DeviceBatchStream(
        arrays, transform=lambda x: x * 2)]
    assert [tuple(b.shape) for b in got] == [b.shape for b in ref] == [
        (4, 3, 3), (1, 3, 3)]
    for b, r in zip(got, ref):
        assert np.array_equal(b.numpy(), r)


def test_producer_error_reaches_the_consumer(tmp_path):
    """A shard that cannot be read raises in the consumer, after the
    batches before it, as in JAX's."""
    paths = _shards(tmp_path, (4,)) + [str(tmp_path / "missing.mats")]
    for stream in (DeviceBatchStream(paths, device="cpu"),
                   jax_stream.DeviceBatchStream(paths)):
        seen = []
        with pytest.raises(FileNotFoundError):
            for b in stream:
                seen.append(b.shape[0])
        assert seen == [4]


def _producer_threads(before):
    return [t for t in threading.enumerate()
            if t not in before and t.daemon]


def test_break_releases_the_producer():
    rng = np.random.default_rng(53)
    arrays = [rng.standard_normal((2, 3, 3)).astype(np.float32)
              for _ in range(50)]
    before = set(threading.enumerate())
    stream = iter(DeviceBatchStream(arrays, prefetch=1, device="cpu"))
    next(stream)
    assert _producer_threads(before), "no producer thread started"
    stream.close()  # what a `break` out of a for loop does
    for t in _producer_threads(before):
        t.join(timeout=5)
        assert not t.is_alive()


def test_prefetch_bounds_the_batches_in_flight():
    """With the consumer stalled after its first batch, the producer holds
    at most ``prefetch`` batches in the queue and one in its hand."""
    produced = []

    def source():
        for i in range(20):
            produced.append(i)
            yield np.full((1, 2, 2), i, dtype=np.float32)

    stream = iter(DeviceBatchStream(source(), prefetch=2, device="cpu"))
    first = next(stream)
    time.sleep(0.5)
    assert float(first[0, 0, 0]) == 0.0
    assert len(produced) <= 1 + 2 + 1
    rest = [float(b[0, 0, 0]) for b in stream]
    assert rest == [float(i) for i in range(1, 20)]


@pytest.mark.parametrize("algorithm", ["lu", "cholesky"])
def test_stream_inverse_matches_jax(tmp_path, algorithm):
    paths = _shards(tmp_path, (5, 5, 3), n=16, seed=54)
    got = list(stream_inverse(paths, algorithm=algorithm, batch_size=4,
                              device="cpu"))
    ref = list(jax_stream.stream_inverse(paths, algorithm=algorithm,
                                         batch_size=4))
    assert [x.shape for x in got] == [x.shape for x in ref] == [
        (4, 16, 16)] * 3 + [(1, 16, 16)]
    allx, allr = np.concatenate(got), np.concatenate(ref)
    assert allx.dtype == np.float32
    assert np.abs(allx - allr).max() / np.abs(allr).max() <= STREAM_RTOL
    a = np.concatenate([read_mats(p) for p in paths]).astype(np.float64)
    assert np.abs(a @ allx - np.eye(16)).sum(-1).max() < 1e-4
