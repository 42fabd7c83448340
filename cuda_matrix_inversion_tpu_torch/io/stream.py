"""Streaming batch loader: overlap host ingest with device compute.

Counterpart of ``cuda_matrix_inversion_tpu/io/stream.py`` and of the
reference's pinned-memory transfer machinery (``src/bench.cu:112-156``,
the pitched batched uploads of ``inverse_cholesky_gpu.cu:204-215``).  A
producer thread parses ``.mats`` shards and re-chunks them to
``batch_size``; on a CUDA device it copies each batch into a pinned host
buffer and issues a non-blocking copy on a side stream, recording an
event.  The consumer's stream waits on that event, so copy N+1 overlaps
compute N, and the consumer only ever blocks on data already in flight.

Usage::

    for batch in DeviceBatchStream(paths, batch_size=256):
        out = fn(batch)   # batch already lies on the device
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device


class DeviceBatchStream:
    """Iterate device-resident batches with background prefetch.

    ``source``: either an iterable of host ndarrays, or a sequence of
    ``.mats`` file paths (each file yields its matrices).  ``batch_size``
    re-chunks the stream; ``prefetch`` bounds the number of batches in
    flight (copied or being copied, not yet taken by the consumer: 2 is
    the pinned ping-pong).  ``device=None`` is the card; on
    ``device="cpu"`` the batches are CPU tensors, with no pinned memory and
    no side stream.
    """

    _END = object()

    def __init__(
        self,
        source: Iterable,
        batch_size: Optional[int] = None,
        prefetch: int = 2,
        device=None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.source = source
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self.transform = transform

    # -- host-side ingest ------------------------------------------------
    def _host_arrays(self) -> Iterator[np.ndarray]:
        from cuda_matrix_inversion_tpu_torch.io.mats import read_mats

        for item in self.source:
            if isinstance(item, (str, bytes)):
                arr = read_mats(item)
            else:
                arr = np.asarray(item)
            if arr.ndim == 2:
                arr = arr[None]
            yield arr

    def _host_batches(self) -> Iterator[np.ndarray]:
        if self.batch_size is None:
            yield from self._host_arrays()
            return
        buf = []
        have = 0
        for arr in self._host_arrays():
            buf.append(arr)
            have += arr.shape[0]
            while have >= self.batch_size:
                cat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
                yield cat[: self.batch_size]
                rest = cat[self.batch_size:]
                buf = [rest] if rest.shape[0] else []
                have = rest.shape[0]
        if have:
            yield np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]

    # -- device-side prefetch ---------------------------------------------
    def _to_device(self, host: np.ndarray, side):
        """(tensor, event): on a CUDA device the copy is issued on the side
        stream from a pinned buffer and ``event`` marks its end; on the
        CPU the tensor is the batch and ``event`` is None."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        if side is None:
            return src, None
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        with torch.cuda.stream(side):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors: list = []  # the producer's exception, raised here
        side = (torch.cuda.Stream(device=self.device)
                if self.device.type == "cuda" else None)

        def put(item) -> bool:
            # bounded put that notices consumer abandonment: a plain
            # q.put would block forever (leaking the thread and the
            # prefetched batches) if the caller breaks out of the loop
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for host in self._host_batches():
                    if stop.is_set():
                        return
                    if self.transform is not None:
                        host = self.transform(host)
                    if not put(self._to_device(host, side)):
                        return
            except BaseException as exc:  # surfaced on the consumer side
                errors.append(exc)
            finally:
                put(self._END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if errors:
                        raise errors[0]
                    return
                batch, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    # allocated on the side stream, used on this one
                    batch.record_stream(consumer)
                yield batch
        finally:
            stop.set()  # GeneratorExit / break: release the producer


def stream_inverse(
    paths: Sequence[str],
    algorithm: str = "newton_schulz",
    batch_size: int = 256,
    device=None,
):
    """End-to-end streamed inversion: parse → prefetch → invert, with
    ingest overlapped against device compute.  Yields host ndarrays."""
    from cuda_matrix_inversion_tpu_torch.ops.registry import (
        get_inverse_algorithm,
    )

    fn = get_inverse_algorithm(algorithm)
    for batch in DeviceBatchStream(paths, batch_size=batch_size,
                                   device=device):
        yield fn(batch).cpu().numpy()
