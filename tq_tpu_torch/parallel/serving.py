"""Continuous-batching inference runner over a device mesh.

Port of ``tq_tpu.parallel.serving``: a request queue that packs incoming
examples into fixed-size batches (one shape for the forward), pads the
tail, shards each batch over the mesh's 'data' dimension and returns
per-request results.

Every rank runs the same runner on the same requests (SPMD).  Each runs
its rows of a batch (rows ``i * b/n .. (i+1) * b/n`` on data index ``i``)
through ``forward`` on its device as the batch fills; :meth:`harvest`
gathers the rows over 'data', so every rank holds every result in request
order.  ``forward`` may return a tensor or a tuple of tensors, each with
the batch on its leading axis; a result is then the tuple of one row of
each.

``counts`` holds the requests launched and their summed queue wait, from
``submit`` to the launch of their batch, in nanoseconds.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from tq_tpu_torch.parallel._compat import (all_gather, axis_index,
                                           axis_size, device)
from tq_tpu_torch.utils.trace import span

__all__ = ["BatchRunner"]


@dataclasses.dataclass
class _Pending:
    request_id: int
    example: np.ndarray
    submitted_ns: int


class BatchRunner:
    """Packs requests into fixed-size data-sharded batches and runs them.

    Args:
      forward: ``f(x_rows) -> y_rows`` (leading batch axis), called on
        this rank's rows of each batch, on the mesh's device.
      mesh: device mesh; batches are sharded over its 'data' dimension.
      batch_size: batch size of the whole mesh (a multiple of the data
        dimension's size).
      pad_value: fill for the tail batch.
    """

    def __init__(self, forward: Callable, mesh, batch_size: int,
                 pad_value: float = 0.0):
        n = axis_size(mesh, "data")
        if batch_size % n:
            raise ValueError(
                f"batch_size {batch_size} not divisible by data axis {n}"
            )
        self._forward = forward
        self._mesh = mesh
        self._device = device(mesh)
        self._batch = batch_size
        self._rows = batch_size // n
        self._first = axis_index(mesh, "data") * self._rows
        self._pad = pad_value
        self._queue: collections.deque[_Pending] = collections.deque()
        self._results: dict[int, Any] = {}
        self._next_id = 0
        self._inflight: list[tuple[list[int], Any]] = []
        self.counts = {"requests": 0, "queue_wait_ns": 0}

    def submit(self, example) -> int:
        """Enqueue one example; returns a request id."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, np.asarray(example),
                                    time.perf_counter_ns()))
        if len(self._queue) >= self._batch:
            self._launch(self._batch)
        return rid

    def _launch(self, n: int):
        with span("tq.runner.launch"):
            take = [self._queue.popleft() for _ in range(n)]
            now = time.perf_counter_ns()
            self.counts["requests"] += n
            self.counts["queue_wait_ns"] += sum(now - p.submitted_ns
                                                for p in take)
            x = np.stack([p.example for p in take])
            if n < self._batch:  # pad the tail to the batch size
                pad_shape = (self._batch - n,) + x.shape[1:]
                x = np.concatenate([x, np.full(pad_shape, self._pad,
                                               x.dtype)])
            rows = torch.as_tensor(x[self._first:self._first + self._rows],
                                   device=self._device)
            y = self._forward(rows)  # asynchronous on a card; gathered later
            self._inflight.append(([p.request_id for p in take], y))

    def flush(self):
        """Run everything still queued (tail partial batch included)."""
        while len(self._queue) >= self._batch:
            self._launch(self._batch)
        if self._queue:
            self._launch(len(self._queue))

    def _gather(self, y) -> np.ndarray:
        return all_gather(y, self._mesh, "data").cpu().numpy()

    def harvest(self) -> dict[int, Any]:
        """Gather the in-flight batches over 'data'; return {request_id:
        result row}."""
        out = {}
        with span("tq.runner.harvest"):
            for rids, y in self._inflight:
                if isinstance(y, (tuple, list)):
                    parts = [self._gather(t) for t in y]
                    for i, rid in enumerate(rids):
                        out[rid] = tuple(p[i] for p in parts)
                else:
                    y = self._gather(y)
                    for i, rid in enumerate(rids):
                        out[rid] = y[i]
            self._inflight.clear()
        self._results.update(out)
        return out

    def run_all(self, examples) -> list:
        """Convenience: submit everything, flush, return ordered results."""
        rids = [self.submit(e) for e in examples]
        self.flush()
        self.harvest()
        return [self._results[r] for r in rids]
