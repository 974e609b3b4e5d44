"""Routed experts: DeepSeek-V3's expert layer over TR dense products.

The router scores every row against every expert, ``s = sigmoid(x W_gᵀ)``
in float32, selects the ``top_k`` experts of highest ``s + bias`` (the
correction bias of ``noaux_tc``), and weighs each selected expert by its
``s`` alone, divided by the selection's sum plus 1e-20 and multiplied by
the routed scaling factor.

The (row, slot) pairs are then grouped by expert: one stable sort by
expert.  Two paths compute the experts on them:

* **grouped** (a decode-sized call on the card, :func:`takes_grouped`,
  with the layer's :class:`Grouped` tables): the sort's sorted experts
  give each expert's end row on the device (``searchsorted``;
  ``bincount`` on a CUDA tensor reads the largest index on the host),
  and the SwiGLU is two
  ``term_matmul_grouped`` launches over every expert: gate and up on the
  rows gathered in the sorted order, then, after ``silu(gate) * up``,
  down, each pair's output times its weight written back in the rows'
  order; a sum over the ``top_k`` slots gives each row.  The host never reads
  the counts: no host sync.
* **per expert** (every other call: prefill's large slices, calibration,
  quantized input, CPU tensors): one gather of the rows in the sorted
  order and one device-to-host copy of the counts, which cut them into
  slices (the layer's only host sync); each held expert with rows runs
  its products on its own contiguous slice through the caller's
  ``expert`` (the model's SwiGLU of three TR dense products), an expert
  with no rows launching nothing, and one ``index_add_`` sums the
  weighted outputs into their rows.

The layer is told which experts it holds (``held``): rows routed to an
expert held elsewhere add nothing here, the share of the layer's result
that an expert-parallel rank computes.  On one card every expert is held
unless the model is a rank's share (``models/kimi_linear.py``'s 64 of
256); the grouped path's table then covers every id of the router, with
packs for the held experts alone.

``moe_apply.counts`` (always on, :class:`Counts`) holds, by layer, the
calls, the (row, slot) pairs routed to held experts, the largest load of
one expert in one call, the experts with rows by the ``term_matmul``
route the per-expert path takes for them (``stream`` for slices of at
most ``STREAM_MAX_M`` rows, ``mma`` above; counted on the grouped path
too, where one launch takes them all), and the calls that took the
grouped path (``grouped``).
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from tq_tpu_torch.kernels.term_matmul import STREAM_MAX_M
from tq_tpu_torch.kernels.term_matmul_grouped import (GroupedWeights,
                                                      term_matmul_grouped)
from tq_tpu_torch.utils.trace import span

__all__ = ["route", "moe_apply", "takes_grouped", "Grouped", "Counts",
           "GROUPED_MAX_PAIRS"]

# The most (row, slot) pairs a call may route for the grouped path: the
# largest of chip_smoke.py's sweep at which a layer call ran faster on it
# than on the per-expert path (an H100: 17.9 against 19.5 ms at 24,576
# pairs, 36.3 against 32.4 at 49,152, a prefill chunk; PERF.md).
GROUPED_MAX_PAIRS = 24576
# Grouped calls whose counts may wait in pinned memory before a new call
# folds the completed ones in (one event query a call otherwise).
_PENDING = 64


class Grouped(NamedTuple):
    """An expert layer's SwiGLU experts as the grouped path reads them:
    the gate and up products' tables in one (two products) and the
    down product's."""

    gate_up: GroupedWeights
    down: GroupedWeights


def route(x: torch.Tensor, router: dict, top_k: int, scale: float):
    """The selected experts (N, top_k) int64 and their weights (N, top_k)
    float32 of the rows ``x`` (N, d); ``router``: ``{'w': (E, d),
    'bias': (E,)}``."""
    scores = torch.sigmoid(torch.matmul(x.to(torch.float32),
                                        router["w"].to(torch.float32).T))
    idx = torch.topk(scores + router["bias"], top_k, dim=-1).indices
    w = scores.gather(1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale


class Counts(dict):
    """``moe_apply.counts``: by layer, a dict of host numbers (``calls``,
    ``tokens``, ``max_load``, ``stream``, ``mma``, ``grouped``).

    A grouped call's counts reach it without a host sync (:meth:`defer`):
    a non-blocking copy of the experts' end rows into pinned host memory
    and one CUDA event,
    folded in once the event has completed.  A new call folds the
    completed ones once more than ``_PENDING`` wait; every read (``[]``, ``get``, ``values()``,
    ``items()``, ``keys()``, iteration, ``len``, ``in``) first waits for
    and folds what is still pending.  ``clear()`` drops it."""

    def __init__(self):
        super().__init__()
        self._pending = collections.deque()  # (layer, buffer, event, held)
        self._free = []  # (pinned buffer, event) pairs to reuse

    def add(self, layer: str, loads: Sequence[int],
            grouped: bool = False) -> None:
        """Count one call of ``layer`` whose held experts had ``loads``."""
        c = dict.setdefault(self, layer, dict.fromkeys(
            ("calls", "tokens", "max_load", "stream", "mma", "grouped"), 0))
        c["calls"] += 1
        c["grouped"] += int(grouped)
        c["tokens"] += sum(loads)
        c["max_load"] = max(c["max_load"], max(loads, default=0))
        c["stream"] += sum(1 for n in loads if 0 < n <= STREAM_MAX_M)
        c["mma"] += sum(1 for n in loads if n > STREAM_MAX_M)

    def defer(self, layer: str, ends: torch.Tensor,
              held: Sequence[int] | None) -> None:
        """Count a grouped call from its device ``ends`` (every expert's
        end row: the loads' inclusive prefix sums) without waiting for
        them; ``held``: the experts counted (all when None)."""
        if not ends.is_cuda:
            self._fold_one(layer, ends.tolist(), held)
            return
        i = next((i for i, (b, _) in enumerate(self._free)
                  if b.shape == ends.shape and b.dtype == ends.dtype), None)
        if i is None:
            buf = torch.empty(ends.shape, dtype=ends.dtype, pin_memory=True)
            event = torch.cuda.Event()
        else:
            buf, event = self._free.pop(i)
        buf.copy_(ends, non_blocking=True)
        event.record(torch.cuda.current_stream(ends.device))
        self._pending.append((layer, buf, event, held))
        if len(self._pending) > _PENDING:
            self.fold(wait=False)

    def fold(self, wait: bool = True) -> None:
        """Fold the pending calls in, in order: all of them (``wait``,
        waiting for their events), or those whose events have
        completed."""
        while self._pending and (wait or self._pending[0][2].query()):
            layer, buf, event, held = self._pending.popleft()
            event.synchronize()
            self._fold_one(layer, buf.tolist(), held)
            self._free.append((buf, event))

    def _fold_one(self, layer, ends, held) -> None:
        loads = [b - a for a, b in zip([0] + ends[:-1], ends)]
        self.add(layer, loads if held is None else [loads[e] for e in held],
                 grouped=True)

    def clear(self) -> None:
        self._pending.clear()
        super().clear()

    def __getitem__(self, layer):
        self.fold()
        return super().__getitem__(layer)

    def get(self, layer, default=None):
        self.fold()
        return super().get(layer, default)

    def values(self):
        self.fold()
        return super().values()

    def items(self):
        self.fold()
        return super().items()

    def keys(self):
        self.fold()
        return super().keys()

    def __iter__(self):
        self.fold()
        return super().__iter__()

    def __len__(self):
        self.fold()
        return super().__len__()

    def __contains__(self, layer):
        self.fold()
        return super().__contains__(layer)


def takes_grouped(x: torch.Tensor, top_k: int) -> bool:
    """Whether a call on the rows ``x`` takes the grouped path (given the
    layer's :class:`Grouped`): rows on the card, and at most
    :data:`GROUPED_MAX_PAIRS` (row, slot) pairs, a decode step's size
    (prefill's thousands of rows an expert take the tensor cores
    expert by expert)."""
    return x.is_cuda and x.shape[0] * top_k <= GROUPED_MAX_PAIRS


@functools.lru_cache(maxsize=64)
def _expert_ids(n_experts: int, device) -> torch.Tensor:
    return torch.arange(n_experts, device=device)


def _experts_grouped(x, order, ends, weight, grouped: Grouped, top_k,
                     held) -> torch.Tensor:
    """The grouped path's weighted expert outputs summed into their rows:
    the gate and up launch gathers each pair's row, the down launch writes
    each pair, times its weight, in the rows' order; a sum over the
    ``top_k`` slots (no atomics) gives each row."""
    gate_up = term_matmul_grouped(x.contiguous(), ends, grouped.gate_up,
                                  held, gather=order, top_k=top_k)
    out = term_matmul_grouped(F.silu(gate_up[0]) * gate_up[1], ends,
                              grouped.down, held, scatter=order,
                              scale=weight.reshape(-1))[0]
    return out.view(x.shape[0], top_k, -1).sum(1)


def moe_apply(x: torch.Tensor, router: dict,
              expert: Callable[[int, torch.Tensor], torch.Tensor],
              top_k: int, scale: float, held: Sequence[int] | None = None,
              layer: str = "moe", grouped: Grouped | None = None):
    """The routed experts' weighted sum for the rows ``x`` (N, d):
    ``(y (N, d), selected experts (N, top_k))``.

    ``expert(e, rows)``: expert ``e``'s output for its rows (n, d);
    ``held``: the experts this layer holds (every expert when None);
    ``layer``: the key of ``moe_apply.counts``; ``grouped``: the layer's
    experts as the grouped path reads them (the same products as
    ``expert``'s, raw-input 9-bit packed), taken where
    :func:`takes_grouped` says so.
    """
    n_experts = router["w"].shape[0]
    on_grouped = grouped is not None and takes_grouped(x, top_k)
    with span("tq.moe.route"):
        idx, weight = route(x, router, top_k, scale)
        flat = idx.reshape(-1)
        if on_grouped:  # bincount reads the largest index on the host
            experts, order = torch.sort(flat, stable=True)
            ends = torch.searchsorted(
                experts, _expert_ids(n_experts, x.device), right=True)
            moe_apply.counts.defer(layer, ends, held)
        else:
            order = torch.argsort(flat, stable=True)
            loads = torch.bincount(flat, minlength=n_experts).tolist()
    if on_grouped:
        with span("tq.moe.experts", device=x.is_cuda):
            return _experts_grouped(x, order, ends, weight, grouped, top_k,
                                    held), idx
    every = held is None
    held = range(n_experts) if every else held
    moe_apply.counts.add(layer, [loads[e] for e in held])
    with span("tq.moe.experts", device=x.is_cuda):
        xs = x.index_select(0, order // top_k)
        starts = [0]
        for n in loads:
            starts.append(starts[-1] + n)
        outs, kept = [], []
        for e in held:
            a, b = starts[e], starts[e + 1]
            if b > a:
                outs.append(expert(e, xs[a:b]))
                kept.append(slice(a, b))
        y = torch.zeros_like(x)
        if outs:
            pick = order if every else torch.cat([order[s] for s in kept])
            y.index_add_(0, pick // top_k,
                         torch.cat(outs) * weight.reshape(-1)[pick, None])
    return y, idx


moe_apply.counts = Counts()
