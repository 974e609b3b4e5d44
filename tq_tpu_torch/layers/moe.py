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


_KEYS = ("calls", "tokens", "max_load", "stream", "mma", "grouped")


class Counts(dict):
    """``moe_apply.counts``: by layer, a dict of host numbers (``calls``,
    ``tokens``, ``max_load``, ``stream``, ``mma``, ``grouped``).

    A grouped call counts on its device (:meth:`count`), with no host
    sync: one ``index_add_`` of its held experts' loads into a histogram
    of loads (experts by load) that the layer keeps for the process, so
    that a call captured in a CUDA graph counts again on every replay.
    Every read (``[]``, ``get``, ``values()``, ``items()``, ``keys()``,
    iteration, ``len``, ``in``) first folds the histograms in (one copy
    to the host a histogram) and zeroes them; ``clear()`` drops the host
    numbers and zeroes the histograms in place: a captured graph keeps
    their addresses."""

    def __init__(self):
        super().__init__()
        # (layer, held experts, rows, device) -> (rows + 1,) int64
        self._hists: dict = {}

    def _merge(self, layer: str, calls: int, tokens: int, max_load: int,
               stream: int, mma: int, grouped: int) -> None:
        c = dict.setdefault(self, layer, dict.fromkeys(_KEYS, 0))
        c["calls"] += calls
        c["tokens"] += tokens
        c["max_load"] = max(c["max_load"], max_load)
        c["stream"] += stream
        c["mma"] += mma
        c["grouped"] += grouped

    def add(self, layer: str, loads: Sequence[int]) -> None:
        """Count one per-expert call of ``layer`` whose held experts had
        ``loads``."""
        self._merge(layer, 1, sum(loads), max(loads, default=0),
                    sum(1 for n in loads if 0 < n <= STREAM_MAX_M),
                    sum(1 for n in loads if n > STREAM_MAX_M), 0)

    def count(self, layer: str, ends: torch.Tensor,
              held: Sequence[int] | None, rows: int) -> None:
        """Count a grouped call of ``layer`` on ``rows`` rows on the device
        from its ``ends`` (every expert's end row: the loads' inclusive
        prefix sums; a load is at most ``rows``); ``held``: the experts
        counted (all when None)."""
        held = None if held is None else tuple(held)
        weights = _held_weights(held, ends.shape[0], ends.device)
        key = (layer, len(ends) if held is None else len(set(held)), rows,
               ends.device)
        hist = self._hists.get(key)
        if hist is None:
            hist = self._hists[key] = torch.zeros(
                rows + 1, dtype=torch.int64, device=ends.device)
        hist.index_add_(0, torch.diff(ends, prepend=_zero(ends.device)),
                        weights)

    # Inference mode: a histogram made in a decode step is an inference
    # tensor, which only inference mode may change in place.
    @torch.inference_mode()
    def fold(self) -> None:
        """Fold the histograms into the host numbers, zeroing them."""
        for (layer, n, rows, device), hist in self._hists.items():
            load = _expert_ids(rows + 1, device)
            sums = torch.stack((
                hist.sum(), (hist * load).sum(),
                torch.where(hist > 0, load, 0).max(),
                hist[1:STREAM_MAX_M + 1].sum(),
                hist[STREAM_MAX_M + 1:].sum())).tolist()
            hist.zero_()
            calls = sums[0] // n
            if calls:
                self._merge(layer, calls, *sums[1:], calls)

    @torch.inference_mode()
    def clear(self) -> None:
        for hist in self._hists.values():
            hist.zero_()
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


# The tensors below are kept for the process: a captured step reads them.


@functools.cache
def _expert_ids(n_experts: int, device) -> torch.Tensor:
    return torch.arange(n_experts, device=device)


@functools.cache
def _zero(device) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int64, device=device)


@functools.cache
def _held_weights(held: tuple | None, n_experts: int,
                  device) -> torch.Tensor:
    """(E,) int64: 1 for each expert ``held`` names (every one when None),
    0 elsewhere: what an expert adds to its load's count."""
    w = torch.zeros(n_experts, dtype=torch.int64)
    w[list(range(n_experts) if held is None else held)] = 1
    return w.to(device)


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
            moe_apply.counts.count(layer, ends, held, x.shape[0])
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
