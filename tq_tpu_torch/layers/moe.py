"""Routed experts: DeepSeek-V3's expert layer over TR dense products.

The router scores every row against every expert, ``s = sigmoid(x W_gᵀ)``
in float32, selects the ``top_k`` experts of highest ``s + bias`` (the
correction bias of ``noaux_tc``), and weighs each selected expert by its
``s`` alone, divided by the selection's sum plus 1e-20 and multiplied by
the routed scaling factor.

The (row, slot) pairs are then grouped by expert: one stable sort by
expert, one gather of the rows in that order, and one device-to-host copy
of the experts' counts, which cut the sorted rows into slices (the
layer's only host sync).  Each held expert with rows runs its products on
its own contiguous slice through the caller's ``expert`` (the model's
SwiGLU of three TR dense products); an expert with no rows launches
nothing.  One ``index_add_`` sums the weighted outputs into their rows.

The layer is told which experts it holds (``held``): rows routed to an
expert held elsewhere add nothing here, the share of the layer's result
that an expert-parallel rank computes.  On one card every expert is held.

``moe_apply.counts`` (always on) holds, by layer, the calls, the (row,
slot) pairs routed to held experts, the largest load of one expert in one
call, and the experts launched on each ``term_matmul`` route: ``stream``
for slices of at most ``STREAM_MAX_M`` rows, ``mma`` above.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tq_tpu_torch.kernels.term_matmul import STREAM_MAX_M
from tq_tpu_torch.utils.trace import span

__all__ = ["route", "moe_apply"]


def route(x: torch.Tensor, router: dict, top_k: int, scale: float):
    """The selected experts (N, top_k) int64 and their weights (N, top_k)
    float32 of the rows ``x`` (N, d); ``router``: ``{'w': (E, d),
    'bias': (E,)}``."""
    scores = torch.sigmoid(torch.matmul(x.to(torch.float32),
                                        router["w"].to(torch.float32).T))
    idx = torch.topk(scores + router["bias"], top_k, dim=-1).indices
    w = scores.gather(1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale


def _count(layer: str, loads: Sequence[int]) -> None:
    c = moe_apply.counts.setdefault(
        layer, {"calls": 0, "tokens": 0, "max_load": 0, "stream": 0,
                "mma": 0})
    c["calls"] += 1
    c["tokens"] += sum(loads)
    c["max_load"] = max(c["max_load"], max(loads, default=0))
    c["stream"] += sum(1 for n in loads if 0 < n <= STREAM_MAX_M)
    c["mma"] += sum(1 for n in loads if n > STREAM_MAX_M)


def moe_apply(x: torch.Tensor, router: dict,
              expert: Callable[[int, torch.Tensor], torch.Tensor],
              top_k: int, scale: float, held: Sequence[int] | None = None,
              layer: str = "moe"):
    """The routed experts' weighted sum for the rows ``x`` (N, d):
    ``(y (N, d), selected experts (N, top_k))``.

    ``expert(e, rows)``: expert ``e``'s output for its rows (n, d);
    ``held``: the experts this layer holds (every expert when None);
    ``layer``: the key of ``moe_apply.counts``.
    """
    n_experts = router["w"].shape[0]
    with span("tq.moe.route"):
        idx, weight = route(x, router, top_k, scale)
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        loads = torch.bincount(flat, minlength=n_experts).tolist()
    every = held is None
    held = range(n_experts) if every else held
    _count(layer, [loads[e] for e in held])
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


moe_apply.counts = {}
