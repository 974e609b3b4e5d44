"""CUDA graphs of model steps: capture a step once per key, replay it after.

A serving step that is a fixed chain of kernels on fixed shapes needs the
host for nothing between its launches, yet eager PyTorch spends tens of
microseconds of Python on each.  :meth:`StepGraphs.call` runs such a step
through one CUDA graph: the first call with a key runs the step eagerly on
a side stream a few times (plan caches, cuBLAS and the allocator warm up),
captures it and replays it; every later call with that key copies its
inputs into the graph's buffers and replays.

The key is what the card will read:

* each tensor of ``consts`` (weights, scales: read in place) by address,
  shape, strides and dtype, with the dicts, lists and tuples that hold
  them and any other value among them;
* each tensor of ``args`` (tokens, state: copied into the graph's own
  buffers) by shape and dtype;
* ``static``, the host values the caller's kernels bake in (a layer's
  ``TRParams``);
* the device and the float32 matmul precision.

A new conversion, a buffer freed and reused, or another setting thus takes
another key: a graph never reads another model's memory.  At most
``MAX_GRAPHS`` graphs are kept, the least recently used dropped first.

The graph engages only when every tensor is on a CUDA device, none
requires grad, no capture runs on the current stream and nothing traces
(``torch.export``, ``torch.compile``, ``torch.jit``); otherwise the step
runs eagerly, counted by reason.  A recording profiler does not stop it:
a replay shows in the trace as the graph's kernels.  What a call returns
is the caller's own: clones of the graph's outputs, except a ``shared``
part, the graph's own tensors until its next replay.  The kernels'
launch counters count launches on the card: a capture's counts are taken
back, and each replay adds them.  The program's spans
(``utils/trace.py``) are off while a step warms up and is captured: a
replay runs none of the step's Python.

``STEP_GRAPHS.counts`` (always on) counts each call once: ``captures``
(calls that captured a graph, then ran it), ``replays`` (calls that ran
one captured earlier) and ``eager`` calls by reason (``cpu``, ``track``,
``grad``, ``capturing``, ``tracing``); ``steps`` holds the same counts by
the name of the step (``lstm.step``, ``dsv3.decode``).
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

from tq_tpu_torch.kernels.histogram import histogram
from tq_tpu_torch.kernels.term_matmul import term_matmul
from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_scale_copy
from tq_tpu_torch.utils.trace import suspended

__all__ = ["StepGraphs", "STEP_GRAPHS", "REASONS"]

# Why a call runs eagerly: a tensor off the card, a tracking (calibration)
# forward, a tensor that requires grad, a capture already running on the
# stream, a tracer.
REASONS = ("cpu", "track", "grad", "capturing", "tracing")
# Eager steps on the side stream before a capture.
WARMUP = 3
# Graphs kept, and trees held by identity: the least recently used go
# first, so a sweep over many settings keeps a few graph pools.
MAX_GRAPHS = 8


def _zero_counts() -> dict:
    return {"captures": 0, "replays": 0, "eager": dict.fromkeys(REASONS, 0)}


def _launch_counters() -> tuple[dict, ...]:
    return (term_matmul.launches, term_matmul.kernel_launches,
            tr_quantize.launches, tr_scale_copy.launches, histogram.launches)


def _flatten(tree, key: list, leaves: list) -> None:
    """Append ``tree``'s structure and non-tensor values to ``key`` and its
    tensors to ``leaves``, depth first."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
    elif isinstance(tree, dict):
        key.append(len(tree))
        for k, v in tree.items():
            key.append(k)
            _flatten(v, key, leaves)
    elif isinstance(tree, (tuple, list)):
        key.append(type(tree))
        key.append(len(tree))
        for v in tree:
            _flatten(v, key, leaves)
    else:
        key.append(tree)


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by those of the
    iterator ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_rebuild(v, tensors) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    if isinstance(tree, list):
        return [_rebuild(v, tensors) for v in tree]
    return tree


def _leaves(tree) -> list:
    leaves: list = []
    _flatten(tree, [], leaves)
    return leaves


def _clone(tree):
    """``tree`` with each tensor cloned."""
    return _rebuild(tree, iter([t.clone() for t in _leaves(tree)]))


def _args_key(args) -> tuple[tuple, list]:
    """(the key of ``args``: its structure and each tensor's shape and
    dtype; its tensors)."""
    structure: list = []
    leaves: list = []
    _flatten(args, structure, leaves)
    return (tuple(structure),
            tuple([(t.shape, t.dtype) for t in leaves])), leaves


def _tracing() -> bool:
    return (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or torch.jit.is_tracing())


class _Graph:
    """A captured step: the graph, its input buffers and outputs, and the
    launches a replay makes, as (counter, key, count)."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


class _Held:
    """The key of a tuple of trees of tensors that a step reads in place:
    each tensor's address, shape, strides and dtype with the trees'
    structure and ``static``; its hash computed once.  ``reason``: why
    no graph may read them (a tensor off the card, or one that requires
    grad), or None.  Holds the trees and their tensors: a tree changed
    in place is read as it was."""

    __slots__ = ("consts", "leaves", "reason", "parts", "_hash")

    def __init__(self, consts: tuple, static):
        structure: list = []
        leaves: list = []
        _flatten(consts, structure, leaves)
        self.consts, self.leaves = consts, leaves
        self.reason = ("grad" if any(t.requires_grad for t in leaves)
                       else "cpu" if not all(t.is_cuda for t in leaves)
                       else None)
        self.parts = (static, tuple(structure),
                      tuple([(t.data_ptr(), t.shape, t.stride(), t.dtype)
                             for t in leaves]))
        self._hash = hash(self.parts)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return self is other or (isinstance(other, _Held)
                                 and self.parts == other.parts)


class StepGraphs:
    """CUDA graphs of steps, by key (see the module's docstring)."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._consts: collections.OrderedDict = collections.OrderedDict()
        self._streams: dict = {}
        self.counts = {**_zero_counts(), "steps": {}}

    def clear(self) -> None:
        """Drop every graph and held tree (the counts stay)."""
        self._graphs.clear()
        self._consts.clear()

    def _count(self, step: str, what: str) -> None:
        """Count a call of ``step``: ``what`` is ``captures``,
        ``replays`` or an eager call's reason."""
        by_step = self.counts["steps"].get(step)
        if by_step is None:
            by_step = self.counts["steps"][step] = _zero_counts()
        for c in (self.counts, by_step):
            if what in REASONS:
                c["eager"][what] += 1
            else:
                c[what] += 1

    def eager(self, reason: str, fn: Callable, *args, step: str = "step"):
        """``fn(*args)``, counted as an eager call of ``step`` for
        ``reason``."""
        self._count(step, reason)
        return fn(*args)

    def key(self, args, consts: tuple = (), static=()):
        """(the reason the call runs eagerly or None, its key, the
        tensors of ``args``)."""
        if _tracing():
            return "tracing", None, None
        akey, leaves = _args_key(args)
        if any(t.requires_grad for t in leaves):
            return "grad", None, leaves
        if not leaves or not all(t.is_cuda for t in leaves):
            return "cpu", None, leaves
        held = self._held(consts, static)
        if held.reason is not None:
            return held.reason, None, leaves
        if torch.cuda.is_current_stream_capturing():
            return "capturing", None, leaves
        return None, (held, leaves[0].device,
                      torch.get_float32_matmul_precision(),
                      torch.backends.cuda.matmul.allow_tf32, akey), leaves

    def _held(self, consts: tuple, static) -> "_Held":
        """The key of ``consts`` under ``static``, by the identity of the
        objects in ``consts`` (held, so that no other object takes their
        identity while the entry lives)."""
        ident = (static, *map(id, consts))
        held = self._consts.get(ident)
        if held is None:
            held = self._consts[ident] = _Held(consts, static)
            if len(self._consts) > MAX_GRAPHS:
                self._consts.popitem(last=False)
        else:
            self._consts.move_to_end(ident)
        return held

    def call(self, fn: Callable, args: tuple, consts: tuple = (),
             static=(), step: str = "step", shared: bool = False):
        """``fn(*args)`` through the CUDA graph of its key, captured on the
        key's first call; eagerly where no graph engages; counted under
        ``step``.  ``consts``: a tuple of the trees (dicts, lists and
        tuples) of every tensor ``fn`` reads besides ``args``.  After
        their first call the trees are known by identity, so change a
        model by building new trees, as conversion and packing do, not in
        place.  ``static``: the hashable host values ``fn`` bakes in.
        With ``shared``, ``fn`` returns a pair ``(outputs, kept)`` and the
        call ``(clones of outputs, kept)``, ``kept``'s tensors the graph's
        own: read them before the key's next call."""
        reason, key, leaves = self.key(args, consts, static)
        if reason is not None:
            return self.eager(reason, fn, *args, step=step)
        device = leaves[0].device
        if device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                return self._replay(fn, args, key, leaves, step, shared)
        return self._replay(fn, args, key, leaves, step, shared)

    def _replay(self, fn: Callable, args, key, leaves: list, step: str,
                shared: bool):
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(fn, args, leaves)
            self._graphs[key] = entry
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            self._count(step, "captures")
        else:
            self._graphs.move_to_end(key)
            self._count(step, "replays")
        for buf, t in zip(entry.inputs, leaves):
            buf.copy_(t)
        entry.graph.replay()
        for counter, k, n in entry.launches:
            counter[k] += n
        if shared:
            outputs, kept = entry.outputs
            return _clone(outputs), kept
        return _clone(entry.outputs)

    def _capture(self, fn: Callable, args, leaves: list) -> _Graph:
        """Warm ``fn`` up on its input buffers on a side stream, then
        capture it there, with the program's spans off."""
        device = leaves[0].device
        with torch.cuda.device(device), suspended():
            inputs = [t.clone() for t in leaves]
            static_args = _rebuild(args, iter(inputs))
            side = self._streams.get(device)
            if side is None:
                side = self._streams[device] = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*static_args)
            torch.cuda.current_stream(device).wait_stream(side)
            counters = _launch_counters()
            before = [dict(c) for c in counters]
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side):
                    outputs = fn(*static_args)
            finally:
                # The capture launched nothing: its counts become each
                # replay's.
                launches = [(c, k, c[k] - b[k])
                            for c, b in zip(counters, before)
                            for k in c if c[k] != b[k]]
                for c, b in zip(counters, before):
                    c.update(b)
        return _Graph(graph, inputs, outputs, launches)


# The graphs of every model step that uses them (``models/lstm_lm.py``,
# ``models/deepseek_v3.py``): one set a process, so that a graph outlives
# the forward that captured it and serves every later request on the same
# model and shape.
STEP_GRAPHS = StepGraphs()
