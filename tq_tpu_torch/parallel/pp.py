"""Pipeline parallelism: GPipe-style microbatched stage execution.

Port of ``tq_tpu.parallel.pp``.  Every rank on the 'stage' mesh dimension
holds one pipeline stage's parameters; activations hop stage to stage by
``ppermute`` and the schedule is a Python loop of ticks on every rank.
Composes with the 'data' dimension (microbatches stay batch-sharded over
'data' while they flow across 'stage') and differentiates: the hop is
:class:`~tq_tpu_torch.parallel._compat.PPermute`, an autograd function
whose backward sends the gradient to the previous stage, and the drain
buffer's sum is :class:`~tq_tpu_torch.parallel._compat.ReduceForward`
(sum forward, identity backward: each rank differentiates its own copy of
the replicated output).  As in the JAX package every rank runs the same
program, its stage's role chosen by masks, not branches, so that each
rank's autograd graph holds every hop and the backward's sends and
receives pair up.

Schedule: the classic GPipe fill-drain pipeline.  With S stages and M
microbatches the loop runs T = M + S - 1 ticks; on tick t stage 0 feeds
microbatch t (while t < M), every stage applies its block to what it
received last tick, and outputs drain from the last stage from tick S - 1
on.  Bubble fraction (S - 1) / T.

Stages are shape-homogeneous (the same activation width in and out):
run the stem and head outside the pipeline, pipeline the trunk.
"""

from __future__ import annotations

import math
import warnings

import torch

from tq_tpu_torch.parallel._compat import (PPermute, ReduceForward,
                                           axis_index, axis_size)
from tq_tpu_torch.parallel.mesh import _world, mesh_over
from tq_tpu_torch.utils.device import resolve_device

__all__ = ["pipeline_apply", "make_pipeline_mesh", "make_tr_block_fn",
           "build_mlp_pipeline"]


def make_pipeline_mesh(n_stage: int, n_data: int | None = None,
                       devices=None, device="cuda"):
    """A ('data', 'stage') mesh; the data axis absorbs leftover ranks."""
    resolve_device(device)
    ranks = _world(devices)
    n = len(ranks)
    if n_data is None:
        if n % n_stage:
            raise ValueError(f"{n} devices not divisible by n_stage={n_stage}")
        n_data = n // n_stage
    if n_data * n_stage > n:
        raise ValueError(
            f"mesh needs n_data*n_stage = {n_data}*{n_stage} = "
            f"{n_data * n_stage} devices but only {n} are available"
        )
    if n_data * n_stage < n:
        warnings.warn(
            f"pipeline mesh uses {n_data * n_stage} of {n} devices "
            f"({n - n_data * n_stage} idle)",
            stacklevel=2,
        )
    return mesh_over(ranks, (n_data, n_stage), ("data", "stage"), device)


def pipeline_apply(stage_params, x_micro: torch.Tensor, block_fn, mesh,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the stage pipeline; returns their outputs.

    Args:
      stage_params: dict of tensors with a leading axis of length
        ``n_stage`` (stage s's slice is its parameters; each rank reads
        only its own).
      x_micro: (n_micro, micro_batch, width) input microbatches: this
        rank's rows of each microbatch when a 'data' dimension shards
        them (:func:`~tq_tpu_torch.parallel.sharding.shard_batch` with
        ``axis=1``; the JAX package's ``data_axis``: nothing here needs
        its name).
      block_fn: ``block_fn(params_s, x) -> y``, x and y both
        (micro_batch, width): one stage's computation.
      mesh: mesh with ``stage_axis`` (and 'data').

    Returns:
      (n_micro, micro_batch, width) last-stage outputs on every rank of
      ``stage_axis`` (the sum of the masked drain buffers), this rank's
      rows when the batch is sharded over 'data'.
    """
    n_stage = axis_size(mesh, stage_axis)
    n_micro = x_micro.shape[0]
    if n_micro < 1:
        raise ValueError("need at least one microbatch")
    sid = axis_index(mesh, stage_axis)
    params = {k: v[sid] for k, v in stage_params.items()}
    ticks = n_micro + n_stage - 1
    fwd = [(i, i + 1) for i in range(n_stage - 1)]
    is_first = torch.tensor(sid == 0, device=x_micro.device)
    is_last = torch.tensor(sid == n_stage - 1, device=x_micro.device)

    prev_out = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                           device=x_micro.device)
    drained = []
    for t in range(ticks):
        # What arrived from the previous stage (stage 0 gets zeros).
        recv = (PPermute.apply(prev_out, mesh, stage_axis, fwd)
                if n_stage > 1 else prev_out)
        inp = torch.where(is_first, x_micro[min(t, n_micro - 1)], recv)
        prev_out = block_fn(params, inp)
        # Drain: the last stage finishes microbatch t - (S-1) on tick t.
        if t >= n_stage - 1:
            drained.append(prev_out)
    out_buf = torch.where(is_last, torch.stack(drained),
                          torch.zeros((), dtype=x_micro.dtype,
                                      device=x_micro.device))
    # Only the last stage holds real outputs; replicate by a sum.
    return ReduceForward.apply(out_buf, mesh, stage_axis)


def make_tr_block_fn(bits: int, num_keep_terms: int):
    """A term-revealed dense+ReLU pipeline block.

    ``params = {'w': (d, d), 'b': (d,), 'w_sf': scalar, 'a_sf': scalar}``
    with the weight already fake-quantized offline; activations are
    term-revealed per element with the calibrated scale (B1, the
    ``tr_quantize`` kernel on the card) before a plain float32 product,
    which the JAX package computes outside any Pallas kernel too.
    """
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize

    def block(params, x):
        xq = tr_quantize(x, params["a_sf"], bits, 1, num_keep_terms)
        return torch.relu(torch.matmul(xq, params["w"]) + params["b"])

    return block


def build_mlp_pipeline(generator: torch.Generator, n_stage: int,
                       width: int = 512, in_dim: int = 784,
                       n_classes: int = 10, device="cuda"):
    """Deep-MLP pipeline demo: replicated stem and head, staged trunk.

    Normal weights scaled by 1/sqrt(fan_in) from ``generator`` (the JAX
    package's distributions; not its draws).  Returns ``(params,
    forward)`` where ``forward(params, x_micro, mesh)`` maps (n_micro,
    mb, in_dim) images to (n_micro, mb, n_classes) log-probabilities,
    pipelining the trunk over 'stage'.
    """
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator).to(device)

    scale = 1.0 / math.sqrt(width)
    params = {
        "stem": {"w": normal(in_dim, width) / math.sqrt(in_dim),
                 "b": torch.zeros(width, device=device)},
        "trunk": {"w": normal(n_stage, width, width) * scale,
                  "b": torch.zeros(n_stage, width, device=device)},
        "head": {"w": normal(width, n_classes) * scale,
                 "b": torch.zeros(n_classes, device=device)},
    }

    def block(p, x):
        return torch.relu(torch.matmul(x, p["w"]) + p["b"])

    def forward(params, x_micro, mesh):
        h = torch.relu(torch.einsum("mbi,io->mbo", x_micro,
                                    params["stem"]["w"])
                       + params["stem"]["b"])
        h = pipeline_apply(params["trunk"], h, block, mesh)
        logits = (torch.einsum("mbi,io->mbo", h, params["head"]["w"])
                  + params["head"]["b"])
        return torch.log_softmax(logits, dim=-1)

    return params, forward
