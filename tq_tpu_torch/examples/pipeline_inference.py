"""Example: pipeline-parallel quantized inference over a 'stage' mesh axis.

Port of the repository's ``examples/pipeline_inference.py``: a deep
trunk's blocks one per stage rank, term-revealed activations (B1 on the
card) hopping stage to stage, and microbatches keeping the bubble
fraction at (S-1)/(M+S-1).

Usage:
    python -m tq_tpu_torch.examples.pipeline_inference [--world 2]
        [--device cuda|cpu]
    torchrun --nproc-per-node 2 -m tq_tpu_torch.examples.pipeline_inference
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from tq_tpu_torch.parallel._compat import all_gather, axis_size
from tq_tpu_torch.parallel.launch import run_ranks
from tq_tpu_torch.parallel.pp import (make_pipeline_mesh, make_tr_block_fn,
                                      pipeline_apply)
from tq_tpu_torch.parallel.sharding import shard_batch
from tq_tpu_torch.utils.device import resolve_device


def serve(device: str) -> list[str]:
    """One rank's part; returns the lines rank 0 prints."""
    n = dist.get_world_size()
    n_stage = max(s for s in (8, 4, 2, 1) if n % s == 0 and s <= n)
    mesh = make_pipeline_mesh(n_stage=n_stage, device=device)
    n_data = axis_size(mesh, "data")
    lines = [f"mesh: {{'data': {n_data}, 'stage': {n_stage}}}  "
             f"(bubble fraction {(n_stage - 1) / (8 + n_stage - 1):.0%} "
             f"at 8 microbatches)"]

    width, n_micro = 512, 8
    # micro_batch must divide over the mesh's 'data' ranks: round 32 up.
    micro_batch = ((32 + n_data - 1) // n_data) * n_data
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    # One TR-quantized dense+ReLU block per stage (weights fake-quantized
    # offline; activations term-revealed on the fly at db=7, dt=3).
    stage_params = {
        "w": torch.tensor(rng.normal(size=(n_stage, width, width)) * 0.05,
                          dtype=torch.float32, device=dev),
        "b": torch.zeros((n_stage, width), device=dev),
        "w_sf": torch.full((n_stage,), 0.01, device=dev),
        "a_sf": torch.full((n_stage,), 0.05, device=dev),
    }
    block = make_tr_block_fn(bits=7, num_keep_terms=3)
    x = rng.normal(size=(n_micro, micro_batch, width)).astype(np.float32)
    with torch.no_grad():
        y = pipeline_apply(stage_params, shard_batch(x, mesh, axis=1), block,
                           mesh)
    y = all_gather(y, mesh, "data", axis=1)
    lines.append(f"pipelined {n_micro} microbatches of {micro_batch}: "
                 f"out {tuple(y.shape)}, mean |y| = "
                 f"{float(y.abs().mean()):.4f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to start here (ignored under torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    lines = run_ranks(serve, (args.device,), args.world, args.device)
    for line in lines or ():
        print(line, flush=True)


if __name__ == "__main__":
    main()
