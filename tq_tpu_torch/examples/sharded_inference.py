"""Example: continuous-batching quantized inference over a device mesh.

Port of the repository's ``examples/sharded_inference.py``.  The serving
path: mesh -> TR-converted MNIST MLP -> ``BatchRunner`` packing requests
into fixed-size batches sharded over the mesh's 'data' ranks.

Usage:
    python -m tq_tpu_torch.examples.sharded_inference [--world 2]
        [--device cuda|cpu]
    torchrun --nproc-per-node 2 -m tq_tpu_torch.examples.sharded_inference
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tq_tpu_torch.models import mlp
from tq_tpu_torch.parallel._compat import axis_size
from tq_tpu_torch.parallel.launch import run_ranks
from tq_tpu_torch.parallel.mesh import local_mesh
from tq_tpu_torch.parallel.serving import BatchRunner
from tq_tpu_torch.utils.device import resolve_device


def serve(device: str) -> list[str]:
    """One rank's part; returns the lines rank 0 prints."""
    mesh = local_mesh(device=device)
    n = axis_size(mesh, "data")
    lines = [f"mesh: {{'data': {n}, 'model': 1}}"]
    dev = resolve_device(device)
    params = mlp.init(torch.Generator().manual_seed(0), device=dev)
    settings = mlp.static_layer_settings(4, 16, 14)
    qparams, qcfg, qstate = mlp.convert(params, settings, 6, 6, True)
    qstate = {k: {**v, "sf": torch.tensor(0.05, device=dev)}
              for k, v in qstate.items()}
    fwd = mlp.make_quantized_apply(qcfg, track=False)

    runner = BatchRunner(lambda x: fwd(qparams, qstate, x)[0], mesh,
                         batch_size=max(32, 4 * n))
    rng = np.random.default_rng(0)
    requests = [rng.normal(size=(1, 28, 28)).astype(np.float32)
                for _ in range(100)]
    results = runner.run_all(requests)
    lines.append(f"served {len(results)} requests; "
                 f"first prediction: {int(np.argmax(results[0]))}")
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
