"""Example: quantized LM generation serving over a device mesh.

Port of the repository's ``examples/lm_serving.py``:

1. TR-convert the LSTM LM and pack its weights (9-bit u8s planes).
2. Continuous batching: a ``BatchRunner`` packs incoming prompts into
   fixed-size batches sharded over the mesh's 'data' ranks.
3. Each rank generates its rows' tokens, sampling on the device.

The serving batch is ``max(16, 2 * ranks)``, so up to 8 ranks serve 51
requests (three full batches and a padded tail of 3), as the JAX example
does on 8 devices.

Usage:
    python -m tq_tpu_torch.examples.lm_serving [--world 2]
        [--device cuda|cpu]
    torchrun --nproc-per-node 2 -m tq_tpu_torch.examples.lm_serving
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tq_tpu_torch.models import lstm_lm
from tq_tpu_torch.parallel._compat import axis_index, axis_size
from tq_tpu_torch.parallel.launch import run_ranks
from tq_tpu_torch.parallel.mesh import local_mesh
from tq_tpu_torch.parallel.serving import BatchRunner
from tq_tpu_torch.utils.device import resolve_device

VOCAB, EMSIZE, NHID, NLAYERS = 256, 64, 64, 2
WORDS = 16  # tokens generated per request


def serve(device: str) -> list[str]:
    """One rank's part; returns the lines rank 0 prints."""
    mesh = local_mesh(device=device)
    n = axis_size(mesh, "data")
    batch = max(16, 2 * n)
    lines = [f"mesh: {{'data': {n}, 'model': 1}}, serving batch {batch}"]
    dev = resolve_device(device)
    params = lstm_lm.init(torch.Generator().manual_seed(0), vocab=VOCAB,
                          emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS,
                          device=dev)
    qparams, qcfg, qstate = lstm_lm.convert(params, 8, 8, 24, 8, 8)
    qstate = {k: {**v, "sf": torch.tensor(0.05, device=dev)}
              for k, v in qstate.items()}
    qparams = lstm_lm.pack(qparams, qcfg, fmt="u8s")
    fwd = lstm_lm.make_quantized_apply(qcfg, track=False)
    gen = torch.Generator(device=dev).manual_seed(axis_index(mesh, "data"))

    def serve_batch(tok0):
        """(B, 1) prompt tokens -> (B, WORDS) generated tokens."""
        B = tok0.shape[0]
        hidden = lstm_lm.init_hidden(B, nhid=NHID, nlayers=NLAYERS,
                                     device=dev)
        tok, out = tok0.T, []
        with torch.no_grad():
            for _ in range(WORDS):
                logp, hidden, _ = fwd(qparams, qstate, tok, hidden)
                tok = torch.multinomial(logp.exp(), 1, generator=gen).T
                out.append(tok[0])
        return torch.stack(out, dim=1)

    runner = BatchRunner(serve_batch, mesh, batch_size=batch, pad_value=0)
    rng = np.random.default_rng(0)
    requests = [np.asarray([rng.integers(0, VOCAB)], np.int64)
                for _ in range(3 * batch + 3)]  # ragged: a padded tail
    t0 = time.perf_counter()
    results = runner.run_all(requests)
    dt = time.perf_counter() - t0
    if len(results) != len(requests) or any(r.shape != (WORDS,)
                                            for r in results):
        raise RuntimeError("a request was not served in full")
    lines.append(f"served {len(results)} generation requests "
                 f"({len(results) * WORDS} tokens) in {dt:.2f}s; "
                 f"first continuation: {list(map(int, results[0][:8]))}")
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
