"""Group-size / term-budget grid on the card.

Port of ``tq_tpu.evals.group_size``: g in {1, 2, 8, 16, 32} x alpha in
{1.0, 1.25, 1.5, 2.0, 3.0} at wb=9, db=9, dt=3 with weight_terms =
round(alpha * g).  Output schema as
``results/resnet18-group-size-results.json``: ``{str(g): {"avg_terms":
[], "accs": [], "tmacs": []}}``, flushed after every setting; a partial
file resumes.  Runs on ``--device cuda`` by default and raises if there is
no CUDA device; ``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from tq_tpu_torch.evals.cnn import (ARCHS, eval_setting, first_rank,
                                    load_params)
from tq_tpu_torch.utils.device import resolve_device

__all__ = ["ALPHAS", "GROUP_SIZES", "run_grid", "main"]

ALPHAS = (1.0, 1.25, 1.5, 2.0, 3.0)
GROUP_SIZES = (1, 2, 8, 16, 32)


def run_grid(arch: str = "resnet18", checkpoint=None, data_dir=None,
             out_file=None, batch_size: int = 64, n_synth: int = 512,
             group_sizes=GROUP_SIZES, alphas=ALPHAS, verbose: bool = True,
             device="cuda", mesh=None):
    """Every (g, alpha) setting not already in a partial ``out_file``;
    returns the results dict.  ``mesh``: each setting data-parallel over
    its ranks (``eval_setting``); only its first rank prints and writes
    ``out_file``."""
    device = resolve_device(device)
    m, params = load_params(arch, checkpoint, device=device)
    results = {}
    if out_file and Path(out_file).exists():
        results = json.loads(Path(out_file).read_text())
    for g in group_sizes:
        row = results.setdefault(str(g),
                                 {"avg_terms": [], "accs": [], "tmacs": []})
        for alpha in alphas[len(row["accs"]):]:
            wt = round(alpha * g)
            acc, tmacs, avg_terms, _ = eval_setting(
                m, params, 9, g, wt, 9, 3, arch=arch, data_dir=data_dir,
                batch_size=batch_size, n_synth=n_synth, mesh=mesh)
            row["accs"].append(acc)
            row["tmacs"].append(float(tmacs))
            row["avg_terms"].append(avg_terms)
            if not first_rank(mesh):
                continue
            if verbose:
                print(g, wt, acc, tmacs, flush=True)
            if out_file:
                Path(out_file).parent.mkdir(parents=True, exist_ok=True)
                with open(out_file, "w") as fp:
                    json.dump(results, fp)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="TR group-size grid search")
    ap.add_argument("-a", "--arch", default="resnet18", choices=ARCHS)
    ap.add_argument("--val-dir", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("-b", "--batch-size", type=int, default=64)
    ap.add_argument("--n-synth", type=int, default=512)
    ap.add_argument("--out-file", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    # Full float32 convolutions and products (cuDNN defaults to TF32).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = a.out_file or f"results/{a.arch}-group-size-results.json"
    run_grid(a.arch, a.checkpoint, a.val_dir, out, a.batch_size, a.n_synth,
             device=a.device)


if __name__ == "__main__":
    main()
