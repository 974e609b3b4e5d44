"""MNIST MLP UQ/TR sweep on the card.

Port of ``tq_tpu.evals.mlp``.  Per setting: convert -> calibration pass
on 5% of the (shuffled) test set -> MSE scale search -> full eval ->
profile -> append to the results lists.  Output schema:
{"accs": [], "tmacs": [], "param_bits": []}, flushed after every setting,
and a partial file resumes.  ``--fixed-linear`` really quantizes the dense
inputs (the reference layer drops them).

Runs on ``--device cuda`` by default and raises if there is no CUDA
device; ``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from tq_tpu_torch.data import load_mnist
from tq_tpu_torch.evals.train_mlp import load_or_train
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.models import mlp
from tq_tpu_torch.profilers import model_cost
from tq_tpu_torch.utils.device import resolve_device

__all__ = ["evaluate_setting", "run_sweep", "main", "resolve_device"]


def evaluate_setting(params, wb: int, wt: int, db: int, dt: int, gs: int,
                     x_test: torch.Tensor, y_test: torch.Tensor,
                     batch_size: int = 128, calib_pct: float = 0.05,
                     quantize_input: bool = False,
                     shuffle_seed: int | None = 0, merge_hack: bool = True):
    """Run one (wb, wt, db, dt, gs) setting; returns (acc%, tmacs, bits).

    ``x_test``/``y_test`` are tensors on the parameters' device.  The
    reference calibrates on a shuffled test loader's first 5%;
    ``shuffle_seed`` reproduces the JAX package's order.
    """
    settings = mlp.static_layer_settings(wb, gs, wt)
    qparams, qcfg, qstate = mlp.convert(params, settings, db, dt,
                                        quantize_input=quantize_input)

    order = np.arange(len(y_test))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    order = torch.as_tensor(order, device=x_test.device)

    # Phase 1: calibration on the first `calib_pct` of samples.
    track_fwd = mlp.make_quantized_apply(qcfg, track=True)
    n_calib = round(calib_pct * len(y_test))
    seen = 0
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        _, qstate = track_fwd(qparams, qstate, x_test[idx])
        seen += len(idx)
        if seen >= n_calib:
            break
    qstate = mlp.finalize(qstate, qcfg)

    # Phase 2: full evaluation; the count stays on the device until the end.
    eval_fwd = mlp.make_quantized_apply(qcfg, track=False)
    correct = torch.zeros((), dtype=torch.int64, device=x_test.device)
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        logp, _ = eval_fwd(qparams, qstate, x_test[idx])
        correct += (logp.argmax(-1) == y_test[idx]).sum()
    acc = 100.0 * int(correct) / len(y_test)

    # Profile (shape-based; batch=1 as the reference intends).
    layer_trs = [TRParams(wb, gs, wt, db, dt) for _ in mlp.LAYER_NAMES]
    weights = {n: qparams[n]["w"] for n in mlp.LAYER_NAMES}
    scales = {n: qparams[n]["w_sf"] for n in mlp.LAYER_NAMES}
    tmacs, param_bits = model_cost(
        list(zip(mlp.layer_costs(batch=1), layer_trs)), weights, scales,
        merge_hack=merge_hack)
    return acc, tmacs, param_bits


def run_sweep(wb, wt, db, dt, gs, out_file,
              checkpoint="pretrained/mnist_mlp.npz", data_dir=None,
              quantize_input=False, verbose=True, merge_hack=True,
              device="cuda"):
    """Evaluate every setting of the zipped lists; returns the results
    dict.  Skips the settings a partial ``out_file`` already holds."""
    device = resolve_device(device)
    params = load_or_train(checkpoint, device=device)
    _, (x_test, y_test), source = load_mnist(data_dir)
    if verbose:
        print(f"eval data source: {source}; device: {device}")
    x_test = torch.as_tensor(x_test, device=device)
    y_test = torch.as_tensor(y_test, device=device)

    results = {"accs": [], "tmacs": [], "param_bits": []}
    if out_file and Path(out_file).exists():
        prior = json.loads(Path(out_file).read_text())
        if prior.get("accs"):
            results = prior
    skip = len(results["accs"])
    for i, setting in enumerate(zip(wb, wt, db, dt, gs)):
        if i < skip:
            continue
        acc, tmacs, bits = evaluate_setting(
            params, *setting, x_test=x_test, y_test=y_test,
            quantize_input=quantize_input, merge_hack=merge_hack)
        results["accs"].append(acc)
        results["tmacs"].append(float(tmacs))
        results["param_bits"].append(float(bits))
        if verbose:
            print(*setting, acc, tmacs, bits)
        if out_file:
            Path(out_file).parent.mkdir(parents=True, exist_ok=True)
            with open(out_file, "w") as fp:
                json.dump(results, fp)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="MNIST MLP UQ/TR sweep")
    ap.add_argument("--wb", nargs="+", type=int, required=True)
    ap.add_argument("--wt", nargs="+", type=int, required=True)
    ap.add_argument("--db", nargs="+", type=int, required=True)
    ap.add_argument("--dt", nargs="+", type=int, required=True)
    ap.add_argument("--gs", nargs="+", type=int, required=True)
    ap.add_argument("--out-file", required=True)
    ap.add_argument("--checkpoint", default="pretrained/mnist_mlp.npz")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--fixed-linear", action="store_true",
                    help="really quantize dense inputs (the reference "
                         "layer drops them)")
    ap.add_argument("--sound-hese", action="store_true",
                    help="count param_bits with the sound HESE automaton "
                         "instead of the reference's merging-neighbors hese()")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    run_sweep(a.wb, a.wt, a.db, a.dt, a.gs, a.out_file, a.checkpoint,
              a.data_dir, quantize_input=a.fixed_linear,
              merge_hack=not a.sound_hese, device=a.device)


if __name__ == "__main__":
    main()
