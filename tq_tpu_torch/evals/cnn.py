"""ImageNet CNN UQ/TR sweep on the card.

Port of ``tq_tpu.evals.cnn``.  Per setting: per-layer settings -> convert
-> profile -> a calibration pass on 5% of the eval set -> MSE scale search
-> full eval.  Output schema as ``results/<arch>-results.json``:
``{quant, tr-data2, ...} x {accs, tmacs, avg_terms, params}``, flushed
after every setting; a partial file resumes.

Grids (``--grid``): ``published`` (default), the grids the published
results files were made with; ``committed``, the reference repository's
committed script.  Without real ImageNet the batches are deterministic
synthetic ones (accs are then meaningless; tmacs, avg_terms and params
still reproduce the published files).  Runs on ``--device cuda`` by
default on the one device, and raises if there is no CUDA device;
``--device cpu`` runs the plain versions of the kernels.  From code,
``mesh=`` runs each setting data-parallel over ranks.
"""

from __future__ import annotations

import argparse
import importlib
import json
from pathlib import Path

import torch

from tq_tpu_torch.convert import (convert_cnn, finalize_cnn, make_cnn_apply,
                                  static_conv_layer_settings)
from tq_tpu_torch.parallel._compat import axis_index, axis_size, psum
from tq_tpu_torch.parallel.sharding import shard_batch
from tq_tpu_torch.profilers import cnn_cost, param_count
from tq_tpu_torch.utils.device import resolve_device
from tq_tpu_torch.utils.params import params_from_jax

__all__ = ["ARCHS", "COMMITTED_GRID", "PUBLISHED_GRIDS", "get_model",
           "load_params", "eval_setting", "first_rank", "run_sweep", "main"]

ARCHS = ("alexnet", "vgg16_bn", "resnet18", "mobilenet_v2", "efficientnet_b0")

# The committed reference script's sweep.
COMMITTED_GRID = dict(
    uq_bits=(6, 7, 8, 9), uq_wt=9, uq_db=9, uq_dt=9,
    tr_data_terms=(2, 3, 4), tr_weight_terms=(12, 16, 20, 24),
)

# The grids of the published results files (resnet18/vgg16_bn: UQ wb in
# {5..9} with wt=wb at dt'=8, TR wt in {8..16} at dt in {2, 3}).
PUBLISHED_GRIDS = {
    "resnet18": dict(
        uq_bits=(5, 6, 7, 8, 9), uq_wt="wb", uq_db=9, uq_dt=8,
        tr_data_terms=(2, 3), tr_weight_terms=(8, 10, 12, 14, 16),
    ),
    "vgg16_bn": dict(
        uq_bits=(5, 6, 7, 8, 9), uq_wt="wb", uq_db=9, uq_dt=8,
        tr_data_terms=(2, 3), tr_weight_terms=(8, 10, 12, 14, 16),
    ),
    "mobilenet_v2": dict(COMMITTED_GRID),
    "efficientnet_b0": dict(COMMITTED_GRID),
    "alexnet": dict(COMMITTED_GRID),
}


_MODULES = {"alexnet": "alexnet", "vgg16_bn": "vgg", "resnet18": "resnet",
            "mobilenet_v2": "mobilenet", "efficientnet_b0": "efficientnet"}


def get_model(arch: str):
    """The model module of ``arch`` (one of ``ARCHS``)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"tq_tpu_torch.models.{_MODULES[arch]}")


def load_params(arch: str, checkpoint: str | None, seed: int = 0,
                device="cuda"):
    """(model module, parameters on ``device``): a ``.npz`` or torch
    ``.pt`` checkpoint if given, else a random init from a torch generator
    seeded ``seed`` (not the JAX package's init values).  A torchvision or
    efficientnet_pytorch ``state_dict`` loads as it is: the models' layer
    names are its module names.  Raises for ``cuda`` without a CUDA
    device."""
    m = get_model(arch)
    device = resolve_device(device)
    if checkpoint:
        path = Path(checkpoint)
        if path.suffix == ".npz":
            from tq_tpu_torch.utils.checkpoint import load_params as load_npz

            return m, params_from_jax(load_npz(path), device)
        from tq_tpu_torch.utils.torch_import import load_torch_checkpoint

        return m, params_from_jax(load_torch_checkpoint(path), device)
    return m, m.init(torch.Generator().manual_seed(seed), device=device)


def _batches(arch: str, data_dir, batch_size: int, n_synth: int):
    """Yield (x, y) NHWC val batches; synthetic without real data."""
    from tq_tpu_torch.data.imagenet import find_imagenet_val, iter_imagenet_val
    from tq_tpu_torch.data.synthetic import synthetic_imagenet_batch

    root = find_imagenet_val(data_dir)
    if root is not None:
        yield from iter_imagenet_val(root, batch_size, 224,
                                     "efficientnet" in arch)
        return
    for i in range(n_synth // batch_size):
        yield synthetic_imagenet_batch(batch_size, 224, seed=i)


def eval_setting(m, params, wb: int, gs: int, wt: int, db: int, dt: int,
                 arch: str, data_dir=None, batch_size: int = 64,
                 calib_pct: float = 0.05, n_synth: int = 512, mesh=None):
    """One (wb, gs, wt, db, dt) setting on the parameters' device ->
    (acc %, tmacs, avg_terms, params).

    ``mesh``: data-parallel over its 'data' dimension (the JAX package's
    ``mesh=``; every rank calls this with the same batches and
    replicated parameters).  Each rank runs its rows of a batch
    (``shard_batch``); the calibration counts and the correct count of a
    split batch are summed over 'data', so every rank calibrates the
    one-device histograms and returns the one-device columns.  A batch
    that does not divide is replicated (``shard_batch``) and counted
    once.  None: the one device.
    """
    specs = m.conv_specs()
    device = params[specs[0].name]["w"].device
    settings = static_conv_layer_settings(specs, wb, gs, wt)
    tmacs, avg_terms = cnn_cost(specs, settings, db, dt)
    n_params = param_count(params)

    qparams, qcfg, qstate = convert_cnn(m, params, settings, db, dt)

    batches = list(_batches(arch, data_dir, batch_size, n_synth))
    total = sum(len(y) for _, y in batches)
    n_calib = max(1, round(calib_pct * total))

    n_data = 1 if mesh is None else axis_size(mesh, "data")

    def rows(a):  # this rank's rows of a batch, on its device
        if mesh is None:
            return torch.as_tensor(a, device=device)
        return shard_batch(a, mesh)

    def split(y) -> bool:  # a batch the 'data' ranks share out
        return n_data > 1 and len(y) % n_data == 0

    track_fwd = {False: make_cnn_apply(m, qcfg, track=True),
                 True: make_cnn_apply(
                     m, qcfg, track=True,
                     count_reduce=lambda c: psum(c, mesh, "data"))}
    seen = 0
    for x, y in batches:
        _, qstate = track_fwd[split(y)](qparams, qstate, rows(x))
        seen += len(y)
        if seen >= n_calib:
            break
    qstate = finalize_cnn(qstate, qcfg)

    eval_fwd = make_cnn_apply(m, qcfg, track=False)
    # Counted on the device, whole batches and split ones apart; one sum
    # over 'data' and one fetch at the end.
    correct = torch.zeros(2, dtype=torch.int64, device=device)
    for x, y in batches:
        logits, _ = eval_fwd(qparams, qstate, rows(x))
        correct[int(split(y))] += (logits.argmax(-1) == rows(y)).sum()
    if n_data > 1:
        correct[1] = psum(correct[1], mesh, "data")
    return (100.0 * int(correct.sum()) / total, tmacs, avg_terms,
            n_params)


def first_rank(mesh) -> bool:
    """Whether this process writes a sweep's results: always on one
    device, else the rank at index 0 of every mesh dimension."""
    if mesh is None:
        return True
    return all(axis_index(mesh, d) == 0 for d in mesh.mesh_dim_names)


def run_sweep(arch: str, checkpoint: str | None = None,
              data_dir: str | None = None, out_file: str | None = None,
              batch_size: int = 64, n_synth: int = 512,
              uq_bits=(6, 7, 8, 9), uq_wt=9, uq_db=9, uq_dt=9,
              tr_data_terms=(2, 3, 4), tr_weight_terms=(12, 16, 20, 24),
              verbose: bool = True, device="cuda", mesh=None):
    """The UQ rows, then the TR rows (wb=9, g=8, db=9) of every data term
    count; returns the results dict, skipping what a partial ``out_file``
    already holds.  ``mesh``: each setting data-parallel over its ranks
    (:func:`eval_setting`); only its first rank prints and writes
    ``out_file``."""
    device = resolve_device(device)
    m, params = load_params(arch, checkpoint, device=device)
    results = {key: {"accs": [], "tmacs": [], "avg_terms": [], "params": []}
               for key in ["quant"] + [f"tr-data{d}" for d in tr_data_terms]}
    done = {key: 0 for key in results}
    if out_file and Path(out_file).exists():
        prior = json.loads(Path(out_file).read_text())
        for key in results:
            if key in prior and prior[key]["accs"]:
                results[key] = prior[key]
                done[key] = len(prior[key]["accs"])

    def record(key, res):
        acc, tmacs, avg_terms, n_params = res
        results[key]["accs"].append(acc)
        results[key]["tmacs"].append(float(tmacs))
        results[key]["avg_terms"].append(avg_terms)
        results[key]["params"].append(float(n_params))
        if not first_rank(mesh):
            return
        if verbose:
            print(key, acc, tmacs, avg_terms, n_params, flush=True)
        if out_file:
            Path(out_file).parent.mkdir(parents=True, exist_ok=True)
            with open(out_file, "w") as fp:
                json.dump(results, fp)

    kw = dict(arch=arch, data_dir=data_dir, batch_size=batch_size,
              n_synth=n_synth, mesh=mesh)
    for i, wb in enumerate(uq_bits):
        if i < done["quant"]:
            continue
        wt = wb if uq_wt == "wb" else uq_wt
        record("quant", eval_setting(m, params, wb, 1, wt, uq_db, uq_dt, **kw))
    for dt in tr_data_terms:
        for j, wt in enumerate(tr_weight_terms):
            if j < done[f"tr-data{dt}"]:
                continue
            record(f"tr-data{dt}",
                   eval_setting(m, params, 9, 8, wt, 9, dt, **kw))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="ImageNet CNN UQ/TR sweep")
    ap.add_argument("-a", "--arch", default="resnet18", choices=ARCHS)
    ap.add_argument("--val-dir", default=None,
                    help="dir containing imagenet/val (synthetic if absent)")
    ap.add_argument("--checkpoint", default=None,
                    help=".pt state_dict or .npz params")
    ap.add_argument("-b", "--batch-size", type=int, default=64)
    ap.add_argument("--n-synth", type=int, default=512)
    ap.add_argument("--out-file", default=None)
    ap.add_argument("--grid", default="published",
                    choices=["published", "committed"],
                    help="sweep settings: the published results files' "
                         "grids (default) or the committed script's")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    # cuDNN convolutions default to TF32, which alone misses the float32
    # reference by orders of magnitude: full float32 everywhere.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = a.out_file or f"results/{a.arch}-results.json"
    grid = (PUBLISHED_GRIDS[a.arch] if a.grid == "published"
            else COMMITTED_GRID)
    run_sweep(a.arch, a.checkpoint, a.val_dir, out, a.batch_size, a.n_synth,
              device=a.device, **grid)


if __name__ == "__main__":
    main()
