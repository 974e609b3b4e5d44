"""Quantization-aware training demo: the MNIST MLP trained through term
revealing with the straight-through estimator.

Port of ``tq_tpu.evals.qat_mlp``.  The reference framework is
post-training only; QAT trains the same MLP with every dense weight (and,
with ``act_quant``, every dense input) term-revealed inside the loss by
:func:`~tq_tpu_torch.ops.term_reveal.term_reveal_st`, whose forward is
the ``tr_quantize`` kernel (element-wise at g = 1, grouped above) and
whose backward passes the gradient through.  :func:`run_demo` then
evaluates the QAT model and a float-trained baseline under the same
post-training conversion and eval protocol as the MLP sweep.

Usage:
    python -m tq_tpu_torch.evals.qat_mlp [--wb 1] [--wt 1] [--db 6]
        [--dt 6] [--gs 1] [--epochs 3] [--device cuda]

Prints one JSON line: {"setting": ..., "fp32_acc": ..., "ptq_acc": ...,
"qat_acc": ...}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.utils._pytree import tree_map

from tq_tpu_torch.data import load_mnist
from tq_tpu_torch.evals.mlp import evaluate_setting
from tq_tpu_torch.evals.train_mlp import nll_loss, train, trainable
from tq_tpu_torch.layers.common import dropout as _dropout
from tq_tpu_torch.models import mlp
from tq_tpu_torch.ops.term_reveal import term_reveal_st
from tq_tpu_torch.utils.device import resolve_device

__all__ = ["qat_apply", "qat_step", "train_qat", "run_demo", "main"]


def _st_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The conversion rule's per-tensor scale ``max|x| / 2^(bits-1)``,
    recomputed from the current values and detached (no gradient), a 0-d
    tensor on ``x``'s device."""
    return x.detach().abs().max().clamp_min(1e-8) / 2 ** (bits - 1)


def qat_apply(params, x: torch.Tensor, wb: int, gs: int, wt: int, db: int,
              dt: int, train: bool = False,
              generator: torch.Generator | None = None,
              dropout: float = 0.2, act_quant: bool = False) -> torch.Tensor:
    """The MLP forward with the weights (groups of ``gs`` along axis 0)
    and, with ``act_quant``, the dense inputs (g = 1) term-revealed
    through the straight-through estimator -> log-probabilities."""
    x = x.reshape(x.shape[0], -1)
    for i, name in enumerate(mlp.LAYER_NAMES):
        p = params[name]
        wq = term_reveal_st(p["w"], _st_scale(p["w"], wb), wb, gs, wt, 0)
        if act_quant:
            x = term_reveal_st(x, _st_scale(x, db), db, 1, dt, 0)
        x = torch.matmul(x, wq) + p["b"]
        if i < len(mlp.LAYER_NAMES) - 1:
            x = torch.relu(x)
            if train:
                x = _dropout(x, dropout, generator)
    return torch.log_softmax(x, dim=-1)


def qat_step(params, opt, x: torch.Tensor, y: torch.Tensor, wb: int, gs: int,
             wt: int, db: int, dt: int) -> torch.Tensor:
    """One step of the QAT recipe, updating ``params`` in place: the loss
    through the quantizer (no dropout), ``opt``'s update, then every
    latent parameter clipped to [-1, 1].  Returns the loss, a 0-d tensor
    on the device."""
    opt.zero_grad(set_to_none=True)
    loss = nll_loss(qat_apply(params, x, wb, gs, wt, db, dt), y)
    loss.backward()
    opt.step()
    with torch.no_grad():
        for group in opt.param_groups:
            for p in group["params"]:
                p.clamp_(-1.0, 1.0)
    return loss.detach()


def train_qat(wb: int, gs: int, wt: int, db: int, dt: int, epochs: int = 3,
              batch_size: int = 64, lr: float = 1e-3, seed: int = 1,
              data_dir=None, verbose: bool = True, device="cuda"):
    """Train with term-revealed weights; returns the float (latent)
    parameters.

    The BinaryConnect-style recipe: Adam at a small lr, no dropout, latent
    weights clipped to [-1, 1] after each update (which also pins the
    dynamic scale): straight-through gradients through 1-2-bit quantizers
    are heavily noised, and the float recipe's Adadelta(1.0) diverges on
    them.
    """
    device = resolve_device(device)
    (xtr, ytr), _, _ = load_mnist(data_dir)
    params = mlp.init(torch.Generator().manual_seed(seed), device=device)
    opt = torch.optim.Adam(trainable(params), lr=lr)
    xtr, ytr = (torch.as_tensor(a, device=device) for a in (xtr, ytr))

    n = len(ytr)
    order_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        perm = torch.as_tensor(order_rng.permutation(n), device=device)
        for i in range(n // batch_size):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            loss = qat_step(params, opt, xtr[idx], ytr[idx], wb, gs, wt, db,
                            dt)
        if verbose:
            print(f"qat epoch {epoch + 1}: loss={float(loss):.4f}",
                  flush=True)
    return tree_map(torch.Tensor.detach, params)


def run_demo(wb: int = 1, wt: int = 1, db: int = 6, dt: int = 6, gs: int = 1,
             epochs: int = 3, data_dir=None, verbose: bool = True,
             device="cuda"):
    """(fp32_acc, ptq_acc, qat_acc) under the same conversion and eval.

    Default setting: binary weights (wb=wt=1) with the standard data
    quantization, where post-training conversion visibly hurts and
    training through the quantizer recovers.  Both models go through the
    MLP sweep's :func:`~tq_tpu_torch.evals.mlp.evaluate_setting`.
    """
    device = resolve_device(device)
    _, (x_test, y_test), _ = load_mnist(data_dir)
    x_test = torch.as_tensor(x_test, device=device)
    y_test = torch.as_tensor(y_test, device=device)

    fp_params, fp32_acc = train(epochs=epochs, data_dir=data_dir,
                                verbose=verbose, device=device)
    ptq_acc, _, _ = evaluate_setting(fp_params, wb, wt, db, dt, gs,
                                     x_test=x_test, y_test=y_test)
    qat_params = train_qat(wb, gs, wt, db, dt, epochs=epochs,
                           data_dir=data_dir, verbose=verbose, device=device)
    qat_acc, _, _ = evaluate_setting(qat_params, wb, wt, db, dt, gs,
                                     x_test=x_test, y_test=y_test)
    return fp32_acc, ptq_acc, qat_acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wb", type=int, default=1)
    ap.add_argument("--wt", type=int, default=1)
    ap.add_argument("--db", type=int, default=6)
    ap.add_argument("--dt", type=int, default=6)
    ap.add_argument("--gs", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    fp32_acc, ptq_acc, qat_acc = run_demo(a.wb, a.wt, a.db, a.dt, a.gs,
                                          a.epochs, a.data_dir,
                                          device=a.device)
    print(json.dumps({
        "setting": dict(wb=a.wb, wt=a.wt, db=a.db, dt=a.dt, gs=a.gs),
        "fp32_acc": round(fp32_acc, 2),
        "ptq_acc": round(ptq_acc, 2),
        "qat_acc": round(qat_acc, 2),
    }))


if __name__ == "__main__":
    main()
