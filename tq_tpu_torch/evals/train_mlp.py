"""Train the MNIST MLP, or load its checkpoint.

Port of ``tq_tpu.evals.train_mlp``: Adadelta(lr=1.0) with a 0.7-per-epoch
staircase decay, NLL loss on log-softmax outputs, dropout 0.2 after each
hidden ReLU, batches in the order of ``np.random.default_rng(seed)``'s
permutation each epoch.  Works on real MNIST (``TQ_DATA_DIR``) or the
synthetic fallback, and saves an npz checkpoint that both packages load
(the sweeps' input).

Runs on ``--device cuda`` by default and raises if there is no CUDA
device; ``--device cpu`` trains on the CPU.  The products are plain
``torch.matmul``, as the JAX trainer's are ``jnp.dot``; no kernel of the
port runs here.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from tq_tpu_torch.data import load_mnist
from tq_tpu_torch.models import mlp
from tq_tpu_torch.utils.checkpoint import load_params, save_params
from tq_tpu_torch.utils.device import resolve_device
from tq_tpu_torch.utils.params import params_from_jax

__all__ = ["nll_loss", "trainable", "make_optimizer", "train_step", "train",
           "load_or_train", "main"]


def nll_loss(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the targets, a 0-d tensor."""
    return -logp.gather(1, y.long()[:, None]).mean()


def trainable(params) -> list[torch.Tensor]:
    """The float leaves of a parameter tree, in tree order, marked to
    take gradients (the optimizers update them in place)."""
    leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def make_optimizer(params, lr: float = 1.0, gamma: float = 0.7):
    """Adadelta over ``params`` at ``lr`` and the ``StepLR`` that decays
    it by ``gamma``; stepped once an epoch it equals the JAX trainer's
    ``optax.exponential_decay(lr, steps per epoch, gamma,
    staircase=True)``."""
    opt = torch.optim.Adadelta(trainable(params), lr=lr)
    return opt, torch.optim.lr_scheduler.StepLR(opt, step_size=1,
                                                gamma=gamma)


def train_step(params, opt, x: torch.Tensor, y: torch.Tensor,
               generator: torch.Generator | None = None,
               dropout: bool = True) -> torch.Tensor:
    """One optimizer step on the batch, updating ``params`` in place;
    returns the loss, a 0-d tensor on the device (no host sync).
    ``dropout=False`` drops no unit (the checks against the JAX recipe)."""
    opt.zero_grad(set_to_none=True)
    loss = nll_loss(mlp.apply(params, x, train=dropout, generator=generator),
                    y)
    loss.backward()
    opt.step()
    return loss.detach()


def train(epochs: int = 5, batch_size: int = 64, lr: float = 1.0,
          gamma: float = 0.7, seed: int = 1, data_dir: str | None = None,
          save_path: str | None = None, verbose: bool = True,
          test_batch_size: int = 1000, log_interval: int | None = None,
          dry_run: bool = False, device="cuda"):
    """Train from a seeded init (``torch.Generator`` seeded ``seed``;
    dropout masks from one seeded ``seed + 1`` on the device); returns
    (params, test accuracy %).  ``test_batch_size``, ``log_interval`` and
    ``dry_run`` (one train batch and one eval batch, then return) mirror
    the reference CLI."""
    device = resolve_device(device)
    (xtr, ytr), (xte, yte), source = load_mnist(data_dir)
    if verbose:
        print(f"data source: {source}; train={len(ytr)} test={len(yte)}; "
              f"device: {device}")
    params = mlp.init(torch.Generator().manual_seed(seed), device=device)
    opt, sched = make_optimizer(params, lr, gamma)
    drop = torch.Generator(device=device).manual_seed(seed + 1)
    # The training set moves to the device once; batches are gathered there.
    xtr, ytr = (torch.as_tensor(a, device=device) for a in (xtr, ytr))

    n = len(ytr)
    steps = n // batch_size
    order_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        perm = torch.as_tensor(order_rng.permutation(n), device=device)
        for i in range(steps):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            loss = train_step(params, opt, xtr[idx], ytr[idx], drop)
            if log_interval and i % log_interval == 0:
                print(f"Train Epoch: {epoch + 1} "
                      f"[{i * batch_size}/{n}]\tLoss: {float(loss):.6f}")
            if dry_run:
                break
        sched.step()
        correct = torch.zeros((), dtype=torch.int64, device=device)
        with torch.no_grad():
            for i in range(0, len(yte), test_batch_size):
                x = torch.as_tensor(xte[i:i + test_batch_size], device=device)
                y = torch.as_tensor(yte[i:i + test_batch_size], device=device)
                correct += (mlp.apply(params, x).argmax(-1) == y).sum()
                if dry_run:
                    break
        acc = 100.0 * int(correct) / len(yte)  # the epoch's one host fetch
        if verbose:
            print(f"epoch {epoch + 1}: loss={float(loss):.4f} "
                  f"test_acc={acc:.2f}%")
        if dry_run:
            break

    params = tree_map(torch.Tensor.detach, params)
    if save_path:
        save_params(save_path, params)
    return params, acc


def load_or_train(path: str = "pretrained/mnist_mlp.npz", device="cuda",
                  **kw):
    """The MLP's parameters from the npz checkpoint at ``path``, as
    tensors on ``device``; with no file there, :func:`train` (``kw``) on
    ``device`` and save to ``path`` first."""
    if Path(path).exists():
        return params_from_jax(load_params(path), resolve_device(device))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    params, _ = train(save_path=path, device=device, **kw)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the MNIST MLP")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--test-batch-size", type=int, default=1000,
                    help="eval batch size")
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--log-interval", type=int, default=0,
                    help="batches between loss prints; 0 disables")
    ap.add_argument("--dry-run", action="store_true",
                    help="a single train batch and eval batch")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--save-model", default="pretrained/mnist_mlp.npz")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    train(a.epochs, a.batch_size, a.lr, a.gamma, a.seed, a.data_dir,
          a.save_model, test_batch_size=a.test_batch_size,
          log_interval=a.log_interval or None, dry_run=a.dry_run,
          device=a.device)


if __name__ == "__main__":
    main()
