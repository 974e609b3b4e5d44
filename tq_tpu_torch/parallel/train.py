"""Sharded training and evaluation steps over a ('data', 'model') mesh.

Port of ``tq_tpu.parallel.train``.  The JAX package jits one program whose
inputs carry shardings and lets GSPMD insert the collectives; here each
rank runs the MNIST MLP on its shards with the collectives written out,
Megatron style, each forward/backward pair an autograd function:

* fc1 is column-parallel: its input enters through
  :class:`~tq_tpu_torch.parallel._compat.ReduceBackward` (identity
  forward, gradient summed over 'model' backward) and its output columns
  stay sharded;
* fc2 is row-parallel: its partial product leaves through
  :class:`~tq_tpu_torch.parallel._compat.ReduceForward` (sum over 'model'
  forward, identity backward); fc3 is replicated;
* each rank's loss is the mean over its rows of the batch, so the
  gradients are averaged over 'data' before each rank's ``torch.optim``
  optimizer (Adadelta, element-wise) updates its shards in place.
"""

from __future__ import annotations

import numpy as np
import torch

from tq_tpu_torch.layers.common import dropout as _dropout
from tq_tpu_torch.models import mlp
from tq_tpu_torch.parallel._compat import (ReduceBackward, ReduceForward,
                                           axis_index, axis_size, psum)
from tq_tpu_torch.parallel.sharding import (batch_spec, mlp_param_specs,
                                            shard, shard_pytree)

__all__ = ["make_sharded_train_step", "make_sharded_eval_step",
           "setup_mlp_training", "sharded_apply", "data_generator"]


def data_generator(seed: int, mesh, device="cuda") -> torch.Generator:
    """A dropout generator on ``device`` for this rank: seeded from
    ``seed`` and the rank's index on 'data' (numpy's ``SeedSequence`` of
    the pair), so the ranks that split a batch draw different masks and
    the ranks of one 'data' index (its 'model' shards) the same ones."""
    index = axis_index(mesh, "data")
    state = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def sharded_apply(params, x: torch.Tensor, mesh, train: bool = False,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The MLP's log-probabilities on this rank's rows, from its shards
    under :func:`~tq_tpu_torch.parallel.sharding.mlp_param_specs`.
    ``train`` applies dropout (:data:`~tq_tpu_torch.models.mlp.DROPOUT`,
    masks from ``generator``) after each hidden ReLU."""
    x = x.reshape(x.shape[0], -1)
    fc1, fc2, fc3 = (params[n] for n in mlp.LAYER_NAMES)
    h = ReduceBackward.apply(x, mesh, "model")
    h = torch.relu(torch.matmul(h, fc1["w"]) + fc1["b"])
    if train:
        h = _dropout(h, mlp.DROPOUT, generator)
    h = ReduceForward.apply(torch.matmul(h, fc2["w"]), mesh, "model")
    h = torch.relu(h + fc2["b"])
    if train:
        h = _dropout(h, mlp.DROPOUT, generator)
    return torch.log_softmax(torch.matmul(h, fc3["w"]) + fc3["b"], dim=-1)


def _nll(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -logp.gather(1, y.long()[:, None]).mean()


def make_sharded_train_step(opt, mesh):
    """One DP x TP step of the MNIST MLP.

    ``step(params, x, y, generator=None, dropout=True)``: ``params`` are
    this rank's shards (the tensors ``opt`` updates), ``x`` and ``y`` the
    global batch, of which this rank takes its rows over 'data'.  Updates
    the shards in place and returns the global mean loss (a 0-d tensor,
    the same on every rank).  ``dropout=False`` drops no unit.
    """
    n_data = axis_size(mesh, "data")

    def step(params, x, y, generator=None, dropout: bool = True):
        x, y = shard(x, batch_spec(), mesh), shard(y, batch_spec(), mesh)
        opt.zero_grad(set_to_none=True)
        loss = _nll(sharded_apply(params, x, mesh, train=dropout,
                                  generator=generator), y)
        loss.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None and n_data > 1:
                    p.grad = psum(p.grad, mesh, "data") / n_data
        opt.step()
        return psum(loss.detach(), mesh, "data") / n_data

    return step


def make_sharded_eval_step(mesh):
    """``correct(params, x, y)``: correct predictions on the global batch
    (each rank counts its rows; the counts are summed over 'data')."""

    def correct(params, x, y):
        x, y = shard(x, batch_spec(), mesh), shard(y, batch_spec(), mesh)
        with torch.no_grad():
            logp = sharded_apply(params, x, mesh)
            hits = (logp.argmax(-1) == y).sum()
        return psum(hits, mesh, "data")

    return correct


def setup_mlp_training(mesh, lr: float = 1.0, seed: int = 0):
    """Seeded init (``mlp.init``), sharded over ``mesh`` on its device,
    and Adadelta over the shards.

    Returns (params, opt, train_step, eval_step); the optimizer's state
    lives in ``opt`` (the JAX package returns it beside as ``opt_state``).
    """
    from tq_tpu_torch.evals.train_mlp import trainable

    params = shard_pytree(mlp.init(torch.Generator().manual_seed(seed)),
                          mlp_param_specs(), mesh)
    opt = torch.optim.Adadelta(trainable(params), lr=lr)
    return (params, opt, make_sharded_train_step(opt, mesh),
            make_sharded_eval_step(mesh))
