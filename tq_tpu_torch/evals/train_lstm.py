"""Wikitext-2 language-model training for the reference's five model
families.

Port of ``tq_tpu.evals.train_lstm``: one loop trains LSTM / GRU /
RNN_TANH / RNN_RELU through the recurrent stack and the Transformer.  The
reference recipe: bptt 35 truncated BPTT with the hidden state carried
across chunks (detached: no gradient crosses a chunk; the Transformer's
chunks are independent), per-chunk NLL on log-probs, manual SGD
``p -= lr * grad`` after a global gradient-norm clip at 0.25, lr 20
divided by 4 whenever the validation loss fails to improve, and the
best-validation parameters kept.  Dropout (default 0.2) on the embedding,
between recurrent layers and on the output; the Transformer's at torch's
four sites.  Masks come from a seeded ``torch.Generator`` on the device.

Runs on ``--device cuda`` by default and raises if there is no CUDA
device; ``--device cpu`` trains on the CPU.  Every product is a plain
float32 ``torch.matmul`` (the JAX trainer's are ``jnp.dot``): no kernel of
the port runs here.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

from tq_tpu_torch.data.wikitext import batchify, load_corpus
from tq_tpu_torch.evals.train_mlp import nll_loss, trainable
from tq_tpu_torch.layers.common import dropout as _dropout
from tq_tpu_torch.layers.lstm import _cell_scan
from tq_tpu_torch.models import lstm_lm, transformer_lm
from tq_tpu_torch.parallel._compat import all_gather, axis_size, psum
from tq_tpu_torch.parallel.sharding import shard_batch
from tq_tpu_torch.utils.checkpoint import save_params
from tq_tpu_torch.utils.device import resolve_device

__all__ = ["RNN_CELLS", "MODELS", "evaluate", "train", "main"]

RNN_CELLS = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")
MODELS = RNN_CELLS + ("Transformer",)


def _apply_train(params, tokens: torch.Tensor, hidden,
                 generator: torch.Generator | None, dropout: float,
                 cell: str = "LSTM"):
    """Recurrent-stack forward in train mode: dropout on the embedding,
    between layers and on the output -> ((T*B, vocab) log-probs, new
    hidden).  At ``dropout=0`` it computes what ``lstm_lm.apply`` does."""
    out = _dropout(params["encoder"]["w"][tokens.long()], dropout, generator)
    if cell == "LSTM":
        h0, c0 = hidden
    else:
        h0, c0 = hidden, None
    hs, cs = [], []
    for i, layer in enumerate(params["rnn"]):
        out, hT, cT = _cell_scan(layer, out, h0[i],
                                 None if c0 is None else c0[i], cell)
        if i < len(params["rnn"]) - 1:
            out = _dropout(out, dropout, generator)
        hs.append(hT)
        cs.append(cT)
    out = _dropout(out, dropout, generator)
    T, B, H = out.shape
    logits = (torch.matmul(out.reshape(T * B, H),
                           lstm_lm._decoder_weight(params))
              + params["decoder"]["b"])
    new_hidden = ((torch.stack(hs), torch.stack(cs)) if cell == "LSTM"
                  else torch.stack(hs))
    return torch.log_softmax(logits, dim=-1), new_hidden


@torch.no_grad()
def _sgd_clip_update(params, grads, lr: float, clip: float) -> None:
    """In place: scale the gradients to a global norm of at most ``clip``
    (``scale = min(1, clip / (norm + 1e-6))``, the norm over every float
    gradient), then ``p -= lr * scale * g``.  Integer leaves are left
    alone."""
    pairs = [(p, g) for p, g in zip(params, grads) if p.is_floating_point()]
    gnorm = torch.sqrt(sum((g * g).sum() for _, g in pairs))
    step = lr * torch.clamp(clip / (gnorm + 1e-6), max=1.0)
    for p, g in pairs:
        p.sub_(step * g)


class _DataParallel:
    """A chunk's batch over the 'data' dimension of ``mesh``: this rank's
    columns of the (T, B) tokens, of the flat (T*B) targets (their (T, B)
    view's columns, not a contiguous slice) and of the (L, B, H) hidden
    state; the gradients and the loss averaged over 'data' (each rank's
    loss is the mean over its equal share of the tokens).  A batch that
    does not divide is replicated (``shard_batch``): every rank then
    computes the whole step and nothing is reduced.  ``mesh=None``: the
    one device."""

    def __init__(self, mesh, batch: int):
        n = 1 if mesh is None else axis_size(mesh, "data")
        self.mesh, self.n = mesh, n
        self.split = n > 1 and batch % n == 0

    def cols(self, t: torch.Tensor, axis: int = 1) -> torch.Tensor:
        return shard_batch(t, self.mesh, axis) if self.split else t

    def targets(self, targets: torch.Tensor, T: int) -> torch.Tensor:
        return self.cols(targets.reshape(T, -1)).reshape(-1)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return (all_gather(t, self.mesh, "data", axis=1) if self.split
                else t)

    def mean(self, ts):
        """Each tensor of ``ts`` averaged over 'data': one collective on
        their concatenation."""
        if not self.split:
            return list(ts)
        flat = psum(torch.cat([t.reshape(-1) for t in ts]), self.mesh,
                    "data") / self.n
        return [p.view_as(t) for p, t in
                zip(flat.split([t.numel() for t in ts]), ts)]


def _train_step(params, tokens: torch.Tensor, targets: torch.Tensor, hidden,
                generator: torch.Generator | None, lr: float, clip: float,
                dropout: float = 0.2, cell: str = "LSTM", mesh=None):
    """One chunk of the recurrent recipe, updating ``params`` in place;
    returns (loss, new hidden), both on the device and detached: the
    hidden state enters the next chunk as a constant.

    ``mesh``: data-parallel over its 'data' dimension (see
    :class:`_DataParallel`); the arguments and results are the global
    batch's, as on one device (the new hidden state gathered over
    'data'), and the gradients are averaged before the clip, so the
    global norm is the one-device one.  ``generator``: this rank's
    (:func:`~tq_tpu_torch.parallel.train.data_generator`)."""
    dp = _DataParallel(mesh, tokens.shape[1])
    leaves = trainable(params)
    logp, new_hidden = _apply_train(params, dp.cols(tokens),
                                    tree_map(dp.cols, hidden), generator,
                                    dropout, cell)
    loss = nll_loss(logp, dp.targets(targets, tokens.shape[0]))
    _sgd_clip_update(leaves, dp.mean(torch.autograd.grad(loss, leaves)), lr,
                     clip)
    return (dp.mean([loss.detach()])[0],
            tree_map(lambda t: dp.gather(t.detach()), new_hidden))


def _train_step_transformer(params, tokens: torch.Tensor,
                            targets: torch.Tensor,
                            generator: torch.Generator | None, lr: float,
                            clip: float, dropout: float = 0.2,
                            nhead: int = 2, mesh=None) -> torch.Tensor:
    """One chunk of the Transformer recipe, updating ``params`` in place;
    returns the loss, on the device and detached.  ``mesh``, the global
    batch and ``generator`` as in :func:`_train_step`."""
    dp = _DataParallel(mesh, tokens.shape[1])
    leaves = trainable(params)
    logp = transformer_lm.apply_train(params, dp.cols(tokens), generator,
                                      nhead=nhead, dropout=dropout)
    loss = nll_loss(logp, dp.targets(targets, tokens.shape[0]))
    _sgd_clip_update(leaves, dp.mean(torch.autograd.grad(loss, leaves)), lr,
                     clip)
    return dp.mean([loss.detach()])[0]


def _chunk(stream: np.ndarray, i: int, bptt: int, device):
    """The chunk at row ``i``: (inputs (seq, B), flattened targets) on
    ``device``."""
    seq = min(bptt, len(stream) - 1 - i)
    return (torch.as_tensor(stream[i:i + seq], device=device),
            torch.as_tensor(stream[i + 1:i + 1 + seq].reshape(-1),
                            device=device))


@torch.no_grad()
def evaluate(params, stream: np.ndarray, bptt: int = 35,
             model: str = "LSTM", nhead: int = 2) -> float:
    """Mean NLL per token over the (T, B) ``stream`` on the parameters'
    device; the loss is summed there, one host fetch."""
    device = params["encoder"]["w"].device
    total = torch.zeros((), dtype=torch.float32, device=device)
    if model != "Transformer":
        hidden = lstm_lm.init_hidden(
            stream.shape[1], nhid=params["rnn"][0]["w_hh"].shape[0],
            nlayers=len(params["rnn"]), cell=model, device=device)
    for i in range(0, len(stream) - 1, bptt):
        x, y = _chunk(stream, i, bptt, device)
        if model == "Transformer":
            logp = transformer_lm.apply(params, x, nhead)
        else:
            logp, hidden = lstm_lm.apply(params, x, hidden, model)
        total = total + len(x) * nll_loss(logp, y)
    return float(total) / (len(stream) - 1)


def train(epochs: int = 40, batch_size: int = 20, bptt: int = 35,
          lr: float = 20.0, dropout: float = 0.2, seed: int = 1111,
          data_dir=None, save_path=None, emsize: int = 650, nhid: int = 650,
          nlayers: int = 2, limit_tokens: int | None = None,
          verbose: bool = True, model: str = "LSTM", nhead: int = 2,
          tied: bool = True, clip: float = 0.25,
          log_interval: int | None = None, device="cuda"):
    """Train ``model`` from a seeded init (``torch.Generator`` seeded
    ``seed``; dropout masks from one seeded ``seed + 1`` on the device);
    returns (best-validation parameters, a copy; best validation loss).

    ``tied``, ``clip``, ``bptt``, ``seed`` and ``log_interval`` mirror the
    reference CLI.  The reference's default is untied; this function
    keeps ``tied=True`` as the JAX package's does, and :func:`main`
    follows the reference.  ``save_path`` gets every new best, with
    ``meta={"model": model}`` (gate shapes cannot tell RNN_TANH from
    RNN_RELU).
    """
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    device = resolve_device(device)
    corpus, source = load_corpus(data_dir)
    vocab = len(corpus.dictionary.idx2word)
    if verbose:
        print(f"corpus: {source}, vocab={vocab}, model={model}, "
              f"device: {device}")
    train_toks = np.asarray(corpus.train)
    val_toks = np.asarray(corpus.valid)
    if limit_tokens:
        train_toks = train_toks[:limit_tokens]
        val_toks = val_toks[:max(limit_tokens // 10, 400)]
    train_stream = batchify(train_toks, batch_size)
    val_stream = batchify(val_toks, 10)

    gen = torch.Generator().manual_seed(seed)
    if model == "Transformer":
        params = transformer_lm.init(gen, vocab=vocab, emsize=emsize,
                                     nhead=nhead, nhid=nhid, nlayers=nlayers,
                                     device=device)
    else:
        params = lstm_lm.init(gen, vocab=vocab, emsize=emsize, nhid=nhid,
                              nlayers=nlayers, tied=tied, cell=model,
                              device=device)
    drop = torch.Generator(device=device).manual_seed(seed + 1)

    def snapshot():  # a copy: the steps update the live tensors in place
        return tree_map(lambda t: t.detach().clone(), params)

    best_val, best_params = math.inf, snapshot()
    for epoch in range(1, epochs + 1):
        if model != "Transformer":
            hidden = lstm_lm.init_hidden(batch_size, nhid=nhid,
                                         nlayers=nlayers, cell=model,
                                         device=device)
        interval_loss = torch.zeros((), dtype=torch.float32, device=device)
        n_batches = 0
        for i in range(0, len(train_stream) - 1, bptt):
            x, y = _chunk(train_stream, i, bptt, device)
            if model == "Transformer":
                loss = _train_step_transformer(params, x, y, drop, lr, clip,
                                               dropout, nhead)
            else:
                loss, hidden = _train_step(params, x, y, hidden, drop, lr,
                                           clip, dropout, model)
            if log_interval:
                # Summed on the device; one host fetch per interval.
                interval_loss = interval_loss + loss
                n_batches += 1
                if n_batches % log_interval == 0:
                    cur = float(interval_loss) / log_interval
                    print(f"| epoch {epoch} | batch {n_batches} | "
                          f"lr {lr:.2f} | loss {cur:5.2f} | "
                          f"ppl {math.exp(min(cur, 700)):8.2f}")
                    interval_loss = torch.zeros_like(interval_loss)
        val_loss = evaluate(params, val_stream, bptt, model, nhead)
        if verbose:
            print(f"epoch {epoch}: val_loss={val_loss:.3f} "
                  f"ppl={math.exp(min(val_loss, 700)):.2f} lr={lr}")
        if val_loss < best_val:
            best_val, best_params = val_loss, snapshot()
            if save_path:
                save_params(save_path, best_params, meta={"model": model})
        else:
            lr /= 4.0
    return best_params, best_val


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a Wikitext-2 LM")
    ap.add_argument("--model", default="LSTM", choices=list(MODELS),
                    help="recurrent cell type or Transformer")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=20)
    ap.add_argument("--bptt", type=int, default=35, help="sequence length")
    ap.add_argument("--lr", type=float, default=20.0)
    ap.add_argument("--clip", type=float, default=0.25,
                    help="gradient clipping")
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--tied", action="store_true",
                    help="tie the word embedding and softmax weights (like "
                         "the reference, the default is untied)")
    ap.add_argument("--seed", type=int, default=1111)
    ap.add_argument("--log-interval", type=int, default=200,
                    help="report interval in batches; 0 disables")
    ap.add_argument("--nhead", type=int, default=2)
    ap.add_argument("--data", default=None)
    ap.add_argument("--save", default="pretrained/lstm.npz")
    ap.add_argument("--emsize", type=int, default=650)
    ap.add_argument("--nhid", type=int, default=650)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--limit-tokens", type=int, default=None)
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="after training, save the best model's fp32 "
                         "serving step as a torch.export program at PATH "
                         "(recurrent families only; the quantized step is "
                         "evals.generate --tr --export)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    if a.export and a.model == "Transformer":
        ap.error("--export supports the recurrent families here; export "
                 "the Transformer with evals.generate --tr --export")
    Path(a.save).parent.mkdir(parents=True, exist_ok=True)
    best_params, _ = train(
        a.epochs, a.batch_size, bptt=a.bptt, lr=a.lr, dropout=a.dropout,
        seed=a.seed, data_dir=a.data, save_path=a.save, emsize=a.emsize,
        nhid=a.nhid, nlayers=a.nlayers, limit_tokens=a.limit_tokens,
        model=a.model, nhead=a.nhead, tied=a.tied, clip=a.clip,
        log_interval=a.log_interval or None, device=a.device)
    if a.export:
        from tq_tpu_torch.utils.export import export_serving

        device = best_params["encoder"]["w"].device

        def step(tok, hidden):
            return lstm_lm.apply(best_params, tok, hidden, a.model)

        export_serving(
            step, (torch.zeros((1, 1), dtype=torch.int64, device=device),
                   lstm_lm.init_hidden(1, nhid=a.nhid, nlayers=a.nlayers,
                                       cell=a.model, device=device)),
            a.export)
        print(f"exported serving step to {a.export}")


if __name__ == "__main__":
    main()
