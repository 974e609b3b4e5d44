"""Wikitext-2 LSTM / Transformer UQ/TR perplexity sweep on the card.

Port of ``tq_tpu.evals.lstm``.  Per (wb, wt, db, dt, gs) setting: convert
-> a calibration pass over the whole test stream -> MSE scale search ->
perplexity -> profile.  bptt=35 chunks of a batchified (T, 10) token
stream, the hidden state carried across chunks (recurrent cells).

tmacs/param_bits follow the reference profile: for the recurrent cells
only the decoder linear on one bptt chunk counts (``35*10*vocab*650``
MACs), and param_bits count only the decoder weight (g=1: nelement*wb;
g>1: compressed HESE); for the Transformer every converted linear counts
(out_proj and the feed-forward pair of each layer, and the decoder).

Output schema: ``{"ppls": [], "tmacs": [], "param_bits": []}``, flushed
after every setting; a partial file resumes.  Runs on ``--device cuda`` by
default and raises if there is no CUDA device; ``--device cpu`` runs the
plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from tq_tpu_torch.data.wikitext import batchify, load_corpus
from tq_tpu_torch.evals.train_mlp import nll_loss
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.models import lstm_lm, transformer_lm
from tq_tpu_torch.profilers import dense_param_bits, dense_term_macs
from tq_tpu_torch.utils.checkpoint import load_params
from tq_tpu_torch.utils.device import resolve_device
from tq_tpu_torch.utils.params import params_from_jax
from tq_tpu_torch.utils.torch_import import load_torch_checkpoint

__all__ = ["evaluate_setting", "evaluate_setting_transformer", "run_sweep",
           "main", "EVAL_BATCH", "BPTT"]

EVAL_BATCH = 10
BPTT = 35


def _chunks(stream: np.ndarray, bptt: int = BPTT):
    """(inputs, flattened targets) per bptt chunk of the (T, B) stream."""
    for i in range(0, len(stream) - 1, bptt):
        seq = min(bptt, len(stream) - 1 - i)
        yield stream[i:i + seq], stream[i + 1:i + 1 + seq].reshape(-1)


def _run_epoch(fwd, qparams, qstate, stream: np.ndarray,
               update_state: bool, cell: str = "LSTM"):
    """One pass over the stream; returns (mean NLL per token, qstate).

    The full-length chunks run first, their ``BPTT * nll`` summed on the
    device in float32 (one host fetch per epoch), then the tail chunk
    (shorter than bptt), as the JAX package's scan and tail dispatch do.
    """
    device = qparams["encoder"]["w"].device
    nhid = qparams["rnn"][0]["w_hh"].shape[0]
    hidden = lstm_lm.init_hidden(EVAL_BATCH, nhid=nhid,
                                 nlayers=len(qparams["rnn"]), cell=cell,
                                 device=device)
    total_loss = 0.0
    n_chunks = (len(stream) - 1) // BPTT
    if n_chunks:
        B = stream.shape[1]
        X = torch.as_tensor(stream[:n_chunks * BPTT].reshape(n_chunks, BPTT, B),
                            device=device)
        Y = torch.as_tensor(
            stream[1:n_chunks * BPTT + 1].reshape(n_chunks, BPTT * B),
            device=device)
        tot = torch.zeros((), dtype=torch.float32, device=device)
        for x, y in zip(X, Y):
            logp, hidden, new_qs = fwd(qparams, qstate, x, hidden)
            if update_state:
                qstate = new_qs
            tot = tot + BPTT * nll_loss(logp, y)
        total_loss += float(tot)
    for x, y in _chunks(stream[n_chunks * BPTT:]):
        logp, hidden, new_qs = fwd(qparams, qstate,
                                   torch.as_tensor(x, device=device), hidden)
        if update_state:
            qstate = new_qs
        total_loss += len(x) * float(nll_loss(logp, torch.as_tensor(
            y, device=device)))
    return total_loss / (len(stream) - 1), qstate


def evaluate_setting(params, wb, wt, db, dt, gs, stream, vocab,
                     quantize_decoder_input=False, quantize_layers=(0,),
                     merge_hack=True, cell: str = "LSTM"):
    """One setting on the parameters' device; returns (ppl, tmacs, bits)."""
    qparams, qcfg, qstate = lstm_lm.convert(
        params, wb, gs, wt, db, dt, quantize_layers=quantize_layers,
        quantize_decoder_input=quantize_decoder_input, cell=cell)
    track_fwd = lstm_lm.make_quantized_apply(qcfg, track=True)
    _, qstate = _run_epoch(track_fwd, qparams, qstate, stream, True, cell)
    qstate = lstm_lm.finalize(qstate, qcfg)

    eval_fwd = lstm_lm.make_quantized_apply(qcfg, track=False)
    loss, _ = _run_epoch(eval_fwd, qparams, qstate, stream, False, cell)
    ppl = math.exp(loss)

    tr = TRParams(wb, gs, wt, db, dt)
    nhid = qparams["decoder"]["w"].shape[0]
    tmacs = dense_term_macs(BPTT * EVAL_BATCH * vocab, nhid, tr)
    param_bits = dense_param_bits(qparams["decoder"]["w"],
                                  qparams["decoder"]["w_sf"], tr,
                                  merge_hack=merge_hack)
    return ppl, tmacs, param_bits


def evaluate_setting_transformer(params, wb, wt, db, dt, gs, stream, vocab,
                                 bptt: int = BPTT):
    """One Transformer setting on the parameters' device; returns (ppl,
    tmacs, bits).  Every chunk starts from an empty context (no state
    crosses chunks); the loss is summed on the device, one host fetch.

    tmacs counts every converted linear on one bptt chunk (out_proj and
    the feed-forward pair of each layer, and the decoder); param_bits the
    same weights.
    """
    device = params["encoder"]["w"].device
    qparams, qcfg, qstate = transformer_lm.convert(params, wb, gs, wt, db,
                                                   dt)
    track = transformer_lm.make_quantized_apply(qcfg, track=True)
    for x, _ in _chunks(stream, bptt):
        _, qstate = track(qparams, qstate, torch.as_tensor(x, device=device))
    qstate = transformer_lm.finalize(qstate, qcfg)
    ev = transformer_lm.make_quantized_apply(qcfg, track=False)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for x, y in _chunks(stream, bptt):
        logp, _ = ev(qparams, qstate, torch.as_tensor(x, device=device))
        total = total + len(x) * nll_loss(logp, torch.as_tensor(y,
                                                            device=device))
    ppl = math.exp(float(total) / (len(stream) - 1))

    tr = TRParams(wb, gs, wt, db, dt)
    tmacs = bits = 0
    B = stream.shape[1]
    for name in qcfg:
        w = qparams[name]["w"]
        tmacs += dense_term_macs(bptt * B * w.shape[1], w.shape[0], tr)
        bits += dense_param_bits(w, qparams[name]["w_sf"], tr)
    return ppl, tmacs, bits


def _load_checkpoint(path, vocab: int, with_meta: bool = False):
    """A ``.npz`` checkpoint, or a torch ``.pt``/``.pth`` state_dict of the
    reference word LM (``encoder``, ``rnn``, tied ``decoder``), as a tree
    of numpy arrays (and its meta; a torch checkpoint has none)."""
    p = Path(path)
    if p.suffix == ".npz":
        return load_params(p, with_meta=with_meta)
    tree = load_torch_checkpoint(p)
    enc = tree["encoder"]["w"]  # the embedding, transposed as a linear
    if enc.shape[0] != vocab:
        enc = np.ascontiguousarray(enc.T)
    params = {"encoder": {"w": enc},
              "rnn": tree["rnn"],
              "decoder": {"b": tree["decoder"]["b"]}}  # tied
    return (params, {}) if with_meta else params


def run_sweep(wb, wt, db, dt, gs, out_file=None, checkpoint=None,
              data_dir=None, limit_tokens=None, verbose=True,
              model: str = "LSTM", merge_hack=True, device="cuda"):
    """Evaluate every setting of the zipped lists; returns the results
    dict.  Skips the settings a partial ``out_file`` already holds.
    ``model``: a recurrent cell or "Transformer" (whose checkpoint is an
    ``.npz``).  Without a checkpoint the model is a random init at full
    width (a torch generator seeded 0; not the JAX package's init
    values)."""
    device = resolve_device(device)
    corpus, source = load_corpus(data_dir)
    vocab = len(corpus.dictionary.idx2word)
    if verbose:
        print(f"corpus source: {source}; vocab={vocab}; device: {device}")
    if checkpoint:
        params = params_from_jax(_load_checkpoint(checkpoint, vocab),
                                 device)
    elif model == "Transformer":
        params = transformer_lm.init(torch.Generator().manual_seed(0),
                                     vocab=vocab, device=device)
    else:
        params = lstm_lm.init(torch.Generator().manual_seed(0), vocab=vocab,
                              cell=model, device=device)

    test = corpus.test
    if limit_tokens:
        test = test[:limit_tokens]
    stream = batchify(np.asarray(test), EVAL_BATCH)

    results = {"ppls": [], "tmacs": [], "param_bits": []}
    if out_file and Path(out_file).exists():
        prior = json.loads(Path(out_file).read_text())
        if prior.get("ppls"):
            results = prior
    skip = len(results["ppls"])
    for i, setting in enumerate(zip(wb, wt, db, dt, gs)):
        if i < skip:
            continue
        if model == "Transformer":
            ppl, tmacs, bits = evaluate_setting_transformer(
                params, *setting, stream=stream, vocab=vocab)
        else:
            ppl, tmacs, bits = evaluate_setting(
                params, *setting, stream=stream, vocab=vocab,
                merge_hack=merge_hack, cell=model)
        results["ppls"].append(ppl)
        results["tmacs"].append(float(tmacs))
        results["param_bits"].append(float(bits))
        if verbose:
            print(*setting, ppl, tmacs, bits, flush=True)
        if out_file:
            Path(out_file).parent.mkdir(parents=True, exist_ok=True)
            with open(out_file, "w") as fp:
                json.dump(results, fp)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Wikitext-2 LSTM UQ/TR sweep")
    ap.add_argument("--wb", nargs="+", type=int, required=True)
    ap.add_argument("--wt", nargs="+", type=int, required=True)
    ap.add_argument("--db", nargs="+", type=int, required=True)
    ap.add_argument("--dt", nargs="+", type=int, required=True)
    ap.add_argument("--gs", nargs="+", type=int, required=True)
    ap.add_argument("--out-file", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--limit-tokens", type=int, default=None)
    ap.add_argument("--model", default="LSTM",
                    choices=["LSTM", "GRU", "RNN_TANH", "RNN_RELU",
                             "Transformer"],
                    help="the reference main.py model families; the "
                         "recurrent cells share the shared-quantizer "
                         "protocol")
    ap.add_argument("--sound-hese", action="store_true",
                    help="count param_bits with the sound HESE automaton "
                         "instead of the reference's merging-neighbors hese()")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    run_sweep(a.wb, a.wt, a.db, a.dt, a.gs, a.out_file, a.checkpoint,
              a.data, a.limit_tokens, model=a.model,
              merge_hack=not a.sound_hese, device=a.device)


if __name__ == "__main__":
    main()
