"""Text sampler for the LSTM and Transformer language models, fp32 or
TR-quantized.

Port of ``tq_tpu.evals.generate``.  Samples ``--words`` tokens
autoregressively with temperature scaling and writes one word per token,
'<eos>' as a newline, 20 words per line.

The sampling loop stays on the device: each step draws categorical
``logp / T`` by the Gumbel-max rule from an explicit CUDA (or CPU)
``torch.Generator`` seeded from ``--seed``, and the tokens are fetched once
at the end.  The draws are not ``jax.random``'s, so the tokens differ from
the JAX package's; the distributions are the same.

TR serving (``generate_tr``): convert at (wb, gs, wt, db, dt), calibrate
the activation scales on a few bptt chunks of the eval stream, optionally
pack the weights ('u8s': 9 bits per weight; 'int': int8/int16), then
sample token by token through ``term_matmul``'s packed-weight modes.
The Transformer's fp32 sampler (``generate_transformer``) re-runs the full
prefix over a fixed buffer of ``words + 1`` tokens every token, exact under
the causal mask; its TR sampler (``generate_transformer_tr``) converts,
calibrates and packs the same way, then takes one KV-cache ``decode_step``
a token, where every converted linear streams its packed weights at one
row.  ``--export`` also saves the calibrated serving step as a
``torch.export`` program (``utils/export.py``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tq_tpu_torch.data.wikitext import batchify, load_corpus
from tq_tpu_torch.evals.lstm import EVAL_BATCH, _chunks, _load_checkpoint
from tq_tpu_torch.layers.lstm import GATE_MULT
from tq_tpu_torch.models import lstm_lm, transformer_lm
from tq_tpu_torch.utils.device import resolve_device
from tq_tpu_torch.utils.export import (check_platforms, export_lm_step,
                                       export_serving, to_cpu)
from tq_tpu_torch.utils.params import params_from_jax
from tq_tpu_torch.utils.trace import span

__all__ = ["generate", "generate_tr", "calibrate", "serving_model",
           "sample_quantized", "generate_transformer",
           "generate_transformer_tr", "calibrate_transformer",
           "transformer_serving_model", "sample_transformer",
           "export_transformer_step", "main"]

CELLS = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")


def _sample_scan(fwd, hidden0, vocab: int, words: int, temperature: float,
                 seed: int, device) -> list[int]:
    """Sample ``words`` tokens: ``fwd(tok (1, 1), carry) -> (logp (1,
    vocab), carry)`` once per token (the carry: a recurrent hidden state,
    or the Transformer's buffer or KV cache with its position), the next
    token drawn on the device (Gumbel-max: ``argmax(logp / T + Gumbel
    noise)`` is categorical ``logp / T``); the first token comes from
    ``numpy`` seeded ``seed``.  Spans: ``tq.sampler.request`` (``rid``
    the seed) around it all, ``tq.sampler.draw`` around each draw."""
    _check_temperature(temperature)
    with span("tq.sampler.request", rid=seed):
        rng = np.random.default_rng(seed)
        tok = torch.full((1, 1), int(rng.integers(0, vocab)),
                         dtype=torch.int64, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        tiny = torch.finfo(torch.float32).tiny
        hidden, toks = hidden0, []
        for _ in range(words):
            logp, hidden = fwd(tok, hidden)
            with span("tq.sampler.draw"):
                u = torch.rand(logp.shape[-1], generator=gen, device=device)
                gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
                tok = torch.argmax(logp[0] / temperature
                                   + gumbel).reshape(1, 1)
            toks.append(tok)
        return torch.cat(toks).reshape(-1).tolist() if toks else []


def generate(params, vocab: int, words: int = 100, temperature: float = 1.0,
             seed: int = 1111, cell: str = "LSTM",
             device="cuda") -> list[int]:
    """Sample from the fp32 model (a tree of numpy arrays or tensors)."""
    device = resolve_device(device)
    params = params_from_jax(params, device)
    nhid = params["rnn"][0]["w_hh"].shape[0]
    hidden = lstm_lm.init_hidden(1, nhid=nhid, nlayers=len(params["rnn"]),
                                 cell=cell, device=device)

    def fwd(tok, hidden):
        return lstm_lm.apply(params, tok, hidden, cell)

    return _sample_scan(fwd, hidden, vocab, words, temperature, seed, device)


def calibrate(qparams, qcfg, qstate, calib_stream=None,
              calib_chunks: int = 4):
    """Calibrate a converted model: phase 1 on the first ``calib_chunks``
    bptt chunks of ``calib_stream`` (a batchified (T, B) token stream; None
    skips it), then the MSE scale search.  Returns the finalized qstate."""
    if calib_stream is not None:
        device = qparams["encoder"]["w"].device
        cell = qcfg.get("cell", "LSTM")
        track = lstm_lm.make_quantized_apply(qcfg, track=True)
        hidden = lstm_lm.init_hidden(
            calib_stream.shape[1], nhid=qparams["rnn"][0]["w_hh"].shape[0],
            nlayers=len(qparams["rnn"]), cell=cell, device=device)
        for i, (x, _) in enumerate(_chunks(calib_stream)):
            if i >= calib_chunks:
                break
            _, hidden, qstate = track(qparams, qstate,
                                      torch.as_tensor(x, device=device),
                                      hidden)
    return lstm_lm.finalize(qstate, qcfg)


def serving_model(params, tr=(8, 8, 24, 8, 8), pack_fmt: str | None = None,
                  calib_stream=None, calib_chunks: int = 4,
                  cell: str | None = None,
                  quantize_decoder_input: bool = False):
    """Convert at ``tr`` = (wb, gs, wt, db, dt), :func:`calibrate`, then
    pack (``pack_fmt`` 'u8s' or 'int'; None keeps the term-revealed
    float32 weights).  ``params`` are tensors on the device to serve on.
    Returns (qparams, qcfg, qstate)."""
    wb, gs, wt, db, dt = tr
    if cell is None:
        cell = lstm_lm.infer_cell(params)
    qparams, qcfg, qstate = lstm_lm.convert(
        params, wb, gs, wt, db, dt,
        quantize_decoder_input=quantize_decoder_input, cell=cell)
    qstate = calibrate(qparams, qcfg, qstate, calib_stream, calib_chunks)
    if pack_fmt is not None:
        qparams = lstm_lm.pack(qparams, qcfg, fmt=pack_fmt)
    return qparams, qcfg, qstate


def sample_quantized(qparams, qcfg, qstate, vocab: int, words: int = 100,
                     temperature: float = 1.0, seed: int = 1111) -> list[int]:
    """Sample token by token from a converted (and calibrated, maybe
    packed) model, batch 1."""
    device = qparams["encoder"]["w"].device
    fwd = lstm_lm.make_quantized_apply(qcfg, track=False)

    def step(tok, hidden):
        logp, hidden, _ = fwd(qparams, qstate, tok, hidden)
        return logp, hidden

    cell = qcfg.get("cell", "LSTM")
    nhid = qparams["rnn"][0]["b_hh"].shape[0] // GATE_MULT[cell]
    hidden0 = lstm_lm.init_hidden(1, nhid=nhid, nlayers=len(qparams["rnn"]),
                                  cell=cell, device=device)
    return _sample_scan(step, hidden0, vocab, words, temperature, seed,
                        device)


def generate_tr(params, vocab: int, words: int = 100,
                temperature: float = 1.0, seed: int = 1111,
                tr=(8, 8, 24, 8, 8), pack_fmt: str | None = None,
                calib_stream=None, calib_chunks: int = 4,
                cell: str | None = None, export_path=None,
                export_platforms=None, device="cuda") -> list[int]:
    """Generate from the TR-quantized recurrent LM at serving speed:
    :func:`serving_model`, then :func:`sample_quantized`.  ``cell``: None
    infers it from the gate shapes.  ``export_path``: also save the
    calibrated (packed) serving step there
    (:func:`~tq_tpu_torch.utils.export.export_lm_step`), for the devices
    ``export_platforms`` names (e.g. ``("cpu", "cuda")``) if given."""
    check_platforms(export_platforms)
    device = resolve_device(device)
    params = params_from_jax(params, device)
    qparams, qcfg, qstate = serving_model(params, tr, pack_fmt, calib_stream,
                                          calib_chunks, cell)
    if export_path is not None:
        export_lm_step(qparams, qcfg, qstate, export_path,
                       platforms=export_platforms)
    return sample_quantized(qparams, qcfg, qstate, vocab, words, temperature,
                            seed)


def _check_temperature(temperature: float) -> None:
    if temperature < 1e-3:
        raise ValueError("temperature has to be greater or equal 1e-3")


def generate_transformer(params, vocab: int, words: int = 100,
                         temperature: float = 1.0, seed: int = 1111,
                         nhead: int = 2, device="cuda") -> list[int]:
    """Sample from the fp32 Transformer LM (a tree of numpy arrays or
    tensors), the reference's way: each token re-runs the full prefix.

    The prefix lives in a fixed buffer of ``words + 1`` tokens (zeros past
    the cursor); under the causal mask the position at the cursor attends
    to the prefix alone, so its distribution is that of the grown prefix
    (``tests/test_torch_port_transformer.py`` holds the two equal).
    """
    _check_temperature(temperature)
    device = resolve_device(device)
    params = params_from_jax(params, device)
    L = words + 1

    def fwd(tok, carry):
        buf, n = carry
        buf[n] = tok[0]  # the sampler's own buffer, written in place
        logp = transformer_lm.apply(params, buf, nhead=nhead)
        return logp[n:n + 1], (buf, n + 1)

    buf0 = torch.zeros((L, 1), dtype=torch.int64, device=device)
    return _sample_scan(fwd, (buf0, 0), vocab, words, temperature, seed,
                        device)


def calibrate_transformer(qparams, qcfg, qstate, calib_stream=None,
                          calib_chunks: int = 4, nhead: int = 2):
    """:func:`calibrate` for a converted Transformer: phase 1 on the first
    ``calib_chunks`` bptt chunks of ``calib_stream`` (None skips it), then
    the scale search.  Returns the finalized qstate."""
    if calib_stream is not None:
        device = qparams["encoder"]["w"].device
        track = transformer_lm.make_quantized_apply(qcfg, track=True,
                                                    nhead=nhead)
        for i, (x, _) in enumerate(_chunks(calib_stream)):
            if i >= calib_chunks:
                break
            _, qstate = track(qparams, qstate,
                              torch.as_tensor(x, device=device))
    return transformer_lm.finalize(qstate, qcfg)


def transformer_serving_model(params, tr=(8, 8, 24, 8, 8),
                              pack_fmt: str | None = None,
                              calib_stream=None, calib_chunks: int = 4,
                              nhead: int = 2):
    """Convert the Transformer at ``tr`` = (wb, gs, wt, db, dt), calibrate
    on the first ``calib_chunks`` bptt chunks of ``calib_stream``
    (:func:`calibrate_transformer`), then pack every converted linear
    (``pack_fmt`` 'u8s' or 'int'; None keeps the term-revealed float32
    weights).  ``params`` are tensors on the device to serve on.  Returns
    (qparams, qcfg, qstate)."""
    wb, gs, wt, db, dt = tr
    qparams, qcfg, qstate = transformer_lm.convert(params, wb, gs, wt, db,
                                                   dt)
    qstate = calibrate_transformer(qparams, qcfg, qstate, calib_stream,
                                   calib_chunks, nhead)
    if pack_fmt is not None:
        qparams = transformer_lm.pack(qparams, qcfg, fmt=pack_fmt)
    return qparams, qcfg, qstate


def _init_cache(qparams, L: int, nhead: int):
    enc = qparams["encoder"]["w"]
    nlayers = sum(1 for k in qparams if k.endswith(".linear1"))
    return transformer_lm.decode_init_cache(L, 1, enc.shape[1], nhead,
                                            nlayers, device=enc.device)


def sample_transformer(qparams, qcfg, qstate, vocab: int, words: int = 100,
                       temperature: float = 1.0, seed: int = 1111,
                       nhead: int = 2) -> list[int]:
    """Sample token by token from a converted (and calibrated, maybe
    packed) Transformer, batch 1: one KV-cache ``decode_step`` a token,
    the carry (cache, position)."""
    _check_temperature(temperature)

    def fwd(tok, carry):
        cache, pos = carry
        logp, cache = transformer_lm.decode_step(
            qparams, tok, pos, cache, nhead=nhead, qcfg=qcfg, qstate=qstate)
        return logp, (cache, pos + 1)

    device = qparams["encoder"]["w"].device
    return _sample_scan(fwd, (_init_cache(qparams, words + 1, nhead), 0),
                        vocab, words, temperature, seed, device)


def export_transformer_step(qparams, qcfg, qstate, L: int, path=None,
                            nhead: int = 2, platforms=None) -> bytes:
    """Save the KV-cache ``decode_step`` at cache length ``L`` as a
    program ``step(tok (1, 1) int64, pos () int64, cache) -> (logp,
    cache)``, the (packed) weights and scales its constants: on their
    device, or, with ``platforms`` (e.g. ``("cpu", "cuda")``), traced
    from CPU copies of them as an artifact for those devices."""
    if check_platforms(platforms) is not None:
        qparams, qstate = to_cpu(qparams), to_cpu(qstate)
    device = qparams["encoder"]["w"].device

    def step(tok, pos, cache):
        return transformer_lm.decode_step(qparams, tok, pos, cache,
                                          nhead=nhead, qcfg=qcfg,
                                          qstate=qstate)

    return export_serving(
        step, (torch.zeros((1, 1), dtype=torch.int64, device=device),
               torch.zeros((), dtype=torch.int64, device=device),
               _init_cache(qparams, L, nhead)), path, platforms)


def generate_transformer_tr(params, vocab: int, words: int = 100,
                            temperature: float = 1.0, seed: int = 1111,
                            nhead: int = 2, tr=(8, 8, 24, 8, 8),
                            pack_fmt: str | None = None, calib_stream=None,
                            calib_chunks: int = 4, export_path=None,
                            export_platforms=None,
                            device="cuda") -> list[int]:
    """Sample from the TR-quantized Transformer at serving speed:
    :func:`transformer_serving_model`, then :func:`sample_transformer`.
    ``export_path``: also save the decode step at cache length ``words +
    1`` there (:func:`export_transformer_step`), for the devices
    ``export_platforms`` names if given."""
    _check_temperature(temperature)
    check_platforms(export_platforms)
    device = resolve_device(device)
    params = params_from_jax(params, device)
    qparams, qcfg, qstate = transformer_serving_model(
        params, tr, pack_fmt, calib_stream, calib_chunks, nhead)
    if export_path is not None:
        export_transformer_step(qparams, qcfg, qstate, words + 1,
                                export_path, nhead, export_platforms)
    return sample_transformer(qparams, qcfg, qstate, vocab, words,
                              temperature, seed, nhead)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None,
                    help="an .npz checkpoint (or a torch state_dict of the "
                         "recurrent LM); default: pretrained/lstm.npz for "
                         "--model LSTM, a random init at full width (a "
                         "torch generator seeded 0) for --model "
                         "Transformer")
    ap.add_argument("--data", default=None)
    ap.add_argument("--model", default="LSTM",
                    choices=["LSTM", "Transformer"])
    ap.add_argument("--cell", default=None, choices=list(CELLS),
                    help="recurrent cell family of the checkpoint; default: "
                         "the checkpoint's own 'model' metadata, else "
                         "inferred from gate shapes (which can not tell "
                         "RNN_TANH from RNN_RELU)")
    ap.add_argument("--nhead", type=int, default=2)
    ap.add_argument("--words", type=int, default=100)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=1111)
    ap.add_argument("--outf", default="generated.txt")
    ap.add_argument("--tr", type=int, nargs=5, default=None,
                    metavar=("WB", "GS", "WT", "DB", "DT"),
                    help="generate from the TR-quantized model at this "
                         "setting (LSTM or Transformer)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="also save the quantized serving step at PATH as "
                         "a torch.export program (load it with "
                         "tq_tpu_torch.utils.export.load_serving); "
                         "requires --tr")
    ap.add_argument("--export-platforms", default=None, metavar="P1,P2",
                    help="comma-separated devices the --export artifact "
                         "serves, of 'cpu' and 'cuda' (e.g. 'cpu,cuda': "
                         "traced on the CPU, moved to the device it is "
                         "loaded on; load_serving(path, device=...), "
                         "default cuda); default: only the device it is "
                         "exported on")
    ap.add_argument("--pack", default="none", choices=["u8s", "int", "none"],
                    help="weight format for --tr serving: none (float32 "
                         "fake-quant weights), u8s (9 bits per weight) or "
                         "int (int8/int16)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    if a.export and a.tr is None:
        raise SystemExit("--export requires --tr (the artifact is the "
                         "quantized serving step)")
    platforms = check_platforms(a.export_platforms.split(",")
                                if a.export_platforms else None)
    device = resolve_device(a.device)

    corpus, source = load_corpus(a.data)
    vocab = len(corpus.dictionary.idx2word)
    pack_fmt = None if a.pack == "none" else a.pack
    stream = (batchify(np.asarray(corpus.test), EVAL_BATCH)
              if a.tr is not None else None)
    if a.model == "Transformer":
        if a.checkpoint:
            params = _load_checkpoint(a.checkpoint, vocab)
        else:
            params = transformer_lm.init(torch.Generator().manual_seed(0),
                                         vocab=vocab, device=device)
        if a.tr is not None:
            toks = generate_transformer_tr(
                params, vocab, a.words, a.temperature, a.seed, nhead=a.nhead,
                tr=tuple(a.tr), pack_fmt=pack_fmt, calib_stream=stream,
                export_path=a.export, export_platforms=platforms,
                device=device)
        else:
            toks = generate_transformer(params, vocab, a.words,
                                        a.temperature, a.seed,
                                        nhead=a.nhead, device=device)
    else:
        params, meta = _load_checkpoint(
            a.checkpoint or "pretrained/lstm.npz", vocab, with_meta=True)
        meta_model = meta.get("model")
        cell = a.cell or (meta_model if meta_model in CELLS else None)
        if a.tr is not None:
            toks = generate_tr(params, vocab, a.words, a.temperature, a.seed,
                               tr=tuple(a.tr), pack_fmt=pack_fmt,
                               calib_stream=stream, cell=cell,
                               export_path=a.export,
                               export_platforms=platforms, device=device)
        else:
            toks = generate(params, vocab, a.words, a.temperature, a.seed,
                            cell=cell or lstm_lm.infer_cell(params),
                            device=device)
    with open(a.outf, "w") as f:
        for i, t in enumerate(toks):
            word = (corpus.dictionary.idx2word[t]
                    if source == "real" else str(t))
            f.write("\n" if word == "<eos>" else word + " ")
            if (i + 1) % 20 == 0:
                f.write("\n")
    print(f"wrote {a.words} words to {a.outf}")


if __name__ == "__main__":
    main()
