"""Word-level LSTM language model: embedding encoder -> n-layer LSTM ->
tied-weight decoder -> log-softmax.

Port of ``tq_tpu.models.lstm_lm`` (eval-mode forward; the train-mode
forward is ``evals/train_lstm.py``'s).  Parameters are a dict
``{'encoder': {'w': (vocab, emsize)}, 'rnn': [layer dicts],
'decoder': {'b': (vocab,)}}`` of tensors, as in the JAX package; a tied
decoder has no 'w' leaf and uses ``encoder.w.T``.

TR conversion:
  * the LSTM gets layer-0 ``w_ih``/``w_hh`` term-revealed
    (``quantize_layers`` picks others), plus ONE shared activation
    quantizer applied to the embedding sequence and both incoming hidden
    tensors once per chunk;
  * the decoder gets its weight term-revealed; its input quantizer exists
    but the reference forward drops the quantized activations
    (``quantize_decoder_input=False`` reproduces that, True gives the
    fixed behaviour).
"""

from __future__ import annotations

import torch

from tq_tpu_torch.kernels.term_matmul import flush_pack_checks
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.linear import (
    finalize_quant_state,
    init_quant_state,
    pack_dense_weights,
    tr_dense_apply,
    tr_dense_convert,
)
from tq_tpu_torch.layers.lstm import (
    rnn_apply,
    rnn_init,
    tr_lstm_apply,
    tr_lstm_convert,
    tr_lstm_pack,
)
from tq_tpu_torch.utils.graphs import STEP_GRAPHS
from tq_tpu_torch.utils.trace import span

VOCAB = 33278  # wikitext-2 word vocabulary
EMSIZE = 650
NHID = 650
NLAYERS = 2

__all__ = ["init", "apply", "init_hidden", "infer_cell", "convert", "pack",
           "make_quantized_apply", "quantized_step", "finalize", "VOCAB",
           "EMSIZE", "NHID", "NLAYERS"]


def init(generator: torch.Generator, vocab: int = VOCAB, emsize: int = EMSIZE,
         nhid: int = NHID, nlayers: int = NLAYERS, tied: bool = True,
         cell: str = "LSTM", device=None):
    """Uniform(-0.1, 0.1) encoder (and untied decoder) weights, torch's
    default for the recurrent weights, a zero decoder bias.  ``cell``:
    LSTM / GRU / RNN_TANH / RNN_RELU."""

    def uniform(*shape):
        return ((2 * torch.rand(*shape, generator=generator) - 1) * 0.1).to(
            device)

    params = {"encoder": {"w": uniform(vocab, emsize)},
              "rnn": rnn_init(generator, emsize, nhid, nlayers, cell, device),
              "decoder": {"b": torch.zeros(vocab, device=device)}}
    if not tied:
        params["decoder"]["w"] = uniform(nhid, vocab)
    return params


def _decoder_weight(params) -> torch.Tensor:
    dec = params["decoder"]
    if "w" not in dec:
        return params["encoder"]["w"].T  # (nhid, vocab): tied
    return dec["w"]


def init_hidden(batch: int, nhid: int = NHID, nlayers: int = NLAYERS,
                cell: str = "LSTM", device=None):
    """(h, c) for LSTM, a single h tensor otherwise, each (L, B, H)."""
    z = torch.zeros((nlayers, batch, nhid), dtype=torch.float32,
                    device=device)
    return (z, z) if cell == "LSTM" else z


def infer_cell(params, nonlinearity: str = "tanh") -> str:
    """The cell family from the gate-matrix width (w_hh is (H, G*H); G = 4
    LSTM, 3 GRU, 1 vanilla); ``nonlinearity`` breaks the tanh/relu tie."""
    w_hh = params["rnn"][0]["w_hh"]
    G = w_hh.shape[1] // w_hh.shape[0]
    return {4: "LSTM", 3: "GRU"}.get(
        G, "RNN_RELU" if nonlinearity == "relu" else "RNN_TANH")


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["encoder"]["w"][tokens.long()]  # (T, B, emsize)


def apply(params, tokens: torch.Tensor, hidden, cell: str = "LSTM"):
    """fp32 forward: (T, B) int tokens -> ((T*B, vocab) log-probs,
    hidden)."""
    out, hidden = rnn_apply(params["rnn"], _embed(params, tokens), hidden,
                            cell)
    T, B, H = out.shape
    logits = (torch.matmul(out.reshape(T * B, H), _decoder_weight(params))
              + params["decoder"]["b"])
    return torch.log_softmax(logits, dim=-1), hidden


def convert(params, wb: int, gs: int, wt: int, db: int, dt: int,
            quantize_layers=(0,), quantize_decoder_input: bool = False,
            cell: str = "LSTM"):
    """TR-convert the LSTM and the decoder at the same (wb, gs, wt).

    Returns (qparams, qcfg, qstate), qcfg and qstate keyed 'rnn' and
    'decoder'.  A tied decoder gets its own quantized weight copy.
    """
    tr_rnn = TRParams(wb, gs, wt, db, dt, quantize_input=True)
    tr_dec = TRParams(wb, gs, wt, db, dt,
                      quantize_input=quantize_decoder_input)
    qparams = dict(params)
    qparams["rnn"] = tr_lstm_convert(params["rnn"], tr_rnn, quantize_layers)
    dec = {"w": _decoder_weight(params), "b": params["decoder"]["b"]}
    qparams["decoder"] = tr_dense_convert(dec, tr_dec)
    device = dec["w"].device
    qcfg = {"rnn": tr_rnn, "decoder": tr_dec, "cell": cell}
    qstate = {"rnn": init_quant_state(device=device),
              "decoder": init_quant_state(device=device)}
    return qparams, qcfg, qstate


def pack(qparams, qcfg, fmt: str = "int", rnn: bool | None = None,
         rnn_unquantized_dtype: torch.dtype | None = None):
    """Serving transform: pack the term-revealed weights into narrow
    formats.

    The decoder packs to int8 (<= 7-bit grids) / int16 (up to 15) with
    ``fmt='int'``, or to the 9-bit pack with ``fmt='u8s'`` (8-bit grids; a
    wider grid falls back to 'int').  ``rnn`` also packs the quantized
    recurrent layers (:func:`~tq_tpu_torch.layers.lstm.tr_lstm_pack`);
    default: True for 'u8s', False for 'int'.  Every overflow check is
    fetched in one device-to-host copy for the whole model.
    """
    out = dict(qparams)
    checks: list = []
    dec_fmt = fmt
    if fmt == "u8s" and qcfg["decoder"].weight_bits > 8:
        dec_fmt = "int"
    if dec_fmt == "u8s" or qcfg["decoder"].weight_bits <= 15:
        out["decoder"] = pack_dense_weights(qparams["decoder"],
                                            qcfg["decoder"], fmt=dec_fmt,
                                            checks=checks)
    if rnn is None:
        rnn = fmt == "u8s"
    if rnn:
        out["rnn"] = tr_lstm_pack(qparams["rnn"], qcfg["rnn"], fmt=fmt,
                                  unquantized_dtype=rnn_unquantized_dtype,
                                  checks=checks)
    flush_pack_checks(checks)
    return out


def quantized_step(qparams, qcfg, qstate, tokens, hidden, track: bool):
    """One eager step of a converted model: (logp, hidden, new_qstate)."""
    cell = qcfg.get("cell", "LSTM")
    out, hidden, qs_rnn = tr_lstm_apply(
        qparams["rnn"], qcfg["rnn"], qstate["rnn"], _embed(qparams, tokens),
        hidden, track, cell)
    T, B, H = out.shape
    logits, qs_dec = tr_dense_apply(
        qparams["decoder"], qcfg["decoder"], qstate["decoder"],
        out.reshape(T * B, H), track)
    new_state = {"rnn": qs_rnn, "decoder": qs_dec}
    return torch.log_softmax(logits, dim=-1), hidden, new_state


def make_quantized_apply(qcfg, track: bool):
    """f(qparams, qstate, tokens, hidden) -> (logp, hidden, new_qstate).

    Without tracking the step (:func:`quantized_step`) runs through one
    CUDA graph a served model and input shape
    (``utils/graphs.py::STEP_GRAPHS``), captured on its first call and
    replayed on every later one, by any ``forward`` of any request,
    wherever a graph engages: inputs on the card, none requiring grad, no
    capture running, nothing tracing.  Elsewhere, and when tracking, it
    runs eagerly.  ``new_qstate`` holds ``qstate``'s own quantizer states
    when not tracking."""
    cell = qcfg.get("cell", "LSTM")

    def forward(qparams, qstate, tokens, hidden):
        with span("tq.lstm.step"):
            if track:
                return STEP_GRAPHS.eager("track", quantized_step, qparams,
                                         qcfg, qstate, tokens, hidden, True,
                                         step="lstm.step")
            logp, hidden = STEP_GRAPHS.call(
                lambda tok, hid: quantized_step(qparams, qcfg, qstate, tok,
                                                hid, False)[:2],
                (tokens, hidden), (qparams, qstate),
                (qcfg["rnn"], qcfg["decoder"], cell), step="lstm.step")
            return logp, hidden, {"rnn": qstate["rnn"],
                                  "decoder": qstate["decoder"]}

    return forward


def finalize(qstate, qcfg):
    """Run the MSE scale search for each quantizer."""
    return {name: finalize_quant_state(qstate[name], qcfg[name].data_bits,
                                       qcfg[name].data_terms)
            for name in qstate}
