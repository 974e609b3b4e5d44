"""TR LSTM: multi-layer recurrent stack with term-revealed weights.

Port of ``tq_tpu.layers.lstm``.  As there:

  * only *layer 0*'s ``w_ih``/``w_hh`` are term-revealed by default (the
    reference never touches the later layers); ``quantize_layers`` picks
    others;
  * each weight gets its own scale;
  * ONE shared activation quantizer handles the embedding sequence and
    the incoming hidden tensors (h and c) per forward chunk: quantized
    once per chunk, not per timestep;
  * gates follow the torch convention (i, f, g, o), weights are stored
    (in, G*H) and the four gate products are one (B, in) @ (in, 4H)
    product.

The time loop is a Python loop over t; the input projection is hoisted
out of it, one (T*B, in) @ (in, G*H) product per layer.  Parameters are a
list of dicts of tensors, one per layer, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from tq_tpu_torch.kernels.term_matmul import (
    PackedWeight8,
    pack_weight_int,
    pack_weight_u8s,
    term_matmul,
)
from tq_tpu_torch.layers.common import TRParams, quantize_weight
from tq_tpu_torch.layers.quantize import act_quantize, histogram_update

__all__ = ["lstm_init", "lstm_apply", "rnn_init", "rnn_apply",
           "tr_lstm_convert", "tr_lstm_apply", "tr_lstm_pack", "GATE_MULT"]

# Gate-matrix width multiplier per recurrent cell type (the reference's
# RNNModel: nn.LSTM / nn.GRU / nn.RNN with tanh or relu).
GATE_MULT = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def rnn_init(generator: torch.Generator, input_size: int, hidden: int,
             num_layers: int, cell: str = "LSTM", device=None):
    """Uniform(-1/sqrt(H), 1/sqrt(H)) init, as torch's recurrent modules,
    any cell type; per layer w_ih, w_hh, b_ih, b_hh in that order."""
    G = GATE_MULT[cell]
    k = 1.0 / math.sqrt(hidden)

    def uniform(*shape):
        u = torch.rand(*shape, generator=generator)
        return ((2 * u - 1) * k).to(device)

    layers = []
    for i in range(num_layers):
        in_sz = input_size if i == 0 else hidden
        layers.append({"w_ih": uniform(in_sz, G * hidden),
                       "w_hh": uniform(hidden, G * hidden),
                       "b_ih": uniform(G * hidden),
                       "b_hh": uniform(G * hidden)})
    return layers


def lstm_init(generator: torch.Generator, input_size: int, hidden: int,
              num_layers: int, device=None):
    return rnn_init(generator, input_size, hidden, num_layers, "LSTM", device)


def _proj(x2: torch.Tensor, w, w_sf=None) -> torch.Tensor:
    """``x2 @ w`` for any serving weight layout.

    float32 weights multiply directly.  int8/int16, bfloat16-stored and
    :class:`PackedWeight8` weights stream narrow through ``term_matmul``'s
    raw-input mode (``quantize_x=False``) and are widened or decoded
    inside the kernel, ``w_sf`` in its epilogue.
    """
    packed8 = isinstance(w, PackedWeight8)
    if packed8 or not w.dtype.is_floating_point or w.dtype == torch.bfloat16:
        is_int = not packed8 and not w.dtype.is_floating_point
        return term_matmul(x2, w, 1.0, quantize_x=False,
                           w_sf=w_sf if (w_sf is not None and is_int)
                           else None)
    return torch.matmul(x2, w)


def _cell_scan(layer_params, x_seq: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor | None = None, cell: str = "LSTM"):
    """One recurrent layer over the full sequence: (T, B, in) -> (T, B, H).

    Torch gate conventions per cell: LSTM (i, f, g, o); GRU (r, z, n) with
    the n-gate's recurrent bias inside the reset product
    (``n = tanh(gi_n + r * (h @ W_hn + b_hn))``); vanilla RNN
    ``h' = act(x @ W_ih + h @ W_hh + b)``.  ``c0`` is LSTM-only.
    Returns (out, h_T, c_T or None).
    """
    w_ih, w_hh = layer_params["w_ih"], layer_params["w_hh"]
    H = h0.shape[-1]
    T, B = x_seq.shape[0], x_seq.shape[1]
    G = GATE_MULT[cell]
    # The input projection for every step at once; b_ih folds in for every
    # cell (it never meets the reset gate).
    xw_seq = (_proj(x_seq.reshape(T * B, -1), w_ih,
                    layer_params.get("w_ih_sf")).reshape(T, B, G * H)
              + layer_params["b_ih"])
    w_hh_sf = layer_params.get("w_hh_sf")
    b_hh = layer_params["b_hh"]
    outs = []
    h, c = h0, c0
    for t in range(T):
        xw_t = xw_seq[t]
        if cell == "LSTM":
            gates = xw_t + _proj(h, w_hh, w_hh_sf) + b_hh
            i, f, g, o = (gates[:, :H], gates[:, H:2 * H],
                          gates[:, 2 * H:3 * H], gates[:, 3 * H:])
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif cell == "GRU":
            gh = _proj(h, w_hh, w_hh_sf) + b_hh
            r = torch.sigmoid(xw_t[:, :H] + gh[:, :H])
            z = torch.sigmoid(xw_t[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(xw_t[:, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
        else:
            pre = xw_t + _proj(h, w_hh, w_hh_sf) + b_hh
            h = torch.tanh(pre) if cell == "RNN_TANH" else torch.relu(pre)
        outs.append(h)
    return torch.stack(outs), h, (c if cell == "LSTM" else None)


def rnn_apply(params, x_seq: torch.Tensor, hidden, cell: str = "LSTM"):
    """Multi-layer recurrent stack.  ``hidden`` = (h, c) each (L, B, H)
    for LSTM (torch convention), a single (L, B, H) tensor otherwise."""
    out = x_seq
    if cell == "LSTM":
        h0, c0 = hidden
        hs, cs = [], []
        for i, layer in enumerate(params):
            out, hT, cT = _cell_scan(layer, out, h0[i], c0[i])
            hs.append(hT)
            cs.append(cT)
        return out, (torch.stack(hs), torch.stack(cs))
    hs = []
    for i, layer in enumerate(params):
        out, hT, _ = _cell_scan(layer, out, hidden[i], cell=cell)
        hs.append(hT)
    return out, torch.stack(hs)


def lstm_apply(params, x_seq: torch.Tensor, hidden):
    """Multi-layer LSTM.  ``hidden`` = (h, c) each (L, B, H)."""
    return rnn_apply(params, x_seq, hidden, "LSTM")


def tr_lstm_convert(params, tr: TRParams,
                    quantize_layers: Sequence[int] = (0,)):
    """Term-reveal selected layers' input and recurrent weights, grouped
    along the input-feature axis (axis 0 of the (in, G*H) layout)."""
    out = []
    for i, layer in enumerate(params):
        layer = dict(layer)
        if i in quantize_layers:
            for key in ("w_ih", "w_hh"):
                layer[key], layer[key + "_sf"] = quantize_weight(
                    layer[key], tr, axis=0)
        out.append(layer)
    return out


def tr_lstm_pack(qp_rnn, tr: TRParams, fmt: str = "u8s",
                 unquantized_dtype: torch.dtype | None = None,
                 checks: list | None = None):
    """Serving transform: pack the recurrent weights for streaming.

    Quantized layers (those carrying ``w_*_sf``) pack to the 9-bit
    :class:`PackedWeight8` (``fmt='u8s'``, 8-bit grids) or to int8 (<= 7-bit
    grids) / int16 (up to 15); grids past 15 bits stay float32.
    ``unquantized_dtype=torch.bfloat16`` also casts the layers the
    reference leaves untouched.  ``_proj`` streams every such format
    through ``term_matmul``'s raw-input mode.
    """
    out = []
    for layer in qp_rnn:
        layer = dict(layer)
        if "w_ih_sf" in layer:  # a quantized layer
            for key in ("w_ih", "w_hh"):
                sf = layer[key + "_sf"]
                if fmt == "u8s" and tr.weight_bits <= 8:
                    wp = pack_weight_u8s(layer[key], sf, tr.weight_bits,
                                         checks=checks)
                    layer[key], layer[key + "_sf"] = wp, wp.w_sf
                elif tr.weight_bits <= 15:
                    layer[key], layer[key + "_sf"] = pack_weight_int(
                        layer[key], sf, tr.weight_bits, checks=checks)
        elif unquantized_dtype is not None:
            for key in ("w_ih", "w_hh"):
                layer[key] = layer[key].to(unquantized_dtype)
        out.append(layer)
    return out


def tr_lstm_apply(qp, tr: TRParams, qs, x_seq: torch.Tensor, hidden,
                  track: bool, cell: str = "LSTM"):
    """Two-phase forward with one shared quantizer for the embedding
    sequence and every hidden tensor (h and c for LSTM, h alone
    otherwise), histogram order emb, then h, then c; applied once per
    chunk.  Returns (out, new_hidden, new_qs)."""
    parts = (x_seq, *hidden) if cell == "LSTM" else (x_seq, hidden)
    if track:
        hist = qs["hist"]
        for t in parts:
            hist = histogram_update(hist, t)
        qs = {**qs, "hist": hist}
    elif tr.quantize_input:
        parts = tuple(act_quantize(t, qs["sf"], tr.data_bits, tr.data_terms)
                      for t in parts)
    hidden_q = parts[1:] if cell == "LSTM" else parts[1]
    out, new_hidden = rnn_apply(qp, parts[0], hidden_q, cell)
    return out, new_hidden, qs
