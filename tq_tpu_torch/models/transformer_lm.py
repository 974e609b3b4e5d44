"""Transformer language model: embedding * sqrt(d) -> sinusoidal positional
encoding -> N post-LN encoder layers (causal self-attention, ReLU
feed-forward) -> linear decoder -> log-softmax.

Port of ``tq_tpu.models.transformer_lm``: the eval and train-mode
forwards, and the tensor-parallel serving forward
(:func:`make_tp_quantized_apply`).
Parameters are a flat dict keyed by the torch module names, as in the JAX
package (``transformer_encoder.layers.{i}.self_attn.in_proj``, ...), dense
weights stored (in, out), activations laid out (T, B, d).

TR conversion converts every ``nn.Linear`` of the reference model: the
attention ``out_proj``, the two feed-forward linears of each layer and the
decoder.  ``in_proj`` (a raw Parameter there), the attention, the layer
norms and the softmax stay plain float32 tensor code, as they stay outside
any Pallas kernel in the JAX package.  Every converted linear goes through
:func:`~tq_tpu_torch.layers.linear.tr_dense_apply`: a plain product on the
trunk's (T, B, d) inputs, the weight-streaming ``term_matmul`` kernel for
packed weights at one token (:func:`decode_step`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tq_tpu_torch.kernels.term_matmul import flush_pack_checks
from tq_tpu_torch.layers.common import TRParams, dropout as _dropout
from tq_tpu_torch.layers.linear import (
    finalize_quant_state,
    init_quant_state,
    pack_dense_weights,
    tr_dense_apply,
    tr_dense_convert,
)

VOCAB = 33278  # wikitext-2 word vocabulary
EMSIZE = 650
NHEAD = 2
NHID = 650
NLAYERS = 2

__all__ = ["init", "apply", "apply_train", "convert", "decode_init_cache",
           "decode_step", "make_quantized_apply", "make_tp_quantized_apply",
           "tp_param_specs", "finalize", "pack", "VOCAB", "EMSIZE", "NHEAD",
           "NHID", "NLAYERS"]


def _layer_names(nlayers: int):
    for i in range(nlayers):
        yield i, f"transformer_encoder.layers.{i}"


def _nlayers(params) -> int:
    return sum(1 for k in params if k.endswith(".linear1"))


def init(generator: torch.Generator, vocab: int = VOCAB, emsize: int = EMSIZE,
         nhead: int = NHEAD, nhid: int = NHID, nlayers: int = NLAYERS,
         device=None):
    """The JAX package's distributions: encoder U(-0.1, 0.1), every dense
    weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), layer norms at
    scale 1, bias 0.  ``nhead`` does not shape a parameter."""
    del nhead

    def uniform(shape, bound):
        u = torch.rand(*shape, generator=generator)
        return ((2 * u - 1) * bound).to(device)

    def dense(fi, fo):
        bound = 1.0 / math.sqrt(fi)
        return {"w": uniform((fi, fo), bound), "b": uniform((fo,), bound)}

    def norm():
        return {"scale": torch.ones(emsize, device=device),
                "bias": torch.zeros(emsize, device=device)}

    params = {"encoder": {"w": uniform((vocab, emsize), 0.1)}}
    for _, pre in _layer_names(nlayers):
        params[f"{pre}.self_attn.in_proj"] = dense(emsize, 3 * emsize)
        params[f"{pre}.self_attn.out_proj"] = dense(emsize, emsize)
        params[f"{pre}.linear1"] = dense(emsize, nhid)
        params[f"{pre}.linear2"] = dense(nhid, emsize)
        params[f"{pre}.norm1"] = norm()
        params[f"{pre}.norm2"] = norm()
    params["decoder"] = dense(emsize, vocab)
    return params


def _layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis with the population variance (``jnp.var``)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


@functools.lru_cache(maxsize=16)
def _pe_table(T: int, d: int) -> np.ndarray:
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((T, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    pe.setflags(write=False)
    return pe


def _positional_encoding(T: int, d: int, device=None) -> torch.Tensor:
    """(T, d) sinusoidal table, built in numpy float32 by the JAX
    package's formula."""
    return torch.tensor(_pe_table(T, d), device=device)


def _heads(t: torch.Tensor, nhead: int) -> torch.Tensor:
    """(T, B, d) -> (B, nhead, T, hd)."""
    T, B, d = t.shape
    return t.reshape(T, B, nhead, d // nhead).permute(1, 2, 0, 3)


def _attention(params, pre: str, x: torch.Tensor, nhead: int,
               dropout: float = 0.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Causal multi-head self-attention on (T, B, d); masked scores are
    -inf, so they weigh exactly 0 after the softmax.  ``dropout`` (on the
    attention probabilities, torch ``MultiheadAttention``'s site, masks
    from ``generator``) is train-mode only."""
    T, B, d = x.shape
    hd = d // nhead
    proj = params[f"{pre}.self_attn.in_proj"]
    qkv = torch.matmul(x, proj["w"]) + proj["b"]  # (T, B, 3d)
    q, k, v = (_heads(t, nhead) for t in qkv.split(d, dim=-1))
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    scores = torch.where(mask, scores, -torch.inf)
    attn = _dropout(torch.softmax(scores, dim=-1), dropout, generator)
    out = torch.einsum("bhts,bhsd->bhtd", attn, v)
    return out.permute(2, 0, 1, 3).reshape(T, B, d)


def _dense_fn(params, qcfg, qstate, track: bool, new_state: dict | None):
    """``dense(name, x)``: a TR dense layer where ``qcfg`` converts
    ``name`` (its updated state into ``new_state``), else x @ w + b."""

    def dense(name, x):
        p = params[name]
        if qcfg is not None and name in qcfg:
            y, qs = tr_dense_apply(p, qcfg[name], qstate[name], x, track)
            if new_state is not None:
                new_state[name] = qs
            return y
        return torch.matmul(x, p["w"]) + p["b"]

    return dense


def apply(params, tokens: torch.Tensor, nhead: int = NHEAD, qcfg=None,
          qstate=None, track: bool = False, decoder_fn=None):
    """(T, B) tokens -> (T*B, vocab) log-probs.

    With ``qcfg`` the out_proj / linear1 / linear2 / decoder products run
    through TR dense layers and the result is (logp, new_qstate).
    ``decoder_fn`` overrides the decoder product.
    """
    new_state = dict(qstate) if qstate is not None else None
    dense = _dense_fn(params, qcfg, qstate, track, new_state)
    h2 = _trunk(params, tokens, nhead, dense)
    logits = decoder_fn(h2) if decoder_fn is not None else dense("decoder",
                                                                 h2)
    logp = torch.log_softmax(logits, dim=-1)
    if qcfg is not None:
        return logp, new_state
    return logp


def _trunk(params, tokens: torch.Tensor, nhead: int, dense,
           dropout: float = 0.0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Embedding, positional encoding and the encoder layers: (T, B)
    tokens -> (T*B, d).  ``dropout`` (masks from ``generator``) applies
    at torch's sites: after the positional encoding, on the attention
    probabilities, on each sublayer output before its residual add and on
    the feed-forward hidden; at 0 nothing is drawn or changed."""
    d = params["encoder"]["w"].shape[1]
    T, B = tokens.shape

    def drop(x):
        return _dropout(x, dropout, generator)

    h = params["encoder"]["w"][tokens.long()] * math.sqrt(d)
    h = drop(h + _positional_encoding(T, d, h.device)[:, None, :])
    for _, pre in _layer_names(_nlayers(params)):
        a = dense(f"{pre}.self_attn.out_proj",
                  _attention(params, pre, h, nhead, dropout, generator))
        h = _layer_norm(params[f"{pre}.norm1"], h + drop(a))
        f = dense(f"{pre}.linear2",
                  drop(torch.relu(dense(f"{pre}.linear1", h))))
        h = _layer_norm(params[f"{pre}.norm2"], h + drop(f))
    return h.reshape(T * B, d)


def apply_train(params, tokens: torch.Tensor, generator: torch.Generator,
                nhead: int = NHEAD, dropout: float = 0.2) -> torch.Tensor:
    """Train-mode forward: (T, B) tokens -> (T*B, vocab) log-probs with
    dropout at torch's sites (masks from ``generator``, on the tokens'
    device).  Every product is a plain float32 ``torch.matmul``; at
    ``dropout=0`` this computes exactly what :func:`apply` does."""
    dense = _dense_fn(params, None, None, False, None)
    h2 = _trunk(params, tokens, nhead, dense, dropout, generator)
    return torch.log_softmax(dense("decoder", h2), dim=-1)


def decode_init_cache(L: int, batch: int, emsize: int, nhead: int,
                      nlayers: int, device=None):
    """KV cache for incremental decoding: (nlayers, B, nhead, L, hd) key
    and value buffers."""
    shape = (nlayers, batch, nhead, L, emsize // nhead)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def decode_step(params, tok: torch.Tensor, pos, cache, nhead: int = NHEAD,
                qcfg=None, qstate=None):
    """One incremental decoding step: the (1, B) token at position ``pos``
    (an int or a 0-d integer tensor) -> ((B, vocab) log-probs, updated
    cache).

    q/k/v are computed for the new position only and attend against the
    cache, so each dense takes one row per sequence: with packed weights
    the weight-streaming ``term_matmul`` kernel.  Post-LN layers mix
    positions only through the causally masked attention, so the result
    equals the full-prefix :func:`apply` at ``pos``.  The cache is written
    functionally (``index_copy``): the updated cache is a new output, as
    in the JAX package, which keeps an exported step pure.
    """
    enc = params["encoder"]["w"]
    d = enc.shape[1]
    hd = d // nhead
    L = cache["k"].shape[3]
    B = tok.shape[1]
    dense = _dense_fn(params, qcfg, qstate, False, None)
    at = torch.as_tensor(pos, device=enc.device).reshape(1).long()

    pe = _positional_encoding(L, d, enc.device)
    h = enc[tok.long()] * math.sqrt(d) + pe.index_select(0, at)  # (1, B, d)
    live = torch.arange(L, device=enc.device) <= at  # cache beyond pos
    ks, vs = [], []
    for i, pre in _layer_names(_nlayers(params)):
        proj = params[f"{pre}.self_attn.in_proj"]
        qkv = torch.matmul(h, proj["w"]) + proj["b"]  # (1, B, 3d)
        q, k, v = (t.reshape(B, nhead, 1, hd) for t in qkv.split(d, dim=-1))
        ck = cache["k"][i].index_copy(2, at, k)  # (B, nhead, L, hd)
        cv = cache["v"][i].index_copy(2, at, v)
        ks.append(ck)
        vs.append(cv)
        scores = torch.einsum("bhtd,bhsd->bhts", q, ck) / math.sqrt(hd)
        scores = torch.where(live, scores, -torch.inf)
        attn = torch.softmax(scores, dim=-1)
        a = torch.einsum("bhts,bhsd->bhtd", attn, cv).reshape(B, d)
        a = dense(f"{pre}.self_attn.out_proj", a).reshape(1, B, d)
        h = _layer_norm(params[f"{pre}.norm1"], h + a)
        f = dense(f"{pre}.linear2",
                  torch.relu(dense(f"{pre}.linear1", h.reshape(B, d))))
        h = _layer_norm(params[f"{pre}.norm2"], h + f.reshape(1, B, d))
    logits = dense("decoder", h.reshape(B, d))
    return (torch.log_softmax(logits, dim=-1),
            {"k": torch.stack(ks), "v": torch.stack(vs)})


def convert(params, wb: int, gs: int, wt: int, db: int, dt: int,
            quantize_input: bool = False):
    """TR-convert every Linear (decoder, then out_proj, linear1, linear2 of
    each layer).  Returns (qparams, qcfg, qstate), qcfg and qstate keyed by
    the layer names."""
    tr = TRParams(wb, gs, wt, db, dt, quantize_input=quantize_input)
    names = ["decoder"]
    for _, pre in _layer_names(_nlayers(params)):
        names += [f"{pre}.self_attn.out_proj", f"{pre}.linear1",
                  f"{pre}.linear2"]
    device = params["encoder"]["w"].device
    qparams = dict(params)
    qcfg, qstate = {}, {}
    for n in names:
        qparams[n] = tr_dense_convert(params[n], tr)
        qcfg[n] = tr
        qstate[n] = init_quant_state(device=device)
    return qparams, qcfg, qstate


def pack(qparams, qcfg, fmt: str = "int"):
    """Serving transform: pack every converted linear's weights.

    ``fmt='u8s'``: the 9-bit pack of 8-bit grids; a layer of a wider grid
    falls back to 'int' (int8 up to 7 bits, int16 up to 15), and one past
    15 bits stays float32, as in the JAX package.  Every overflow check is
    fetched in one device-to-host copy for the whole model.
    """
    out = dict(qparams)
    checks: list = []
    for name, tr in qcfg.items():
        if fmt == "u8s" and tr.weight_bits > 8:
            if tr.weight_bits <= 15:
                out[name] = pack_dense_weights(qparams[name], tr, fmt="int",
                                               checks=checks)
        elif fmt == "u8s" or tr.weight_bits <= 15:
            out[name] = pack_dense_weights(qparams[name], tr, fmt=fmt,
                                           checks=checks)
    flush_pack_checks(checks)
    return out


def tp_param_specs() -> dict:
    """The specs :func:`make_tp_quantized_apply` serves from: the packed
    decoder's planes split over N on 'model', everything else replicated
    (``shard_pytree(qparams, tp_param_specs(), mesh)``)."""
    return {"decoder": {"w": (None, "model")}}


def make_tp_quantized_apply(qcfg, mesh, nhead: int = NHEAD):
    """Serving forward with the 9-bit packed decoder column-parallel over
    the mesh's 'model' dimension.

    Autoregressive generation re-reads the decoder (emsize -> vocab, the
    dominant weight stream) every token; with its 1.125-bytes-a-weight
    planes split over 'model' each rank streams and decodes 1/n of them
    (:func:`~tq_tpu_torch.parallel.tp.tp_term_matmul_col_packed`), and the
    N-shards of the logits are gathered before the log-softmax.  The
    trunk stays replicated.  ``f(qparams, qstate, tokens) -> (logp,
    qstate)`` takes ``pack(qparams, qcfg, fmt='u8s')`` params sharded by
    :func:`tp_param_specs`; the decoder's TR config picks the quantized
    (bf16 mode) or raw-input branch as ``tr_dense_apply`` does.
    """
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8
    from tq_tpu_torch.parallel._compat import all_gather
    from tq_tpu_torch.parallel.tp import tp_term_matmul_col_packed

    tr = qcfg["decoder"]

    def forward(qparams, qstate, tokens):
        dec = qparams["decoder"]
        if not isinstance(dec["w"], PackedWeight8):
            raise TypeError(
                "make_tp_quantized_apply needs u8s-packed decoder "
                "weights — call pack(qparams, qcfg, fmt='u8s') first")

        def decoder_fn(h2):
            if tr.quantize_input:
                y = tp_term_matmul_col_packed(
                    h2, dec["w"], qstate["decoder"]["sf"], tr.data_bits,
                    tr.data_terms, mesh)
            else:  # raw-input serving (the reference layer's forward)
                # bf16=False: raw activations are not small integers, so
                # the bf16 product would not be exact here.
                y = tp_term_matmul_col_packed(
                    h2, dec["w"], 1.0, tr.data_bits, tr.data_terms, mesh,
                    bf16=False, quantize_x=False)
            return all_gather(y, mesh, "model", axis=1) + dec["b"]

        return apply(qparams, tokens, nhead=nhead, qcfg=qcfg, qstate=qstate,
                     track=False, decoder_fn=decoder_fn)

    return forward


def make_quantized_apply(qcfg, track: bool, nhead: int = NHEAD):
    """f(qparams, qstate, tokens) -> (logp, new_qstate)."""

    def forward(qparams, qstate, tokens):
        return apply(qparams, tokens, nhead=nhead, qcfg=qcfg, qstate=qstate,
                     track=track)

    return forward


def finalize(qstate, qcfg):
    """Run the MSE scale search for each quantizer."""
    return {n: finalize_quant_state(qstate[n], qcfg[n].data_bits,
                                    qcfg[n].data_terms)
            for n in qstate}
