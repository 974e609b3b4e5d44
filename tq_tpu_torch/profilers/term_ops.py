"""Term-pair-operation efficiency model.

Port of ``tq_tpu.profilers.term_ops``: the counter is a pure function of
layer shapes and TR settings, plus the quantized weights for the
compressed-HESE parameter bits.  Formulas (the reference's published
efficiency numbers):

  conv   macs = out_elems * (in_ch / groups) * kh * kw
         term_ops = min(dt, db) * (wt' / g) * macs, wt' = min(wt, wb) when
         g == 1 else wt; only for in_ch > 3 and groups == 1.
  dense  macs = out_elems * in_features; same term conversion.
  lstm   no term MACs of its own (the reference's count is the decoder's);
         the recurrent cost is :func:`lstm_recurrent_term_macs`.
  param bits
         g == 1: nelement * weight_bits
         g > 1 : (ceil(log2(weight_bits)) + 2) bits per HESE term of
                 trunc(w / w_sf).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.ops.hese import hese_terms_count, transition_merge_terms_np

__all__ = [
    "LayerCost",
    "conv2d_term_macs",
    "dense_term_macs",
    "compressed_hese_bits",
    "dense_param_bits",
    "model_cost",
    "cnn_cost",
    "param_count",
]


def _effective_terms(tr: TRParams) -> tuple[float, float]:
    """(weight_terms', data_terms')."""
    wt = min(tr.weight_terms, tr.weight_bits) if tr.group_size == 1 \
        else tr.weight_terms
    return wt, min(tr.data_terms, tr.data_bits)


def conv2d_term_macs(out_elems: int, in_ch: int, kh: int, kw: int,
                     tr: TRParams, groups: int = 1) -> int:
    """Term-pair ops for one conv layer; 0 for the first conv (in_ch <= 3)
    and grouped convs.  ``out_elems`` is N*H_out*W_out*C_out."""
    if in_ch <= 3 or groups != 1:
        return 0
    macs = out_elems * (in_ch // groups) * kh * kw
    wt, dt = _effective_terms(tr)
    return int(dt * (wt / tr.group_size) * macs)


def dense_term_macs(out_elems: int, in_features: int, tr: TRParams) -> int:
    """Term-pair ops for one dense layer."""
    wt, dt = _effective_terms(tr)
    return int(dt * (wt / tr.group_size) * out_elems * in_features)


def compressed_hese_bits(w, w_sf, weight_terms: int, weight_bits: int,
                         merge_hack: bool = False) -> int:
    """Compressed-HESE storage bits of a term-revealed weight tensor.

    Each term costs ``ceil(log2(weight_bits)) + 2`` bits; the reference
    passes ``weight_bits`` where its signature says ``weight_terms``, so
    ``weight_terms`` is accepted and unused.  ``merge_hack=True`` counts
    terms with the reference's root-level ``hese()`` and its "merging
    neighbors hack" (the published param_bits); False with the sound
    automaton.  ``w / w_sf`` is a float32 division, as in the JAX package.
    """
    per_term = math.ceil(math.log2(weight_bits)) + 2
    w = torch.as_tensor(w, dtype=torch.float32).cpu()
    w_sf = torch.as_tensor(w_sf, dtype=torch.float32).cpu()
    q = torch.trunc(w / w_sf).abs().to(torch.int32)
    if merge_hack:
        nterms = int(np.sum(transition_merge_terms_np(q.numpy())))
    else:
        nterms = int(hese_terms_count(q, weight_bits + 1).sum())
    return per_term * nterms


def dense_param_bits(w, w_sf, tr: TRParams, merge_hack: bool = False) -> int:
    """Weight storage bits for a dense layer."""
    if tr.group_size == 1:
        return int(np.prod(tuple(w.shape))) * tr.weight_bits
    return compressed_hese_bits(w, w_sf, tr.weight_terms, tr.weight_bits,
                                merge_hack=merge_hack)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Shape record for one countable layer of a model."""

    kind: str  # 'dense' | 'conv' | 'lstm'
    name: str
    out_elems: int
    in_features: int  # in_ch for conv
    kh: int = 1
    kw: int = 1
    groups: int = 1
    weight_numel: int = 0  # for g=1 dense param bits without the array


def model_cost(layers: Iterable[tuple[LayerCost, TRParams]],
               weights: Optional[dict] = None,
               scales: Optional[dict] = None,
               merge_hack: bool = False) -> tuple[int, int]:
    """(term_macs, param_bits) over a converted model.

    ``weights``/``scales`` (name -> quantized weight / w_sf) are needed
    only for the compressed-HESE bits of grouped dense layers; conv layers
    contribute no parameter bits and LSTM layers nothing, as in the
    reference counter.
    """
    tmacs = 0
    pbits = 0
    for lc, tr in layers:
        if lc.kind == "conv":
            tmacs += conv2d_term_macs(lc.out_elems, lc.in_features, lc.kh,
                                      lc.kw, tr, lc.groups)
        elif lc.kind == "dense":
            tmacs += dense_term_macs(lc.out_elems, lc.in_features, tr)
            if tr.group_size == 1:
                pbits += lc.weight_numel * tr.weight_bits
            elif weights is not None and lc.name in weights:
                pbits += compressed_hese_bits(
                    weights[lc.name], scales[lc.name], tr.weight_terms,
                    tr.weight_bits, merge_hack=merge_hack)
    return tmacs, pbits


def cnn_cost(specs, settings, data_bits: int,
             data_terms: int) -> tuple[int, float]:
    """(tmacs, avg_terms) of a converted CNN at batch 1: tmacs by the conv
    formula (the stem and grouped convs count zero), ``avg_terms`` the
    mean ``wt / g`` over every conv but the stem (exempt layers
    included)."""
    tmacs = 0
    for spec, (wb, gs, wt) in zip(specs, settings):
        tr = TRParams(wb, gs, wt, data_bits, data_terms)
        tmacs += conv2d_term_macs(spec.out_elems, spec.in_ch, spec.kh,
                                  spec.kw, tr, spec.groups)
    alphas = [wt / gs for (_, gs, wt) in settings[1:]]
    return tmacs, sum(alphas) / len(alphas)


_BUFFER_KEYS = frozenset({"mean", "var", "w_sf", "hist", "sf"})


def param_count(params) -> int:
    """Learnable parameter elements, as torch's ``sum(p.numel() for p in
    model.parameters())``: leaves under a BN running-stat key ('mean',
    'var') or a conversion product ('w_sf', 'hist', 'sf') are buffers and
    do not count."""
    if isinstance(params, dict):
        return sum(param_count(v) for k, v in params.items()
                   if k not in _BUFFER_KEYS)
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    if params is None:
        return 0
    return int(np.prod(tuple(params.shape)))


def lstm_recurrent_term_macs(seq_len: int, batch: int, input_size: int,
                             hidden: int, num_layers: int,
                             tr: TRParams) -> int:
    """True recurrent-path cost (not counted by the reference, whose LSTM
    cost is its decoder's alone; an extension, left out of the package's
    exports as in the JAX package).

    Per step and layer: 4 gates of (in + hidden) @ hidden MACs.
    """
    wt, dt = _effective_terms(tr)
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden
        total += seq_len * batch * 4 * hidden * (in_sz + hidden)
    return int(dt * (wt / tr.group_size) * total)
