"""TR dense layer: weight term-revealing + two-phase input quantization.

Port of ``tq_tpu.layers.linear``.  Weights are stored (in_features,
out_features), as in the JAX package, with the term-reveal grouping on the
input-feature axis (axis 0).  ``TRParams.quantize_input`` picks whether
the quantized or the raw activations feed the matmul; the reference layer
multiplies the raw ones, so reference-parity sweeps set it to False.

A converted layer is a dict ``{'w', 'b', 'w_sf'}`` of tensors and its
quantizer state a dict ``{'hist', 'sf'}``, as in the JAX package, so the
two compare leaf by leaf.
"""

from __future__ import annotations

import torch

from tq_tpu_torch.kernels.term_matmul import term_matmul
from tq_tpu_torch.layers.common import TRParams, quantize_weight
from tq_tpu_torch.layers.quantize import (
    CalibConfig,
    act_quantize,
    histogram_update,
    init_histogram,
    mse_search_scale,
)

__all__ = [
    "tr_dense_convert",
    "tr_dense_apply",
    "pack_dense_weights",
    "init_quant_state",
    "finalize_quant_state",
]


def init_quant_state(cfg: CalibConfig = CalibConfig(), device=None):
    """Per-quantizer state: calibration histogram + resolved scale."""
    return {"hist": init_histogram(cfg, device),
            "sf": torch.tensor(1.0, dtype=torch.float32, device=device)}


def finalize_quant_state(qs, data_bits: int, data_terms: int,
                         cfg: CalibConfig = CalibConfig()):
    """Histogram -> MSE-searched scale (the reference's ``finish_tracking``)."""
    return {"hist": qs["hist"],
            "sf": mse_search_scale(qs["hist"], data_bits, data_terms, cfg)}


def tr_dense_convert(params, tr: TRParams):
    """Quantize a dense layer's weights once.

    ``params``: {'w': (in, out), 'b': (out,) or None}.
    Returns params with term-revealed 'w' plus 'w_sf'.
    """
    w_q, w_sf = quantize_weight(params["w"], tr, axis=0)
    return {**params, "w": w_q, "w_sf": w_sf}


def pack_dense_weights(qp, tr: TRParams, fmt: str = "int",
                       checks: list | None = None):
    """Narrow-integer weight packing: not ported yet (ROADMAP A.3)."""
    raise NotImplementedError(
        "pack_dense_weights is not ported yet (ROADMAP A.3, serving slice)")


def tr_dense_apply(qp, tr: TRParams, qs, x: torch.Tensor, track: bool,
                   use_fused: bool | None = None):
    """Forward through a converted dense layer; returns (y, updated_qs).

    track=True  (phase 1): accumulate the input histogram, compute with
                raw inputs.
    track=False (phase 2): fake-quantize the inputs per element with the
                calibrated scale (unless ``tr.quantize_input`` is False,
                reproducing the reference layer), then matmul.  With
                ``use_fused`` (default: a 2-D input on the card) the
                quantize and the matmul are one ``term_matmul`` kernel, so
                the quantized activations never reach device memory.
    """
    w = qp["w"]
    if not w.dtype.is_floating_point:
        raise NotImplementedError(
            "packed integer weights are not ported yet (ROADMAP A.3)")
    if track:
        qs = {**qs, "hist": histogram_update(qs["hist"], x)}
        xq = x
    elif tr.quantize_input:
        if use_fused is None:
            use_fused = x.is_cuda and x.ndim == 2
        if use_fused:
            y = term_matmul(x, w, qs["sf"], tr.data_bits, tr.data_terms)
            if qp.get("b") is not None:
                y = y + qp["b"]
            return y, qs
        xq = act_quantize(x, qs["sf"], tr.data_bits, tr.data_terms)
    else:
        xq = x
    y = torch.matmul(xq, w)
    if qp.get("b") is not None:
        y = y + qp["b"]
    return y, qs
