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

from tq_tpu_torch.kernels.term_matmul import (
    PackedWeight8,
    pack_weight_int,
    pack_weight_u8s,
    term_matmul,
    unpack_weight_u8s,
)
from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int
from tq_tpu_torch.layers.common import TRParams, quantize_weight
from tq_tpu_torch.layers.quantize import (
    CalibConfig,
    act_quantize,
    histogram_update,
    init_histogram,
    mse_search_scale,
)
from tq_tpu_torch.utils.trace import span

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
    with span("tq.calib.search", device=qs["hist"].is_cuda):
        return {"hist": qs["hist"],
                "sf": mse_search_scale(qs["hist"], data_bits, data_terms,
                                       cfg)}


def tr_dense_convert(params, tr: TRParams):
    """Quantize a dense layer's weights once.

    ``params``: {'w': (in, out), 'b': (out,) or None}.
    Returns params with term-revealed 'w' plus 'w_sf'.
    """
    w_q, w_sf = quantize_weight(params["w"], tr, axis=0)
    return {**params, "w": w_q, "w_sf": w_sf}


def pack_dense_weights(qp, tr: TRParams, fmt: str = "int",
                       checks: list | None = None):
    """Pack a converted dense layer's weights into a narrow format.

    Serving-time transform: the term-revealed float32 weights become int8
    (<= 7-bit weight grids) or int16 (``fmt='int'``), or the 9-bit
    :class:`~tq_tpu_torch.kernels.term_matmul.PackedWeight8` of an 8-bit
    grid (``fmt='u8s'``), 2-4x less weight traffic.  :func:`tr_dense_apply`
    recognises packed weights and folds ``w_sf`` into ``term_matmul``'s
    epilogue.  ``checks``: a shared list for deferred overflow validation.
    """
    out = dict(qp)
    if fmt == "u8s":
        out["w"] = pack_weight_u8s(qp["w"], qp["w_sf"], tr.weight_bits,
                                   checks=checks)
        out["w_sf"] = out["w"].w_sf
    elif fmt == "int":
        out["w"], out["w_sf"] = pack_weight_int(qp["w"], qp["w_sf"],
                                                tr.weight_bits, checks=checks)
    else:
        raise ValueError(f"unknown pack fmt {fmt!r} (want 'int' or 'u8s')")
    return out


def _add_bias(y: torch.Tensor, qp) -> torch.Tensor:
    return y + qp["b"] if qp.get("b") is not None else y


def tr_dense_apply(qp, tr: TRParams, qs, x: torch.Tensor, track: bool,
                   use_fused: bool | None = None, count_reduce=None):
    """Forward through a converted dense layer; returns (y, updated_qs).

    track=True  (phase 1): accumulate the input histogram, compute with
                raw inputs.
    track=False (phase 2): fake-quantize the inputs per element with the
                calibrated scale (unless ``tr.quantize_input`` is False,
                reproducing the reference layer), then matmul.  With
                ``use_fused`` (default: a 2-D input on the card, or packed
                weights, or any 2-D input while ``torch.export`` traces,
                so that a program traced on the CPU is the card's) the
                quantize and the matmul are one
                ``term_matmul`` kernel, so the quantized activations never
                reach device memory.

    Packed weights (:func:`pack_dense_weights`) take the JAX package's
    routes: integer weights at M >= 256 with a wide N go through integer
    activations and a float32 product (exact: both grids fit 8 bits);
    otherwise the fused kernel in its int8 mode (int8 weights, data grid
    <= 7 bits), bf16 mode (8-bit grids) or f32 mode; raw inputs stream the
    packed weights through the kernel's raw-input mode; an n-D input (or
    ``use_fused=False``) decodes the weights outside the kernel.
    ``count_reduce``: passed to
    :func:`~tq_tpu_torch.layers.quantize.histogram_update`.
    """
    w = qp["w"]
    w_packed8 = isinstance(w, PackedWeight8)
    w_packed = w_packed8 or not w.dtype.is_floating_point
    if track:
        qs = {**qs, "hist": histogram_update(qs["hist"], x,
                                             count_reduce=count_reduce)}
        xq = x
    elif tr.quantize_input:
        if (w_packed and not w_packed8 and x.ndim == 2
                and x.shape[0] >= 256
                and tr.weight_bits <= 8
                and tr.data_bits <= 8 and w.shape[1] >= 4 * w.shape[0]
                and use_fused is None):
            # Wide-N integer route (the LSTM decoder, 650 -> 33278, at
            # eval): a plain product outside any kernel.  Exact: quantized
            # magnitudes <= 2^8 and weights of <= 8-bit grids are integers
            # that float32 holds, and the scales fold into the epilogue.
            xi = tr_quantize_int(x, qs["sf"], tr.data_bits, tr.data_terms)
            y = torch.matmul(xi.to(torch.float32), w.to(torch.float32))
            return _add_bias(y * (qs["sf"] * qp["w_sf"]), qp), qs
        if use_fused is None:
            use_fused = (w_packed or x.is_cuda
                         or torch.compiler.is_exporting()) and x.ndim == 2
        if use_fused:
            int8 = bool(not w_packed8 and w.dtype == torch.int8
                        and tr.data_bits <= 7)
            # The bf16 mode is exact whenever both integer grids fit 8 bits
            # (magnitudes <= 256 are bf16-exact).
            bf16 = (not int8 and w_packed
                    and tr.weight_bits <= 8 and tr.data_bits <= 8)
            y = term_matmul(x, w, qs["sf"], tr.data_bits, tr.data_terms,
                            int8=int8, bf16=bf16,
                            w_sf=(qp["w_sf"] if w_packed and not w_packed8
                                  else None))
            return _add_bias(y, qp), qs
        xq = act_quantize(x, qs["sf"], tr.data_bits, tr.data_terms)
    else:
        xq = x
    if (not track and not tr.quantize_input and w_packed and x.ndim == 2
            and use_fused is not False):
        # Raw-input serving with packed weights (the reference layer's
        # quantize_input=False): stream the narrow weights and decode them
        # in the kernel instead of materializing a float32 copy.
        y = term_matmul(x, w, 1.0, tr.data_bits, tr.data_terms,
                        quantize_x=False,
                        w_sf=qp["w_sf"] if not w_packed8 else None)
        return _add_bias(y, qp), qs
    if w_packed8:  # the n-D / non-fused path: decode the 9-bit pack
        w = unpack_weight_u8s(w, k=xq.shape[-1])
    elif w_packed:  # ... or dequantize the integers
        w = w.to(torch.float32) * qp["w_sf"]
    return _add_bias(torch.matmul(xq, w), qp), qs
