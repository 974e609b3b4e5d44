"""Generic CNN conversion: parameters + conv specs -> TR-quantized model.

Port of ``tq_tpu.convert.cnn``.  Every conv except the stem becomes a TR
layer: its weights term-revealed once along the input-channel axis (the
``tr_quantize`` kernels on the card: the grouped body for g > 1, the
element-wise body for g = 1), its input activations calibrated in two
phases at the global (data_bits, data_terms).  Exempt layers still
quantize their activations, at (16, 1, 16); the stem stays float32 and
unquantized.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tq_tpu_torch.layers.common import TRParams, quantize_weight
from tq_tpu_torch.layers.linear import finalize_quant_state, init_quant_state
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.utils.trace import span

__all__ = ["convert_cnn", "make_cnn_apply", "finalize_cnn", "pack_cnn"]


def convert_cnn(model_mod, params, settings: Sequence[tuple[int, int, int]],
                data_bits: int, data_terms: int, image: int | None = None):
    """Convert a CNN parameter dict, on the device the weights are on.

    ``settings``: per-conv (weight_bits, group_size, weight_terms) in
    ``conv_specs()`` order (see
    :func:`~tq_tpu_torch.convert.policy.static_conv_layer_settings`).
    Returns (qparams, qcfg, qstate); the stem (spec 0) is left untouched
    and absent from qcfg.
    """
    from tq_tpu_torch.profilers.trace_specs import specs_for

    specs = specs_for(model_mod, image)
    if len(settings) != len(specs):
        raise ValueError(f"{len(settings)} settings for {len(specs)} conv "
                         "layers")
    qparams, qcfg, qstate = dict(params), {}, {}
    with span("tq.convert.cnn"):
        for i, (spec, (wb, gs, wt)) in enumerate(zip(specs, settings)):
            if i == 0:
                continue  # the stem is never replaced
            tr = TRParams(weight_bits=wb, group_size=gs, weight_terms=wt,
                          data_bits=data_bits, data_terms=data_terms,
                          quantize_input=True)
            w = params[spec.name]["w"]
            w_q, w_sf = quantize_weight(w, tr, axis=2)
            qparams[spec.name] = {**params[spec.name], "w": w_q,
                                  "w_sf": w_sf}
            qcfg[spec.name] = tr
            qstate[spec.name] = init_quant_state(device=w.device)
    return qparams, qcfg, qstate


def _cast(tree, dtype):
    """Every float32 tensor of one or more dimensions as ``dtype``; 0-d
    scales (``w_sf``) stay float32."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if (isinstance(tree, torch.Tensor) and tree.dtype == torch.float32
            and tree.ndim >= 1):
        return tree.to(dtype)
    return tree


def make_cnn_apply(model_mod, qcfg, track: bool, compute_dtype=None,
                   count_reduce=None, context=QuantCtx):
    """Two-phase forward: ``f(qparams, qstate, x) -> (logits, new_qstate)``.

    ``track`` picks calibration vs quantized eval.  ``compute_dtype=
    torch.bfloat16`` is the serving mode (phase 2): the input batch and
    every float32 parameter of one or more dimensions (weights, BN vectors)
    move as bfloat16, and so does every conv output; the quantization math
    stays float32/int32 inside the kernel.  Default None is the
    reference's float32 fake-quant structure (the parity path).
    ``count_reduce``: see :class:`~tq_tpu_torch.layers.qctx.QuantCtx`
    (calibration on a batch split over 'data').  ``context``: the
    QuantCtx class or factory (the tensor-parallel one of
    :func:`~tq_tpu_torch.parallel.tp.make_tp_cnn_apply`).
    """

    def forward(qparams, qstate, x):
        with span("tq.cnn.forward"):
            if compute_dtype is not None and not track:
                qparams = _cast(qparams, compute_dtype)
                x = x.to(compute_dtype)
            ctx = context(cfg=qcfg, state=qstate, track=track,
                          compute_dtype=compute_dtype,
                          count_reduce=count_reduce)
            logits = model_mod.apply(qparams, x, ctx)
            return logits, {**qstate, **ctx.out_state}

    return forward


def pack_cnn(qparams, qcfg):
    """Serving transform: converted conv weights of <= 7-bit grids become
    int8 (the exact int8 conv runs when ``data_bits <= 7`` too), of <= 15
    bits int16 (dequantized on the fly); 16-bit exempt layers stay float32.
    The overflow checks of the whole model are fetched in one device-to-host
    copy."""
    from tq_tpu_torch.kernels.term_matmul import flush_pack_checks
    from tq_tpu_torch.layers.conv import pack_conv_weights

    out = dict(qparams)
    checks: list = []
    for name, tr in qcfg.items():
        if tr.weight_bits > 15:
            continue
        out[name] = pack_conv_weights(qparams[name], tr, checks=checks)
    flush_pack_checks(checks)
    return out


def finalize_cnn(qstate, qcfg):
    """Histogram -> MSE scale search for every converted layer."""
    return {name: finalize_quant_state(qstate[name], qcfg[name].data_bits,
                                       qcfg[name].data_terms)
            for name in qstate}
