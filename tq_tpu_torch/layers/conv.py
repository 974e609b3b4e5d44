"""TR conv layer: NHWC/HWIO convolution with term-revealed weights.

Port of ``tq_tpu.layers.conv``.  Activations are NHWC and kernels HWIO, as
in the JAX package, and the term-reveal grouping runs along the
input-channel axis (axis 2 of HWIO).  The convolution itself is
``F.conv2d`` (cuDNN on the card) on permuted views: ``x.permute(0, 3, 1,
2)`` of an NHWC-contiguous tensor is already channels_last, and the output
permutes back to NHWC without a copy.  The exact int8 serving conv is an
im2col of the int8 activations and ``torch._int_mm`` (int32 sums).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from tq_tpu_torch.kernels.term_matmul import pack_weight_int
from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int
from tq_tpu_torch.layers.common import TRParams, quantize_weight
from tq_tpu_torch.layers.quantize import act_quantize, histogram_update

__all__ = ["tr_conv_convert", "tr_conv_apply", "pack_conv_weights", "conv2d",
           "int8_conv2d", "int8_conv2d_ref"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one spatial axis: output ceil(size /
    stride), the extra row or column at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride, padding):
    """((lo_h, hi_h), (lo_w, hi_w)) of an NHWC input."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding == "SAME":
            return (_same_pads(x.shape[1], kh, stride[0]),
                    _same_pads(x.shape[2], kw, stride[1]))
        raise ValueError(f"unknown padding {padding!r}")
    (lh, hh), (lw, hw) = padding
    return (int(lh), int(hh)), (int(lw), int(hw))


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1),
           padding="SAME", groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC convolution in ``x``'s dtype.

    ``padding``: 'SAME', 'VALID' or explicit ``[(lo, hi), (lo, hi)]``;
    asymmetric pairs are padded with zeros before the convolution.
    """
    stride = tuple(stride)
    kh, kw = w.shape[0], w.shape[1]
    (lh, hh), (lw, hw) = _pads(x, kh, kw, stride, padding)
    if (lh, lw) != (hh, hw):
        x = F.pad(x, (0, 0, lw, hw, lh, hh))
        lh = lw = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, stride,
                 (lh, lw), 1, groups)
    return y.permute(0, 2, 3, 1)


def _im2col(x: torch.Tensor, kh: int, kw: int, stride, padding):
    """(N*Ho*Wo, kh*kw*C) patches of NHWC ``x`` (zero padding), columns in
    HWIO's (kh, kw, C) order, and the output's (N, Ho, Wo)."""
    stride = tuple(stride)
    (lh, hh), (lw, hw) = _pads(x, kh, kw, stride, padding)
    x = F.pad(x, (0, 0, lw, hw, lh, hh))
    p = x.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    n, ho, wo = p.shape[:3]
    # (N, Ho, Wo, C, kh, kw) -> (N, Ho, Wo, kh, kw, C)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, -1), (n, ho, wo)


def _group_operands(x, w, stride, padding, groups: int):
    """Per group: (patches (M, K), weights (K, C_out / groups)), and the
    output's (N, Ho, Wo)."""
    kh, kw, cin_g, cout = w.shape
    cout_g = cout // groups
    out = []
    for g in range(groups):
        cols, nhw = _im2col(x[..., g * cin_g:(g + 1) * cin_g], kh, kw,
                            stride, padding)
        wg = w[..., g * cout_g:(g + 1) * cout_g].reshape(kh * kw * cin_g,
                                                         cout_g)
        out.append((cols, wg))
    return out, nhw


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a (M, K) @ b (K, N)`` -> int32 through ``torch._int_mm``,
    zero-padded to what it takes on the card (M > 16; K and N multiples of
    8), with ``b`` column-major as the cuBLASLt int8 product takes it."""
    (m, k), n = a.shape, b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return y[:m, :n] if pm or pn else y


def int8_conv2d(x: torch.Tensor, w: torch.Tensor,
                stride: Sequence[int] = (1, 1), padding="SAME",
                groups: int = 1) -> torch.Tensor:
    """Exact int8 NHWC x HWIO -> int32 NHWC convolution: im2col and
    ``torch._int_mm``, whose int32 sums are exact (|sum| < 2**31 for any
    K below 2**17 at int8)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8, got {x.dtype} x {w.dtype}")
    parts, (n, ho, wo) = _group_operands(x, w, stride, padding, groups)
    ys = [_int_mm(cols, wg) for cols, wg in parts]
    y = ys[0] if groups == 1 else torch.cat(ys, dim=1)
    return y.reshape(n, ho, wo, -1)


def int8_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int] = (1, 1), padding="SAME",
                    groups: int = 1) -> torch.Tensor:
    """Plain version of :func:`int8_conv2d`: the same patches multiplied
    in int64 (on the CPU; the card has no int64 product), returned as
    int64."""
    parts, (n, ho, wo) = _group_operands(x, w, stride, padding, groups)
    ys = [torch.matmul(cols.to(torch.int64), wg.to(torch.int64))
          for cols, wg in parts]
    return torch.cat(ys, dim=1).reshape(n, ho, wo, -1)


def tr_conv_convert(params, tr: TRParams):
    """Quantize conv weights once at conversion.

    ``params``: {'w': (kh, kw, in_ch/groups, out_ch), 'b': (out_ch,)|None}.
    """
    w_q, w_sf = quantize_weight(params["w"], tr, axis=2)
    return {**params, "w": w_q, "w_sf": w_sf}


def pack_conv_weights(qp, tr: TRParams, checks: list | None = None):
    """Pack a converted conv layer's weights into narrow integers: int8 for
    <= 7-bit weight grids, int16 up to 15 bits.  :func:`tr_conv_apply`
    recognises packed weights; with ``tr.data_bits <= 7`` too, the conv runs
    int8 x int8 -> int32 (exact) with ``sf * w_sf`` applied to the int32
    output."""
    w_int, w_sf = pack_weight_int(qp["w"], qp["w_sf"], tr.weight_bits,
                                  checks=checks)
    return {**qp, "w": w_int, "w_sf": w_sf}


def tr_conv_apply(qp, tr: TRParams, qs, x: torch.Tensor, track: bool,
                  stride: Sequence[int] = (1, 1), padding="SAME",
                  groups: int = 1, compute_dtype=None, count_reduce=None,
                  x_channels: slice | None = None):
    """Two-phase forward of a converted conv layer; returns (y, qs).

    track=True  (phase 1): accumulate the input histogram, conv the raw
                input in float32.
    track=False (phase 2): fake-quantize the input per element with the
                calibrated scale (the ``tr_quantize`` element-wise kernel
                on the card), then conv.

    ``compute_dtype=torch.bfloat16`` (phase 2 only) quantizes the bfloat16
    input in float32, rounds the quantized values to bfloat16 and runs the
    conv in bfloat16 with bfloat16 output.  Integer-packed weights
    (:func:`pack_conv_weights`) run the exact int8 conv when they are int8
    and ``tr.data_bits <= 7``; otherwise they are dequantized on the fly.

    ``count_reduce``: passed to
    :func:`~tq_tpu_torch.layers.quantize.histogram_update`.
    ``x_channels``: the input channels the conv reads (a rank's groups of
    a grouped conv under tensor parallelism); the histogram and the
    quantization still see the whole of ``x``.
    """
    w = qp["w"]
    w_packed = not w.dtype.is_floating_point
    if (w_packed and w.dtype == torch.int8 and tr.data_bits <= 7
            and not track and tr.quantize_input):
        xi = tr_quantize_int(x, qs["sf"], tr.data_bits,
                             tr.data_terms).to(torch.int8)
        if x_channels is not None:
            xi = xi[..., x_channels]
        y = int8_conv2d(xi, w, stride, padding, groups)
        y = y.to(torch.float32) * (qs["sf"] * qp["w_sf"])
        if qp.get("b") is not None:
            y = y + qp["b"]
        if compute_dtype is not None:
            y = y.to(compute_dtype)
        return y, qs
    if w_packed:  # int16 grid or ineligible phase: dequantize on the fly
        w = w.to(torch.float32) * qp["w_sf"]
    if track:
        qs = {**qs, "hist": histogram_update(qs["hist"], x,
                                             count_reduce=count_reduce)}
        xq = x
    elif tr.quantize_input:
        xq = act_quantize(x, qs["sf"], tr.data_bits, tr.data_terms)
    else:
        xq = x
    if x_channels is not None:
        xq = xq[..., x_channels]
    if compute_dtype is not None and not track:
        xq = xq.to(compute_dtype)
        w = w.to(compute_dtype)
    y = conv2d(xq, w, stride, padding, groups)
    if qp.get("b") is not None:
        y = y + qp["b"].to(y.dtype)
    return y, qs
