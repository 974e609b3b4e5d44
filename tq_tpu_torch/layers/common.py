"""Shared TR layer configuration and weight-side quantization.

Port of ``tq_tpu.layers.common``.  Every TR layer computes a per-tensor
weight scale ``w_sf = max|w| / 2**(weight_bits - 1)`` and term-reveals its
weights once, at conversion.
"""

from __future__ import annotations

import dataclasses

import torch

from tq_tpu_torch.kernels.tr_quantize import tr_quantize

__all__ = ["TRParams", "EXEMPT", "weight_scale", "quantize_weight", "dropout"]


@dataclasses.dataclass(frozen=True)
class TRParams:
    """Quantization settings for one layer: (weight_bits, group_size,
    weight_terms) for the weights, (data_bits, data_terms) for the
    activations.

    ``quantize_input=False`` reproduces the reference ``TRLinearLayer``,
    which computes the quantized activations and then multiplies the raw
    ones.
    """

    weight_bits: int = 8
    group_size: int = 1
    weight_terms: int = 8
    data_bits: int = 8
    data_terms: int = 4
    quantize_input: bool = True

    @property
    def alpha(self) -> float:
        return self.weight_terms / self.group_size


# Exempt layers (first conv, depthwise, squeeze-excite): 16 bits, no
# grouping, 16 terms == effectively unquantized.
EXEMPT = (16, 1, 16)


def weight_scale(w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """``w_sf = max|w| / 2**(weight_bits - 1)``, a float32 0-d tensor on
    ``w``'s device."""
    return w.abs().max() / (2 ** (weight_bits - 1))


def quantize_weight(w: torch.Tensor, tr: TRParams, axis: int):
    """Term-reveal a weight tensor along its input-channel axis.

    Returns ``(w_q, w_sf)``.  On a CUDA tensor this is one launch of the
    ``tr_quantize`` kernel (element-wise body at ``group_size == 1``,
    grouped body otherwise); on a CPU tensor its plain version.
    """
    w_sf = weight_scale(w, tr.weight_bits)
    w_q = tr_quantize(w, w_sf, tr.weight_bits, tr.group_size, tr.weight_terms,
                      axis=axis)
    return w_q, w_sf


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Train-mode dropout: each element kept with probability
    ``1 - rate`` (a mask drawn from ``generator``, which lives on ``x``'s
    device) and scaled by ``1 / (1 - rate)``; ``rate == 0`` returns ``x``
    itself and draws nothing."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep
