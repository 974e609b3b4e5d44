"""The control's precision: TF32, one step below float32 with TF32 off."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``).  A product of two such
    values is exact in float32, so a float32 product of rounded operands
    is what the tensor cores compute in TF32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def operand(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """A product's operand in the run's precision."""
    return round_tf32(x) if tf32 else x
