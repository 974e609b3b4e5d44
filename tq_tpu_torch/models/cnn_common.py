"""Shared pieces of the CNN models (NHWC activations, HWIO conv weights).

Port of ``tq_tpu.models.cnn_common``.  A model module exposes
``init(generator)`` (a dict of parameter dicts keyed by the torchvision
module names, so torch checkpoints import mechanically),
``apply(params, x, ctx)`` (logits; ``ctx`` is a
:class:`~tq_tpu_torch.layers.qctx.QuantCtx` or None for plain fp32) and
``conv_specs(image)`` (the ordered :class:`ConvSpec` list the conversion
policy and the term-MAC counter read).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ConvSpec", "batch_norm", "conv_init", "dense_init", "bn_init",
           "conv_out"]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one conv layer instance in a model."""

    name: str
    in_ch: int
    out_ch: int
    kh: int
    kw: int
    stride: int = 1
    groups: int = 1
    out_h: int = 0
    out_w: int = 0
    is_se: bool = False  # squeeze-excite 1x1s ('se' in torch module name)

    @property
    def out_elems(self) -> int:
        return self.out_ch * self.out_h * self.out_w


def conv_out(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def batch_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN over the channel axis of NHWC ``x``, in the JAX
    package's order of operations: ``(x - mean) * rsqrt(var + eps) * scale
    + bias`` (``F.batch_norm`` folds the terms in another order)."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["scale"] + p["bias"]


def conv_init(generator: torch.Generator, kh: int, kw: int, in_ch: int,
              out_ch: int, groups: int = 1, bias: bool = False,
              device=None):
    """Kaiming-normal (fan-out) HWIO conv parameters, as torchvision
    initializes its ResNets."""
    fan_out = kh * kw * out_ch // groups
    w = torch.randn(kh, kw, in_ch // groups, out_ch, generator=generator,
                    device=generator.device) * math.sqrt(2.0 / fan_out)
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros(out_ch, device=device)
    return p


def dense_init(generator: torch.Generator, fan_in: int, fan_out: int,
               device=None):
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight (in, out) and bias."""
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(*shape):
        u = torch.rand(*shape, generator=generator, device=generator.device)
        return ((2 * u - 1) * bound).to(device)

    return {"w": uniform(fan_in, fan_out), "b": uniform(fan_out)}


def bn_init(ch: int, device=None):
    return {"scale": torch.ones(ch, device=device),
            "bias": torch.zeros(ch, device=device),
            "mean": torch.zeros(ch, device=device),
            "var": torch.ones(ch, device=device)}
