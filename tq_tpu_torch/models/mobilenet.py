"""MobileNet-v2 (torchvision's graph), NHWC, functional.

Port of ``tq_tpu.models.mobilenet``.  Inverted residuals with ReLU6 and
no activation after the linear projection.  The depthwise convs
(``groups = hidden``) are the layers the conversion policy exempts and
the term-MAC counter skips; their specs carry ``groups``.  Parameter
names mirror the torchvision module tree (``features.N.conv.M``,
``classifier.1``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tq_tpu_torch.layers.qctx import QuantCtx, fp32_ctx
from tq_tpu_torch.models.cnn_common import (ConvSpec, batch_norm, bn_init,
                                            conv_init, dense_init)

# t (expansion), c (out channels), n (repeats), s (first stride)
_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
NUM_CLASSES = 1000

__all__ = ["init", "apply", "conv_specs", "dense_specs", "NUM_CLASSES"]


def _blocks():
    """Yield (block index, in_ch, out_ch, stride, expansion) in order."""
    idx, in_ch = 1, 32
    for t, c, n, s in _SETTING:
        for i in range(n):
            yield idx, in_ch, c, (s if i == 0 else 1), t
            in_ch = c
            idx += 1


def _block_convs(idx, in_ch, out_ch, stride, t):
    """(name, in, out, k, stride, groups) of one inverted residual's convs,
    each paired with its BN's name."""
    hidden = in_ch * t
    if t == 1:
        return [
            ((f"features.{idx}.conv.0.0", hidden, hidden, 3, stride, hidden),
             f"features.{idx}.conv.0.1"),
            ((f"features.{idx}.conv.1", hidden, out_ch, 1, 1, 1),
             f"features.{idx}.conv.2"),
        ]
    return [
        ((f"features.{idx}.conv.0.0", in_ch, hidden, 1, 1, 1),
         f"features.{idx}.conv.0.1"),
        ((f"features.{idx}.conv.1.0", hidden, hidden, 3, stride, hidden),
         f"features.{idx}.conv.1.1"),
        ((f"features.{idx}.conv.2", hidden, out_ch, 1, 1, 1),
         f"features.{idx}.conv.3"),
    ]


def init(generator: torch.Generator, device=None):
    """Kaiming-normal fan-out convs (depthwise ones over ``groups``), BN at
    (scale 1, bias 0, mean 0, var 1) and a uniform classifier, drawn from
    ``generator`` in module order."""
    params = {"features.0.0": conv_init(generator, 3, 3, 3, 32,
                                        device=device),
              "features.0.1": bn_init(32, device)}
    for block in _blocks():
        for (name, ci, co, k, s, g), bn in _block_convs(*block):
            params[name] = conv_init(generator, k, k, ci, co, groups=g,
                                     device=device)
            params[bn] = bn_init(co, device)
    params["features.18.0"] = conv_init(generator, 1, 1, 320, 1280,
                                        device=device)
    params["features.18.1"] = bn_init(1280, device)
    params["classifier.1"] = dense_init(generator, 1280, NUM_CLASSES, device)
    return params


def apply(params, x: torch.Tensor, ctx: QuantCtx | None = None):
    """NHWC forward -> (N, 1000) logits."""
    ctx = ctx or fp32_ctx()

    def cv(name, h, stride, groups, k):
        pad = (k - 1) // 2
        return ctx.conv(name, params[name], h, stride=(stride, stride),
                        padding=[(pad, pad), (pad, pad)], groups=groups)

    h = F.relu6(batch_norm(params["features.0.1"],
                           cv("features.0.0", x, 2, 1, 3)))
    for block in _blocks():
        _, in_ch, out_ch, stride, _ = block
        inp = h
        convs = _block_convs(*block)
        for j, ((name, ci, co, k, s, g), bn) in enumerate(convs):
            h = batch_norm(params[bn], cv(name, h, s, g, k))
            if j < len(convs) - 1:  # no activation after the projection
                h = F.relu6(h)
        if stride == 1 and in_ch == out_ch:
            h = h + inp
    h = F.relu6(batch_norm(params["features.18.1"],
                           cv("features.18.0", h, 1, 1, 1)))
    h = h.mean(dim=(1, 2))
    return ctx.dense("classifier.1", params["classifier.1"], h)


def conv_specs(image: int = 224) -> list[ConvSpec]:
    """Ordered ConvSpec list (stem first), shapes at ``image`` input."""
    s = (image + 1) // 2  # the stem: k3, stride 2, pad 1
    specs = [ConvSpec("features.0.0", 3, 32, 3, 3, 2, out_h=s, out_w=s)]
    for block in _blocks():
        for (name, ci, co, k, st, g), _ in _block_convs(*block):
            if st == 2:
                s = (s + 1) // 2
            specs.append(ConvSpec(name, ci, co, k, k, st, groups=g,
                                  out_h=s, out_w=s))
    specs.append(ConvSpec("features.18.0", 320, 1280, 1, 1, 1,
                          out_h=s, out_w=s))
    return specs


def dense_specs():
    """(name, in_features, out_features) of every linear layer."""
    return [("classifier.1", 1280, NUM_CLASSES)]
