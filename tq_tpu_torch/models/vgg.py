"""VGG-16-bn (torchvision's graph, config "D" with batch norm), NHWC,
functional.

Port of ``tq_tpu.models.vgg``.  Eval-mode forward (dropout is the
identity).  Parameter names mirror the torchvision module tree
(``features.N`` for conv and BN, ``classifier.N``), and the convs come in
its ``named_modules`` order, so per-layer setting tables line up.  The
three dense layers are never converted: ``convert_cnn`` converts convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tq_tpu_torch.layers.qctx import QuantCtx, fp32_ctx
from tq_tpu_torch.models.cnn_common import (ConvSpec, batch_norm, bn_init,
                                            conv_init, dense_init)

# Channels per conv; 'M' is a 2x2 stride-2 max pool.
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M"]
NUM_CLASSES = 1000
_CLASSIFIER = [(512 * 7 * 7, 4096), (4096, 4096), (4096, NUM_CLASSES)]

__all__ = ["init", "apply", "conv_specs", "dense_specs", "NUM_CLASSES"]


def _feature_layers():
    """Yield ('conv', torch index, in_ch, out_ch) or ('pool', index, None,
    None) in order: torchvision's Sequential gives conv, BN and ReLU an
    index each, a pool one."""
    idx, in_ch = 0, 3
    for v in _CFG:
        if v == "M":
            yield ("pool", idx, None, None)
            idx += 1
        else:
            yield ("conv", idx, in_ch, v)
            idx += 3
            in_ch = v


def init(generator: torch.Generator, device=None):
    """Kaiming-normal fan-out convs with zero biases, BN at (scale 1, bias
    0, mean 0, var 1) and uniform dense layers, drawn from ``generator``
    in module order."""
    params = {}
    for kind, idx, in_ch, out_ch in _feature_layers():
        if kind == "conv":
            params[f"features.{idx}"] = conv_init(generator, 3, 3, in_ch,
                                                  out_ch, bias=True,
                                                  device=device)
            params[f"features.{idx + 1}"] = bn_init(out_ch, device)
    for i, (fi, fo) in zip((0, 3, 6), _CLASSIFIER):
        params[f"classifier.{i}"] = dense_init(generator, fi, fo, device)
    return params


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool without padding (reduce_window 'VALID')."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def apply(params, x: torch.Tensor, ctx: QuantCtx | None = None):
    """NHWC forward -> (N, 1000) logits."""
    ctx = ctx or fp32_ctx()
    h = x
    for kind, idx, in_ch, out_ch in _feature_layers():
        if kind == "pool":
            h = _max_pool(h)
        else:
            h = ctx.conv(f"features.{idx}", params[f"features.{idx}"], h,
                         stride=(1, 1), padding=[(1, 1), (1, 1)])
            h = torch.relu(batch_norm(params[f"features.{idx + 1}"], h))
    # Flattened in NCHW order, as torch does, so imported classifier
    # weights see the same feature order.
    h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
    for i in (0, 3, 6):
        h = ctx.dense(f"classifier.{i}", params[f"classifier.{i}"], h)
        if i != 6:
            h = torch.relu(h)
    return h


def conv_specs(image: int = 224) -> list[ConvSpec]:
    """Ordered ConvSpec list (stem first), shapes at ``image`` input."""
    specs = []
    s = image
    for kind, idx, in_ch, out_ch in _feature_layers():
        if kind == "pool":
            s //= 2
        else:
            specs.append(ConvSpec(f"features.{idx}", in_ch, out_ch, 3, 3, 1,
                                  out_h=s, out_w=s))
    return specs


def dense_specs():
    """(name, in_features, out_features) of every linear layer."""
    return [(f"classifier.{i}", fi, fo)
            for i, (fi, fo) in zip((0, 3, 6), _CLASSIFIER)]
