"""ResNet-18 (torchvision's graph), NHWC, functional.

Port of ``tq_tpu.models.resnet``.  Parameter names mirror the torchvision
module tree (``conv1``, ``layer1.0.conv2``, ``fc``, ...), so
:mod:`tq_tpu_torch.utils.torch_import` maps its checkpoints over directly
and the conversion policy lines up with the reference's ``named_modules``
walk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tq_tpu_torch.layers.qctx import QuantCtx, fp32_ctx
from tq_tpu_torch.models.cnn_common import (ConvSpec, batch_norm, bn_init,
                                            conv_init, conv_out, dense_init)

# (blocks per stage, channels per stage) for ResNet-18.
STAGES = ((2, 64), (2, 128), (2, 256), (2, 512))
NUM_CLASSES = 1000

__all__ = ["init", "apply", "conv_specs", "dense_specs", "STAGES",
           "NUM_CLASSES"]


def _block_names():
    for si, (blocks, ch) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            yield f"layer{si}.{bi}", ch, si, bi


def init(generator: torch.Generator, device=None):
    """Kaiming-normal fan-out convs, BN at (scale 1, bias 0, mean 0, var 1)
    and a uniform ``fc``, drawn from ``generator`` in torchvision's module
    order (not the JAX package's values: its keys split differently)."""
    params = {"conv1": conv_init(generator, 7, 7, 3, 64, device=device),
              "bn1": bn_init(64, device)}
    in_ch = 64
    for name, ch, si, bi in _block_names():
        downsample = bi == 0 and si > 1
        params[f"{name}.conv1"] = conv_init(generator, 3, 3, in_ch, ch,
                                            device=device)
        params[f"{name}.bn1"] = bn_init(ch, device)
        params[f"{name}.conv2"] = conv_init(generator, 3, 3, ch, ch,
                                            device=device)
        params[f"{name}.bn2"] = bn_init(ch, device)
        if downsample:
            params[f"{name}.downsample.0"] = conv_init(generator, 1, 1, in_ch,
                                                       ch, device=device)
            params[f"{name}.downsample.1"] = bn_init(ch, device)
        in_ch = ch
    params["fc"] = dense_init(generator, 512, NUM_CLASSES, device)
    return params


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool, padded by one with -inf (as reduce_window)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def apply(params, x: torch.Tensor, ctx: QuantCtx | None = None):
    """NHWC forward -> (N, 1000) logits."""
    cv = (ctx or fp32_ctx()).conv
    h = cv("conv1", params["conv1"], x, stride=(2, 2),
           padding=[(3, 3), (3, 3)])
    h = torch.relu(batch_norm(params["bn1"], h))
    h = _max_pool(h)
    for name, ch, si, bi in _block_names():
        downsample = bi == 0 and si > 1
        stride = (2, 2) if downsample else (1, 1)
        shortcut = h
        o = cv(f"{name}.conv1", params[f"{name}.conv1"], h, stride=stride,
               padding=[(1, 1), (1, 1)])
        o = torch.relu(batch_norm(params[f"{name}.bn1"], o))
        o = cv(f"{name}.conv2", params[f"{name}.conv2"], o, stride=(1, 1),
               padding=[(1, 1), (1, 1)])
        o = batch_norm(params[f"{name}.bn2"], o)
        if downsample:
            shortcut = cv(f"{name}.downsample.0",
                          params[f"{name}.downsample.0"], h, stride=stride,
                          padding=[(0, 0), (0, 0)])
            shortcut = batch_norm(params[f"{name}.downsample.1"], shortcut)
        h = torch.relu(o + shortcut)
    h = h.mean(dim=(1, 2))
    if ctx is not None:
        return ctx.dense("fc", params["fc"], h)
    return torch.matmul(h, params["fc"]["w"]) + params["fc"]["b"]


def conv_specs(image: int = 224) -> list[ConvSpec]:
    """Ordered ConvSpec list (stem first), shapes at ``image`` input."""
    s = conv_out(image, 7, 2, 3)
    specs = [ConvSpec("conv1", 3, 64, 7, 7, 2, out_h=s, out_w=s)]
    s = conv_out(s, 3, 2, 1)  # maxpool
    in_ch = 64
    for name, ch, si, bi in _block_names():
        downsample = bi == 0 and si > 1
        stride = 2 if downsample else 1
        s1 = conv_out(s, 3, stride, 1)
        specs.append(ConvSpec(f"{name}.conv1", in_ch, ch, 3, 3, stride,
                              out_h=s1, out_w=s1))
        specs.append(ConvSpec(f"{name}.conv2", ch, ch, 3, 3, 1,
                              out_h=s1, out_w=s1))
        if downsample:
            specs.append(ConvSpec(f"{name}.downsample.0", in_ch, ch, 1, 1,
                                  stride, out_h=s1, out_w=s1))
        s = s1
        in_ch = ch
    return specs


def dense_specs():
    """(name, in_features, out_features) of every linear layer."""
    return [("fc", 512, NUM_CLASSES)]
