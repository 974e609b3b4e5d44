"""AlexNet (torchvision's graph), NHWC, functional.

Port of ``tq_tpu.models.alexnet``.  Eval-mode forward (dropout is the
identity).  Parameter names mirror the torchvision module tree
(``features.N``, ``classifier.N``); every conv carries a bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tq_tpu_torch.layers.qctx import QuantCtx, fp32_ctx
from tq_tpu_torch.models.cnn_common import (ConvSpec, conv_init, conv_out,
                                            dense_init)

# (torch index, in, out, k, stride, pad); a 3x3 stride-2 max pool after
# the convs at indices 0, 3 and 10.
_CONVS = [
    (0, 3, 64, 11, 4, 2),
    (3, 64, 192, 5, 1, 2),
    (6, 192, 384, 3, 1, 1),
    (8, 384, 256, 3, 1, 1),
    (10, 256, 256, 3, 1, 1),
]
_POOL_AFTER = {0, 3, 10}
NUM_CLASSES = 1000
_CLASSIFIER = [(1, 256 * 6 * 6, 4096), (4, 4096, 4096), (6, 4096, NUM_CLASSES)]

__all__ = ["init", "apply", "conv_specs", "dense_specs", "NUM_CLASSES"]


def init(generator: torch.Generator, device=None):
    """Kaiming-normal fan-out convs with zero biases and uniform dense
    layers, drawn from ``generator`` in module order."""
    params = {}
    for idx, ci, co, k, s, p in _CONVS:
        params[f"features.{idx}"] = conv_init(generator, k, k, ci, co,
                                              bias=True, device=device)
    for idx, fi, fo in _CLASSIFIER:
        params[f"classifier.{idx}"] = dense_init(generator, fi, fo, device)
    return params


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool without padding (reduce_window 'VALID')."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def apply(params, x: torch.Tensor, ctx: QuantCtx | None = None):
    """NHWC forward -> (N, 1000) logits."""
    ctx = ctx or fp32_ctx()
    h = x
    for idx, ci, co, k, s, pad in _CONVS:
        name = f"features.{idx}"
        h = torch.relu(ctx.conv(name, params[name], h, stride=(s, s),
                                padding=[(pad, pad), (pad, pad)]))
        if idx in _POOL_AFTER:
            h = _max_pool(h)
    # The adaptive 6x6 average pool is the identity at 224.  Flattened in
    # NCHW order, as torch does, so imported classifier weights line up.
    h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
    for idx, fi, fo in _CLASSIFIER:
        h = ctx.dense(f"classifier.{idx}", params[f"classifier.{idx}"], h)
        if idx != 6:
            h = torch.relu(h)
    return h


def conv_specs(image: int = 224) -> list[ConvSpec]:
    """Ordered ConvSpec list (stem first), shapes at ``image`` input."""
    specs = []
    s = image
    for idx, ci, co, k, st, pad in _CONVS:
        s = conv_out(s, k, st, pad)
        specs.append(ConvSpec(f"features.{idx}", ci, co, k, k, st,
                              out_h=s, out_w=s))
        if idx in _POOL_AFTER:
            s = conv_out(s, 3, 2, 0)
    return specs


def dense_specs():
    """(name, in_features, out_features) of every linear layer."""
    return [(f"classifier.{i}", fi, fo) for i, fi, fo in _CLASSIFIER]
