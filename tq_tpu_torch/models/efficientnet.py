"""EfficientNet-b0 (efficientnet_pytorch's graph), NHWC, functional.

Port of ``tq_tpu.models.efficientnet``.  Parameter names mirror the
efficientnet_pytorch module tree (``_conv_stem``, ``_blocks.N._*``,
``_conv_head``, ``_fc``), so its checkpoints import without a rename.
Every conv pads 'SAME' (TensorFlow's: asymmetric at stride 2, the extra
row and column at the high end), BN eps is 1e-3, the activation is swish,
and each block's squeeze-excite pair of biased 1x1 convs gates the
channels through a sigmoid.  The conversion policy exempts the depthwise
convs (``groups > 1``) and the squeeze-excite ones (``'se' in name``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tq_tpu_torch.layers.qctx import QuantCtx, fp32_ctx
from tq_tpu_torch.models.cnn_common import (ConvSpec, batch_norm, bn_init,
                                            conv_init, dense_init)

# b0 stages: (repeats, kernel, stride, expansion, in_ch, out_ch, se_ratio)
_BLOCK_ARGS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]
NUM_CLASSES = 1000
BN_EPS = 1e-3
IMAGE_SIZE = 224

__all__ = ["init", "apply", "conv_specs", "dense_specs", "IMAGE_SIZE",
           "NUM_CLASSES", "BN_EPS"]


def _blocks():
    """Yield (index, in_ch, out_ch, k, stride, expansion, se_ch) in order."""
    idx = 0
    for repeats, k, stride, expand, in_ch, out_ch, se in _BLOCK_ARGS:
        for i in range(repeats):
            ci = in_ch if i == 0 else out_ch
            yield (idx, ci, out_ch, k, stride if i == 0 else 1, expand,
                   max(1, int(ci * se)))
            idx += 1


def init(generator: torch.Generator, device=None):
    """Kaiming-normal fan-out convs (zero biases on the squeeze-excite
    ones), BN at (scale 1, bias 0, mean 0, var 1) and a uniform ``_fc``,
    drawn from ``generator`` in module order."""
    params = {"_conv_stem": conv_init(generator, 3, 3, 3, 32, device=device),
              "_bn0": bn_init(32, device)}
    for idx, ci, co, k, s, e, se_ch in _blocks():
        pre = f"_blocks.{idx}"
        hidden = ci * e
        if e != 1:
            params[f"{pre}._expand_conv"] = conv_init(generator, 1, 1, ci,
                                                      hidden, device=device)
            params[f"{pre}._bn0"] = bn_init(hidden, device)
        params[f"{pre}._depthwise_conv"] = conv_init(
            generator, k, k, hidden, hidden, groups=hidden, device=device)
        params[f"{pre}._bn1"] = bn_init(hidden, device)
        params[f"{pre}._se_reduce"] = conv_init(generator, 1, 1, hidden, se_ch,
                                                bias=True, device=device)
        params[f"{pre}._se_expand"] = conv_init(generator, 1, 1, se_ch, hidden,
                                                bias=True, device=device)
        params[f"{pre}._project_conv"] = conv_init(generator, 1, 1, hidden,
                                                   co, device=device)
        params[f"{pre}._bn2"] = bn_init(co, device)
    params["_conv_head"] = conv_init(generator, 1, 1, 320, 1280,
                                     device=device)
    params["_bn1"] = bn_init(1280, device)
    params["_fc"] = dense_init(generator, 1280, NUM_CLASSES, device)
    return params


def apply(params, x: torch.Tensor, ctx: QuantCtx | None = None):
    """NHWC forward -> (N, 1000) logits."""
    ctx = ctx or fp32_ctx()

    def cv(name, h, stride=1, groups=1):
        return ctx.conv(name, params[name], h, stride=(stride, stride),
                        padding="SAME", groups=groups)

    def bn(name, h):
        return batch_norm(params[name], h, BN_EPS)

    h = F.silu(bn("_bn0", cv("_conv_stem", x, 2)))
    for idx, ci, co, k, s, e, se_ch in _blocks():
        pre = f"_blocks.{idx}"
        inp = h
        if e != 1:
            h = F.silu(bn(f"{pre}._bn0", cv(f"{pre}._expand_conv", h)))
        h = F.silu(bn(f"{pre}._bn1", cv(f"{pre}._depthwise_conv", h, s,
                                        ci * e)))
        # Squeeze-excite: global pool -> reduce -> swish -> expand ->
        # sigmoid, a gate per channel.
        z = h.mean(dim=(1, 2), keepdim=True)
        z = F.silu(cv(f"{pre}._se_reduce", z))
        h = h * torch.sigmoid(cv(f"{pre}._se_expand", z))
        h = bn(f"{pre}._bn2", cv(f"{pre}._project_conv", h))
        if s == 1 and ci == co:
            h = h + inp
    h = F.silu(bn("_bn1", cv("_conv_head", h)))
    h = h.mean(dim=(1, 2))
    return ctx.dense("_fc", params["_fc"], h)


def conv_specs(image: int = IMAGE_SIZE) -> list[ConvSpec]:
    """Ordered ConvSpec list (stem first), shapes at ``image`` input."""
    s = -(-image // 2)  # 'SAME' at stride 2
    specs = [ConvSpec("_conv_stem", 3, 32, 3, 3, 2, out_h=s, out_w=s)]
    for idx, ci, co, k, st, e, se_ch in _blocks():
        pre = f"_blocks.{idx}"
        hidden = ci * e
        if e != 1:
            specs.append(ConvSpec(f"{pre}._expand_conv", ci, hidden, 1, 1, 1,
                                  out_h=s, out_w=s))
        if st == 2:
            s = -(-s // 2)
        specs.append(ConvSpec(f"{pre}._depthwise_conv", hidden, hidden, k, k,
                              st, groups=hidden, out_h=s, out_w=s))
        specs.append(ConvSpec(f"{pre}._se_reduce", hidden, se_ch, 1, 1, 1,
                              out_h=1, out_w=1, is_se=True))
        specs.append(ConvSpec(f"{pre}._se_expand", se_ch, hidden, 1, 1, 1,
                              out_h=1, out_w=1, is_se=True))
        specs.append(ConvSpec(f"{pre}._project_conv", hidden, co, 1, 1, 1,
                              out_h=s, out_w=s))
    specs.append(ConvSpec("_conv_head", 320, 1280, 1, 1, 1, out_h=s, out_w=s))
    return specs


def dense_specs():
    """(name, in_features, out_features) of every linear layer."""
    return [("_fc", 1280, NUM_CLASSES)]
