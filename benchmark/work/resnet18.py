"""ResNet-18's work at a configuration's shapes."""

from __future__ import annotations

from benchmark.reference.resnet18 import blocks, convs
from benchmark.roofline import matmul

_F32 = 4


def _tensors(cfg, per_norm: int) -> int:
    """Elements of the convs, ``per_norm`` vectors a batch norm, and the
    classifier."""
    n = sum(k * k * cin * cout for _, cin, cout, k, *_ in convs(cfg))
    norms = cfg["stem_channels"] + sum(
        ch * (3 if stride != 1 else 2) for _, _, ch, stride in blocks(cfg))
    feat, classes = cfg["stages"][-1][1], cfg["num_classes"]
    return n + per_norm * norms + feat * classes + classes


def step(cfg, rows: int) -> tuple[float, float]:
    """One forward of ``rows`` images: the convs' and the classifier's
    multiply-adds; the weights and batch norms' four vectors, the images
    and the logits."""
    ops = sum(2.0 * rows * k * k * cin * cout * side * side
              for _, cin, cout, k, _, _, _, side in convs(cfg))
    feat, classes = cfg["stages"][-1][1], cfg["num_classes"]
    ops += matmul(rows, feat, classes, _F32)[0]
    image = cfg["image"] ** 2 * cfg["channels"]
    nbytes = (_tensors(cfg, 4) + rows * image + rows * classes) * _F32
    return ops, nbytes


def kernel(cfg, name: str, rows: int) -> tuple[float, float]:
    """``tr_quantize``: the element-wise term reveal of every converted
    conv's input (float32 in, float32 out), a forward of ``rows``."""
    if name != "tr_quantize":
        raise KeyError(name)
    elems = sum(rows * cin * side * side
                for _, cin, _, _, _, _, side, _ in convs(cfg)[1:])
    return 0.0, 2.0 * _F32 * elems


def parameters(cfg) -> int:
    """Trained parameters, as torchvision counts them (a batch norm's
    scale and bias; its running statistics are buffers)."""
    return _tensors(cfg, 2)
