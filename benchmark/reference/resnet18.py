"""ResNet-18 (He et al. 2016; torchvision's ``resnet18``), term-revealed,
in plain float32 NCHW PyTorch.

The parameters are a dict keyed by torchvision's module names with HWIO
conv weights, as the benchmark hands them to the program; this module
reads them in that layout and computes in NCHW.  Every conv but the stem
is converted: its weights term-revealed along the input channels at
(weight_bits, group_size, weight_terms), its input calibrated (phase 1,
``hists``) or term-revealed per element at (data_bits, data_terms) with
its scale (phase 2, ``scales``).  The stem and the classifier stay
float32.  ``tf32`` rounds every product's operands to TF32: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import calibration, term_reveal
from benchmark.reference.compare import gap
from benchmark.reference.precision import operand

_BN_EPS = 1e-5


def blocks(cfg):
    """(name, in channels, out channels, stride) of each basic block."""
    out, cin = [], cfg["stem_channels"]
    for stage, (count, ch) in enumerate(cfg["stages"], start=1):
        for b in range(count):
            stride = 2 if b == 0 and stage > 1 else 1
            out.append((f"layer{stage}.{b}", cin, ch, stride))
            cin = ch
    return out


def convs(cfg):
    """Every conv in the forward's order: (name, in, out, kernel, stride,
    padding, input side, output side)."""
    side = cfg["image"]
    stem = cfg["stem_channels"]
    s = (side + 2 * 3 - 7) // 2 + 1
    out = [("conv1", cfg["channels"], stem, 7, 2, 3, side, s)]
    s = (s + 2 - 3) // 2 + 1  # the max pool
    for name, cin, ch, stride in blocks(cfg):
        s1 = (s + 2 - 3) // stride + 1
        out.append((f"{name}.conv1", cin, ch, 3, stride, 1, s, s1))
        out.append((f"{name}.conv2", ch, ch, 3, 1, 1, s1, s1))
        if stride != 1:
            out.append((f"{name}.downsample.0", cin, ch, 1, stride, 0, s,
                        s1))
        s = s1
    return out


def make_params(cfg, generator: torch.Generator, device) -> dict:
    """Seeded weights in three draws: Kaiming-normal (fan-out) convs,
    batch norms near identity, a uniform classifier."""
    layers = convs(cfg)
    sizes = [k * k * cin * cout for _, cin, cout, k, *_ in layers]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    params, at = {}, 0
    for (name, cin, cout, k, *_), n in zip(layers, sizes):
        params[name] = {"w": flat[at:at + n].view(k, k, cin, cout)
                        * math.sqrt(2.0 / (k * k * cout))}
        at += n
    norms = [("bn1", cfg["stem_channels"])]
    for name, _, ch, stride in blocks(cfg):
        norms += [(f"{name}.bn1", ch), (f"{name}.bn2", ch)]
        if stride != 1:
            norms.append((f"{name}.downsample.1", ch))
    u = torch.rand(4, sum(c for _, c in norms), generator=generator,
                   device=device)
    at = 0
    for name, c in norms:
        v = u[:, at:at + c]
        params[name] = {"scale": 0.8 + 0.4 * v[0], "bias": 0.2 * v[1] - 0.1,
                        "mean": 0.2 * v[2] - 0.1, "var": 0.8 + 0.4 * v[3]}
        at += c
    feat, classes = cfg["stages"][-1][1], cfg["num_classes"]
    bound = 1.0 / math.sqrt(feat)
    u = torch.rand(feat * classes + classes, generator=generator,
                   device=device) * (2 * bound) - bound
    params["fc"] = {"w": u[:feat * classes].view(feat, classes),
                    "b": u[feat * classes:]}
    return params


def convert(params, cfg, weight_bits: int, group_size: int,
            weight_terms: int) -> dict:
    """Term-revealed HWIO weights of every converted conv."""
    return {name: term_reveal.reveal_weight(
                params[name]["w"], weight_bits, group_size, weight_terms,
                axis=2)
            for name, *_ in convs(cfg)[1:]}


def _bn(p, x):
    shape = (1, -1, 1, 1)
    return ((x - p["mean"].view(shape)) / torch.sqrt(p["var"].view(shape)
                                                     + _BN_EPS)
            * p["scale"].view(shape) + p["bias"].view(shape))


def _conv(params, weights, spec, name, h, data_bits, data_terms, scales,
          hists, table, tf32):
    """Conv ``name`` on NCHW ``h``: phase 1 (``hists``) counts its input,
    phase 2 term-reveals it with its scale."""
    stride, pad = spec[name][4], spec[name][5]
    if name in weights:
        w = weights[name]
        if hists is not None:
            hists[name] = calibration.add_to_histogram(hists[name], h)
        else:
            h = term_reveal.reveal_elementwise(h, scales[name], data_bits,
                                               data_terms, table)
    else:
        w = params[name]["w"]
    w = w.permute(3, 2, 0, 1).contiguous()
    return F.conv2d(operand(h, tf32), operand(w, tf32), None, stride, pad)


class _Net:
    """The forward's pieces, each from NCHW inputs."""

    def __init__(self, params, weights, cfg, data_bits, data_terms,
                 scales=None, hists=None, tf32=False, device=None):
        self.p, self.cfg, self.tf32 = params, cfg, tf32
        spec = {c[0]: c for c in convs(cfg)}
        table = (None if hists is not None else
                 term_reveal.kept_table(data_bits, data_terms, device))

        def conv(name, h):
            return _conv(params, weights, spec, name, h, data_bits,
                         data_terms, scales, hists, table, tf32)

        self.conv = conv

    def stem(self, x):
        h = torch.relu(_bn(self.p["bn1"], self.conv("conv1", x)))
        return F.max_pool2d(h, 3, 2, 1)

    def first_half(self, name, h):
        """A block's ``relu(bn1(conv1(h)))``."""
        return torch.relu(_bn(self.p[f"{name}.bn1"],
                              self.conv(f"{name}.conv1", h)))

    def second_half(self, name, stride, h, o):
        """A block's output from its input ``h`` and ``first_half``."""
        o = _bn(self.p[f"{name}.bn2"], self.conv(f"{name}.conv2", o))
        if stride != 1:
            h = _bn(self.p[f"{name}.downsample.1"],
                    self.conv(f"{name}.downsample.0", h))
        return torch.relu(o + h)

    def head(self, features):
        return (operand(features, self.tf32)
                @ operand(self.p["fc"]["w"], self.tf32) + self.p["fc"]["b"])


def forward(params, weights, x_nhwc, cfg, data_bits: int, data_terms: int,
            scales=None, hists=None, tf32: bool = False, record=None):
    """Logits of NHWC images.  ``hists`` (name -> histogram, updated in
    place): phase 1, raw inputs.  Otherwise phase 2 with ``scales``.
    ``record`` (a dict): every conv's input (NHWC) and the classifier's
    under their layer names, as :func:`follow` reads them."""
    net = _Net(params, weights, cfg, data_bits, data_terms, scales, hists,
               tf32, x_nhwc.device)
    if record is not None:
        inner = net.conv

        def recording(name, h):
            record[name] = h.permute(0, 2, 3, 1)
            return inner(name, h)

        net.conv = recording
    h = net.stem(x_nhwc.permute(0, 3, 1, 2).contiguous())
    for name, _, _, stride in blocks(cfg):
        h = net.second_half(name, stride, h, net.first_half(name, h))
    features = h.mean(dim=(2, 3))
    if record is not None:
        record["fc"] = features
    return net.head(features)


def follow(params, weights, cfg, images, record, logits, data_bits: int,
           data_terms: int, scales) -> tuple[float, float]:
    """Follow a forward layer by layer from its own recorded inputs
    (``record`` as :func:`forward` fills it, NHWC): the stem from the
    images, each block's halves from the recorded inputs of its convs,
    the pooled features from the last block's, the logits from the
    recorded features.  Returns (the widest gap of a layer's output from
    the next recorded input, the logits' gap), each as a share of the
    reference's largest magnitude."""
    net = _Net(params, weights, cfg, data_bits, data_terms, scales,
               device=images.device)

    def got(name):
        t = record.get(name)
        return None if t is None else t.permute(0, 3, 1, 2)

    gaps = [gap(got("layer1.0.conv1"),
                 net.stem(images.permute(0, 3, 1, 2).contiguous()))]
    names = blocks(cfg)
    for i, (name, _, _, stride) in enumerate(names):
        h, o = got(f"{name}.conv1"), got(f"{name}.conv2")
        if h is None or o is None:
            return float("inf"), float("inf")
        gaps.append(gap(o, net.first_half(name, h)))
        out = net.second_half(name, stride, h, o)
        if i + 1 < len(names):
            gaps.append(gap(got(f"{names[i + 1][0]}.conv1"), out))
        else:
            gaps.append(gap(record.get("fc"), out.mean(dim=(2, 3))))
    features = record.get("fc")
    if features is None:
        return float("inf"), float("inf")
    return max(gaps), gap(logits, net.head(features))


def calibrate(params, weights, cfg, batches, data_bits: int,
              data_terms: int, tf32: bool = False):
    """Phase 1 over ``batches`` (NHWC), then the scale search: (name ->
    histogram, name -> scale)."""
    hists = {name: calibration.new_histogram(batches[0].device)
             for name in weights}
    for x in batches:
        forward(params, weights, x, cfg, data_bits, data_terms, hists=hists,
                tf32=tf32)
    scales = {name: calibration.search_scale(h, data_bits, data_terms)
              for name, h in hists.items()}
    return hists, scales
