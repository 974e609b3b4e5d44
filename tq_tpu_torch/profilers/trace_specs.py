"""Layer spec tables recovered by running a model's forward on shapes only.

Port of ``tq_tpu.profilers.trace_specs``.  Both mechanisms run a forward
on ``device="meta"`` tensors (the counterpart of ``jax.eval_shape``:
shapes propagate, nothing is computed):

* a :class:`SpecRecorder` stands in for the QuantCtx of a model module
  and records one :class:`~tq_tpu_torch.models.cnn_common.ConvSpec` per
  ``ctx.conv`` call and one (name, in, out) per ``ctx.dense`` call;
* :func:`dispatch_conv_specs` takes any callable, protocol or not, and
  records every ``aten.convolution`` and rank-2 product that reaches the
  dispatcher.  It sees no layer names (the counterpart of the JAX
  package's ``jaxpr_conv_specs``), so the name-based squeeze-excite
  exemption has to come from the caller.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tq_tpu_torch.layers.conv import conv2d
from tq_tpu_torch.models.cnn_common import ConvSpec

__all__ = ["SpecRecorder", "trace_conv_specs", "trace_dense_specs",
           "dispatch_conv_specs", "specs_for"]


class SpecRecorder:
    """Duck-typed QuantCtx that records layer shapes instead of quantizing.

    ``is_se`` uses the reference's name rule (``'se' in name``), for
    ungrouped convs only: the substring also fires on ``_depthwise_conv``,
    where it changes nothing (grouped convs are exempt already).
    """

    def __init__(self):
        self.conv_specs: list[ConvSpec] = []
        self.dense_specs: list[tuple[str, int, int]] = []

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1):
        y = conv2d(x, params["w"].to(x.dtype), stride, padding, groups)
        s = stride[0] if isinstance(stride, (tuple, list)) else stride
        kh, kw, in_ch_pg, out_ch = params["w"].shape
        self.conv_specs.append(ConvSpec(
            name, in_ch=in_ch_pg * groups, out_ch=out_ch, kh=kh, kw=kw,
            stride=int(s), groups=groups, out_h=int(y.shape[1]),
            out_w=int(y.shape[2]), is_se="se" in name and groups == 1))
        if params.get("b") is not None:
            y = y + params["b"].to(y.dtype)
        return y

    def dense(self, name, params, x):
        self.dense_specs.append((name, int(params["w"].shape[0]),
                                 int(params["w"].shape[1])))
        return torch.matmul(x, params["w"]) + params["b"]


def _record(model_mod, image: int | None, batch: int) -> SpecRecorder:
    if image is None:
        image = getattr(model_mod, "IMAGE_SIZE", 224)
    params = model_mod.init(torch.Generator(), device="meta")
    x = torch.empty(batch, image, image, 3, device="meta")
    rec = SpecRecorder()
    model_mod.apply(params, x, rec)
    return rec


def trace_conv_specs(model_mod, image: int | None = None,
                     batch: int = 1) -> list[ConvSpec]:
    """Ordered ConvSpec list recovered from ``model_mod.apply`` itself
    (equal to a hand-written ``conv_specs()``)."""
    return _record(model_mod, image, batch).conv_specs


def trace_dense_specs(model_mod, image: int | None = None,
                      batch: int = 1) -> list[tuple[str, int, int]]:
    """(name, in_features, out_features) per dense site, by tracing."""
    return _record(model_mod, image, batch).dense_specs


class _OpRecorder(TorchDispatchMode):
    """Records the shapes of every convolution and 2-D product it sees."""

    def __init__(self):
        super().__init__()
        self.convs: list[ConvSpec] = []
        self.denses: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet is torch.ops.aten.convolution:
            x, w = args[0], args[1]  # NCHW input, OIHW weight
            self.convs.append(ConvSpec(
                f"conv{len(self.convs)}", in_ch=int(x.shape[1]),
                out_ch=int(out.shape[1]), kh=int(w.shape[2]),
                kw=int(w.shape[3]), stride=int(args[3][0]),
                groups=int(args[8]), out_h=int(out.shape[2]),
                out_w=int(out.shape[3])))
        elif packet in (torch.ops.aten.mm, torch.ops.aten.addmm):
            a, b = args[-2], args[-1]
            self.denses.append((f"dense{len(self.denses)}", int(a.shape[1]),
                                int(b.shape[1])))
        return out


def dispatch_conv_specs(fn, *example_args):
    """(conv_specs, dense_specs) of ANY callable, recorded at the
    dispatcher while ``fn(*example_args)`` runs (pass ``meta`` tensors to
    compute nothing).  Convs are ``aten.convolution`` calls, read in
    their NCHW/OIHW layout; dense layers are ``aten.mm`` / ``aten.addmm``.
    Names are positional (``conv0``, ``dense0``, ...)."""
    rec = _OpRecorder()
    with rec:
        fn(*example_args)
    return rec.convs, rec.denses


def specs_for(model_mod, image: int | None = None) -> list[ConvSpec]:
    """Conv specs of a model module: its hand table if it has one, else
    traced."""
    if hasattr(model_mod, "conv_specs"):
        return (model_mod.conv_specs(image) if image
                else model_mod.conv_specs())
    return trace_conv_specs(model_mod, image)
