"""QuantCtx: threads per-layer quantization config and state through a
model's forward.

Port of ``tq_tpu.layers.qctx``.  A converted model is the same apply
function plus a context holding, per layer name, the TRParams, the
quantizer state (histogram + scale) and the phase flag.  Models call
:meth:`QuantCtx.conv` / :meth:`QuantCtx.dense` at every quantizable site.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tq_tpu_torch.layers.conv import conv2d, tr_conv_apply
from tq_tpu_torch.layers.linear import tr_dense_apply

__all__ = ["QuantCtx", "fp32_ctx"]


@dataclasses.dataclass
class QuantCtx:
    """Quantization context for one forward pass.

    ``cfg``: name -> TRParams of every converted layer; ``state``: name ->
    {'hist', 'sf'}; ``track``: phase-1 histogram accumulation vs phase-2
    quantized eval; ``out_state`` collects the updated state (read it
    after the forward); ``compute_dtype``: e.g. ``torch.bfloat16``, the
    serving mode's conv operand and output dtype (float32 sums either way);
    ``count_reduce``: applied to each calibration batch's int64 histogram
    counts (the sum over the 'data' ranks that split the batch).

    ``conv``'s ``x_channels`` (a subclass's hook: a tensor-parallel rank's
    groups) narrows the input the conv reads, after the histogram and the
    quantization have seen all of it.
    """

    cfg: dict | None
    state: dict | None
    track: bool = False
    out_state: dict = dataclasses.field(default_factory=dict)
    compute_dtype: torch.dtype | None = None
    count_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1,
             x_channels: slice | None = None):
        if self.cfg is None or name not in self.cfg:
            if x_channels is not None:
                x = x[..., x_channels]
            # An unconverted layer (the stem) runs at compute_dtype too: the
            # serving mode is whole-model bfloat16 IO.
            dt = self.compute_dtype
            if dt is not None and not self.track:
                y = conv2d(x.to(dt), params["w"].to(dt), stride, padding,
                           groups)
            else:
                y = conv2d(x, params["w"], stride, padding, groups)
            if params.get("b") is not None:
                y = y + params["b"].to(y.dtype)
            return y
        y, qs = tr_conv_apply(params, self.cfg[name], self.state[name], x,
                              self.track, stride, padding, groups,
                              compute_dtype=self.compute_dtype,
                              count_reduce=self.count_reduce,
                              x_channels=x_channels)
        self.out_state[name] = qs
        return y

    def dense(self, name, params, x):
        if self.cfg is None or name not in self.cfg:
            # float32 output from any operand dtype, as jnp.dot with
            # preferred_element_type=float32.
            y = torch.matmul(x.to(torch.float32),
                             params["w"].to(torch.float32))
            if params.get("b") is not None:
                y = y + params["b"].to(torch.float32)
            return y
        y, qs = tr_dense_apply(params, self.cfg[name], self.state[name], x,
                               self.track, count_reduce=self.count_reduce)
        self.out_state[name] = qs
        return y


def fp32_ctx() -> QuantCtx:
    """A context with no converted layers (plain fp32 forward)."""
    return QuantCtx(cfg=None, state=None, track=False)
