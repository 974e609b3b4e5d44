"""Empirical term-pair cost: the analytic tmacs column checked against
the term-pair multiplications counted on live tensors.

Port of ``tq_tpu.profilers.empirical``.  The reference cross-checks its
analytic tmacs counter against reality: ``Tracker`` modules capture live
activations (``visualize/term_group_dist.py:19-45``) and bit-plane
*convolutions* count the term-pair multiplications a hardware term-MAC
array would actually execute (``:90-110``): expand quantized data and
weights into digit planes, convolve every (data plane, weight plane)
pair, and sum — each unit product of two nonzero plane entries is one
term-pair multiplication (one exponent-add in ``mac.v:60``).

* :class:`ActivationCapture` — a QuantCtx that records each converted
  conv's input during the forward (the Tracker analog: the context
  already threads every quantizable site).
* :func:`conv_term_pair_map` — the plane-pair convolution as ONE
  convolution: the data-plane axis folds into the batch, the weight-plane
  axis into the output channels.  ``encoding='hese'`` counts HESE term
  pairs (what the tmacs model counts), ``'binary'`` bit pairs (the
  reference script's statistic, bit_utils.py:63-73).
* :func:`conv_term_pair_total` — the same total as one convolution of
  per-element term-COUNT maps:
  ``sum_p sum_r conv(occ_x[p], occ_w[r]) == conv(sum_p occ_x, sum_r occ_w)``.
* :func:`empirical_cnn_cost` — capture a converted CNN's activations on a
  batch and count, per layer, the measured term-pair total and the
  measured mean term counts, for comparison with the analytic
  :func:`~tq_tpu_torch.profilers.term_ops.conv2d_term_macs`;
  :func:`captured_cost` is its counting half, on captures made before.

Every count is an exact integer.  The convolutions and the dense product
run in float32 on term counts and digit-plane entries (each at most 17),
with TF32 switched off for the call (cuDNN's convolutions default to it),
so every product is exact and every output position, a sum of fewer
than 2^24 such products, is an exact float32 integer.  Each position is
rounded to the nearest integer before it is converted, so that a
convolution algorithm that leaves an exact sum a few ulps off (Winograd,
FFT) still gives the integer.  Grand totals are summed in int64: a total
can pass 2^24.

Invariants (``tests/test_empirical_cost.py``, the port's tests and
``chip_smoke.py``): plane-pair total == count-map total; measured total
<= analytic budget total; the analytic model with the measured mean
counts matches the measured total within tolerance.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence

import torch

from tq_tpu_torch.layers.conv import conv2d
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.ops.hese import (binary_digit_planes, hese_digit_planes,
                                   hese_terms_count)

__all__ = [
    "ActivationCapture",
    "capture_activations",
    "conv_term_pair_map",
    "conv_term_pair_total",
    "dense_term_pair_total",
    "captured_cost",
    "empirical_cnn_cost",
]


class ActivationCapture(QuantCtx):
    """QuantCtx that also records converted conv layers' inputs.

    ``captured[name] = (x, stride, padding, groups)`` with ``x`` the
    layer's pre-quantization input; quantize it with the layer's own
    ``qstate[name]['sf']`` and TRParams to reproduce exactly what the conv
    consumed.
    """

    def __init__(self, cfg, state):
        super().__init__(cfg=cfg, state=state, track=False)
        self.captured: dict = {}

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1):
        if self.cfg is not None and name in self.cfg:
            self.captured[name] = (x, stride, padding, groups)
        return super().conv(name, params, x, stride, padding, groups)


def capture_activations(model_mod, qparams, qstate, qcfg, x):
    """Quantized forward of ``x``; returns {layer name: (input, stride,
    padding, groups)} of every converted conv."""
    ctx = ActivationCapture(qcfg, qstate)
    with torch.no_grad():
        model_mod.apply(qparams, x, ctx)
    return ctx.captured


def _int_grid(v, sf, bits: int) -> torch.Tensor:
    """|v|/sf as int32, clamped at 2^bits - 1 (v is on the sf grid by
    construction).  ``torch.round`` rounds half to even, as the JAX
    package's ``jnp.round`` here: not the quantizer's
    ``floor(|x|/sf + 0.5)``.  The two differ only on an exact half, which
    a value on the grid never gives."""
    v = torch.as_tensor(v).to(torch.float32)
    sf = torch.as_tensor(sf, dtype=torch.float32, device=v.device)
    q = torch.round(v.abs() / sf).to(torch.int32)
    return torch.clamp(q, max=2 ** bits - 1)


def _occupancy(q, bits: int, encoding: str) -> torch.Tensor:
    if encoding == "hese":
        return hese_digit_planes(q, bits).abs()
    if encoding == "binary":
        return binary_digit_planes(q, bits)
    raise ValueError(f"unknown encoding {encoding!r}")


@contextmanager
def _no_tf32():
    """Full float32 products in the counting convolutions and matmul."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _int_conv(x, w, stride, padding) -> torch.Tensor:
    """conv2d of integer-valued tensors, as int64 (see the module's
    docstring)."""
    with _no_tf32():
        y = conv2d(x.to(torch.float32), w.to(torch.float32), stride, padding)
    return torch.round(y).to(torch.int64)


def conv_term_pair_map(xq, w_q, sf, w_sf, data_bits: int, weight_bits: int,
                       stride=(1, 1), padding="SAME",
                       encoding: str = "hese") -> torch.Tensor:
    """Per-output-position term-pair multiplication counts of one conv.

    ``xq`` (NHWC) and ``w_q`` (HWIO) are the *quantized* activation and
    weight tensors (multiples of their scale factors).  Returns an int32
    tensor of the conv's output shape: the number of term-pair
    multiplications in each output's dot product (the reference's
    ``r_bits.sum((1, 3))``, term_group_dist.py:104-108).  The convolution
    takes a (B*Tx, H, W, C) input and gives oc*Tw output channels, Tx and
    Tw the planes (bits + 1 each).
    """
    cx = _occupancy(_int_grid(xq, sf, data_bits), data_bits, encoding)
    cw = _occupancy(_int_grid(w_q, w_sf, weight_bits), weight_bits, encoding)
    B, H, W, C = xq.shape
    kh, kw, ic, oc = w_q.shape
    Tx, Tw = cx.shape[-1], cw.shape[-1]
    # (B, H, W, C, Tx) -> (B*Tx, H, W, C)
    xp = torch.movedim(cx, -1, 1).reshape(B * Tx, H, W, C)
    # (kh, kw, ic, oc, Tw) -> (kh, kw, ic, oc*Tw)
    wp = cw.reshape(kh, kw, ic, oc * Tw)
    y = _int_conv(xp, wp, stride, padding)
    oh, ow = y.shape[1], y.shape[2]
    y = y.reshape(B, Tx, oh, ow, oc, Tw)
    return y.sum(dim=(1, 5)).to(torch.int32)


def _term_counts(xq, w_q, sf, w_sf, data_bits: int, weight_bits: int):
    """HESE term counts of every activation and weight element."""
    return (hese_terms_count(_int_grid(xq, sf, data_bits), data_bits),
            hese_terms_count(_int_grid(w_q, w_sf, weight_bits), weight_bits))


def _conv_total(cx, cw, stride, padding) -> int:
    return int(_int_conv(cx, cw, stride, padding).sum())


def conv_term_pair_total(xq, w_q, sf, w_sf, data_bits: int,
                         weight_bits: int, stride=(1, 1),
                         padding="SAME") -> int:
    """Exact total HESE term-pair multiplications of one conv, as one
    convolution of per-element term-count maps."""
    cx, cw = _term_counts(xq, w_q, sf, w_sf, data_bits, weight_bits)
    return _conv_total(cx, cw, stride, padding)


def dense_term_pair_total(xq, w_q, sf, w_sf, data_bits: int,
                          weight_bits: int) -> int:
    """Exact total term-pair multiplications of a dense layer (``w_q``
    is (in, out))."""
    cx, cw = _term_counts(xq, w_q, sf, w_sf, data_bits, weight_bits)
    with _no_tf32():
        y = torch.matmul(cx.to(torch.float32), cw.to(torch.float32))
    return int(torch.round(y).to(torch.int64).sum())


def captured_cost(captured, qparams, qstate, qcfg, specs,
                  batch: int) -> dict:
    """The counting half of :func:`empirical_cnn_cost`, on the captures
    of a batch of ``batch`` images (on any device: the counts are the
    same)."""
    from tq_tpu_torch.layers.quantize import act_quantize

    by_name = {s.name: s for s in specs}
    out = {}
    for name, (xin, stride, padding, groups) in captured.items():
        if groups != 1:
            continue  # the analytic counter skips grouped convs
        tr = qcfg[name]
        sf = qstate[name]["sf"]
        xq = act_quantize(xin, sf, tr.data_bits, tr.data_terms)
        w_q, w_sf = qparams[name]["w"], qparams[name]["w_sf"]
        cx, cw = _term_counts(xq, w_q, sf, w_sf, tr.data_bits,
                              tr.weight_bits)
        pairs = _conv_total(cx, cw, stride, padding)
        spec = by_name[name]
        macs = batch * spec.out_elems * spec.in_ch * spec.kh * spec.kw
        # Executed MAC count with this padding: padded taps read zeros (0
        # terms), so the factorization check compares against avg *
        # effective macs, not the analytic full-window count (which, like
        # the reference's hook, charges padded taps).
        eff_macs = _conv_total(torch.ones_like(cx), torch.ones_like(cw),
                               stride, padding)
        out[name] = {
            "pairs": pairs,
            "macs": macs,
            "effective_macs": eff_macs,
            # Means of exact int64 sums: the same on every device.
            "avg_dt": int(cx.sum()) / cx.numel(),
            "avg_wt_elem": int(cw.sum()) / cw.numel(),
        }
    return out


def empirical_cnn_cost(model_mod, qparams, qstate, qcfg, x,
                       specs: Sequence | None = None) -> dict:
    """Measured per-layer term-pair cost of a converted CNN on batch ``x``.

    Returns {name: {'pairs', 'macs', 'effective_macs', 'avg_dt',
    'avg_wt_elem'}} over the layers the analytic counter counts
    (ungrouped, non-stem: the stem is never converted and grouped convs
    are policy-exempt, profile_model.py:25-26).  ``pairs`` is the exact
    measured total; ``avg_dt`` the measured mean data-term count per
    activation element (the analytic model assumes the budget ``dt``);
    ``avg_wt_elem`` the measured mean weight-term count per weight element
    (the analytic model assumes ``wt / g``).
    """
    from tq_tpu_torch.profilers.trace_specs import specs_for

    if specs is None:
        specs = specs_for(model_mod, image=x.shape[1])
    captured = capture_activations(model_mod, qparams, qstate, qcfg, x)
    return captured_cost(captured, qparams, qstate, qcfg, specs, x.shape[0])
