"""int8 serving of the CNN zoo in the port against the JAX package.

VGG-16-bn, MobileNet-v2, EfficientNet-b0 and AlexNet converted at UQ
(wb = db = 7, g = 1, wt = 7, dt = 5, the setting of the JAX package's
``bench_resnet(int8=True, uq=True)``), packed by ``pack_cnn`` (int8
weights for every swept conv; the 16-bit depthwise and squeeze-excite
convs stay float32) and run through ``make_cnn_apply`` in float32 and
bfloat16, at the sizes of ``test_torch_port_zoo.py`` on the same seeded
weights (``chip_smoke.zoo_params``).

Scales: each converted conv's from its input range in the unquantized
forward (max |x| / 64, the same numbers in both packages), so that every
int8 conv sees non-zero codes.  (At the bench's fixed 0.05 EfficientNet-b0's
inputs past its fourth block quantize to zero on these weights.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.convert import cnn as jconv_cnn
from tq_tpu.convert import policy as jpolicy
from tq_tpu_torch.convert import cnn as tconv_cnn
from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int
from tq_tpu_torch.layers import conv as tconv
from tq_tpu_torch.layers import qctx as tqctx
from tq_tpu_torch.ops.term_reveal import uniform_quantize

from test_torch_port_zoo import (LOGIT_RTOL, _Arch, _JaxRecorder,  # noqa: F401
                                 one_thread)

UQ = (7, 1, 7, 7, 5)  # (wb, gs, wt, db, dt)
# The convs pack_cnn makes int8: every converted conv but the 16-bit
# exempt ones (depthwise, squeeze-excite).
INT8_LAYERS = {"alexnet": 4, "vgg16_bn": 12, "mobilenet_v2": 34,
               "efficientnet_b0": 32}
# The int8 forward against the float32 UQ forward (and the JAX package's
# int8 forward) on an image with no code moved across a rounding boundary:
# test_cnn_models.py::test_pack_cnn_whole_model's CPU bound, relative to
# max |logit|.
PACKED_RTOL = 5e-4


@dataclasses.dataclass
class _Recorder(tqctx.QuantCtx):
    """The port's QuantCtx, remembering each converted conv's input and
    arguments in ``seen`` (a dict the caller passes)."""

    seen: dict = dataclasses.field(default_factory=dict)

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1,
             x_channels=None):
        if name in self.cfg:
            self.seen[name] = (x, stride, padding, groups)
        return super().conv(name, params, x, stride, padding, groups,
                            x_channels)


def _record(a, qp, qc, qs, track=False):
    seen = {}
    logits = a.tm.apply(qp, torch.from_numpy(a.x),
                        _Recorder(cfg=qc, state=qs, track=track, seen=seen))
    return logits, seen


class _Case:
    """Both packages' converted and packed models of one arch at UQ."""

    def __init__(self, arch):
        a = self.a = _Arch(arch)
        wb, gs, wt, db, dt = UQ
        st = jpolicy.static_conv_layer_settings(a.specs, wb, gs, wt)
        jqp, self.jqc, jqs = jconv_cnn.convert_cnn(a.jm, a.jp, st, db, dt,
                                                   image=a.img)
        tqp, self.tqc, tqs = tconv_cnn.convert_cnn(a.tm, a.tp, st, db, dt,
                                                   image=a.img)
        # The unquantized forward (track) gives each conv's input range.
        _, raw = _record(a, tqp, self.tqc, tqs, track=True)
        sf = {n: float(raw[n][0].abs().max()) / 64 for n in self.tqc}
        self.jqs = {n: {**jqs[n], "sf": jnp.float32(sf[n])} for n in jqs}
        self.tqs = {n: {**tqs[n], "sf": torch.tensor(sf[n])} for n in tqs}
        self.jqp, self.tqp = jqp, tqp
        self.jpk = jconv_cnn.pack_cnn(jqp, self.jqc)
        self.tpk = tconv_cnn.pack_cnn(tqp, self.tqc)
        self.int8 = [n for n in self.tqc
                     if self.tpk[n]["w"].dtype == torch.int8]

    def jax_packed(self, compute_dtype=None):
        """JAX's packed forward: logits and each converted conv's (input,
        output) and arguments."""
        args = {}

        def fwd(qp, qs, x):
            rec = _JaxRecorder(cfg=self.jqc, state=qs, track=False,
                               compute_dtype=compute_dtype)
            logits = self.a.jm.apply(qp, x, rec)
            args.update(rec.args)
            return logits, rec.seen

        logits, seen = jax.jit(fwd)(self.jpk, self.jqs,
                                    jnp.asarray(self.a.x))
        return np.asarray(logits), seen, args


@pytest.fixture(scope="module",
                params=["alexnet", "vgg16_bn", "mobilenet_v2",
                        "efficientnet_b0"])
def case(request):
    return _Case(request.param)


def test_pack_cnn_matches_jax(case):
    """``pack_cnn`` byte for byte with the JAX package's: every swept conv
    int8 with JAX's integers and ``w_sf``, the exempt convs the converted
    float32 weights untouched."""
    assert len(case.int8) == INT8_LAYERS[case.a.arch]
    for name in case.tqc:
        tw, jw = case.tpk[name]["w"], np.asarray(case.jpk[name]["w"])
        assert str(tw.dtype).removeprefix("torch.") == str(jw.dtype), name
        np.testing.assert_array_equal(tw.numpy(), jw, err_msg=name)
        assert float(case.tpk[name]["w_sf"]) == float(
            case.jpk[name]["w_sf"]), name
        if name not in case.int8:
            assert case.tqc[name].weight_bits == 16
            assert torch.equal(tw, case.tqp[name]["w"])


def test_int8_convs_exact(case):
    """On the packed forward's own inputs, every int8 conv equals its
    int64 plain version (``int8_conv2d_ref``), and the layer's int8 form
    equals the float32 UQ conv on the same input within 1e-5 of max
    |y|."""
    _, seen = _record(case.a, case.tpk, case.tqc, case.tqs)
    tr = case.tqc[case.int8[0]]
    for name in case.int8:
        x, stride, padding, groups = seen[name]
        sf = case.tqs[name]["sf"]
        xi = tr_quantize_int(x, sf, tr.data_bits, tr.data_terms).to(
            torch.int8)
        assert bool((xi != 0).any()), name
        got = tconv.int8_conv2d(xi, case.tpk[name]["w"], stride, padding,
                                groups)
        assert got.dtype == torch.int32
        assert torch.equal(got.to(torch.int64), tconv.int8_conv2d_ref(
            xi, case.tpk[name]["w"], stride, padding, groups)), name
        y8, _ = tconv.tr_conv_apply(case.tpk[name], case.tqc[name],
                                    case.tqs[name], x, False, stride,
                                    padding, groups)
        y32, _ = tconv.tr_conv_apply(case.tqp[name], case.tqc[name],
                                     case.tqs[name], x, False, stride,
                                     padding, groups)
        torch.testing.assert_close(y8, y32, rtol=0,
                                   atol=1e-5 * float(y32.abs().max()))


def _flipped(case, mine: dict, theirs: dict) -> np.ndarray:
    """Per image: does any int8 conv's input code differ between two
    forwards?  The kept terms are a function of the signed uniform code,
    so where the codes differ that differs too (a flip at a rounding
    boundary, or an earlier layer's flip carried on)."""
    batch = case.a.batch
    flipped = np.zeros(batch, bool)
    for name in case.int8:
        tr, sf = case.tqc[name], case.tqs[name]["sf"]
        xa, xb = mine[name], theirs[name]
        qa, qb = (tr_quantize_int(x, sf, tr.data_bits, tr.data_terms)
                  for x in (xa, xb))
        differ = qa != qb
        ua, sa = uniform_quantize(xa[differ], sf, tr.data_bits)
        ub, sb = uniform_quantize(xb[differ], sf, tr.data_bits)
        assert not bool((ua * sa == ub * sb).any()), name
        flipped |= differ.reshape(batch, -1).any(dim=1).numpy()
    return flipped


def _hold_logits(got, want, flipped, limit):
    """Images without a flip within PACKED_RTOL of max |logit|, the
    others within ``limit`` (the CNN rule)."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max(axis=1) / scale
    assert (err[~flipped] <= PACKED_RTOL).all(), (err, flipped)
    assert (err <= limit).all(), (err, flipped)


def test_int8_logits_match_jax_and_uq(case):
    """The packed model's logits against the JAX package's packed model
    (each conv held on JAX's own input first) and against the port's
    float32 UQ model, within PACKED_RTOL of max |logit| on images where no
    int8 conv's input code moved across a rounding boundary, else within
    the zoo's LOGIT_RTOL."""
    want, jseen, jargs = case.jax_packed()
    for name in case.int8:
        xj, yj = (np.array(t) for t in jseen[name])
        stride, padding, groups = jargs[name]
        yt, _ = tconv.tr_conv_apply(case.tpk[name], case.tqc[name],
                                    case.tqs[name], torch.from_numpy(xj),
                                    False, stride, padding, groups)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                   atol=1e-5 * np.abs(yj).max(),
                                   err_msg=name)
    got, mine = _record(case.a, case.tpk, case.tqc, case.tqs)
    got = got.numpy()
    limit = LOGIT_RTOL[case.a.arch]
    theirs = {n: torch.from_numpy(np.array(jseen[n][0])) for n in case.int8}
    _hold_logits(got, want, _flipped(case, {n: mine[n][0] for n in mine},
                                     theirs), limit)
    uq, useen = _record(case.a, case.tqp, case.tqc, case.tqs)
    _hold_logits(got, uq.numpy(),
                 _flipped(case, {n: mine[n][0] for n in mine},
                          {n: useen[n][0] for n in useen}), limit)


def _rel_norm(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_int8_bf16_form(case):
    """int8 + bf16 serving: float32 logits, finite, and within the JAX
    bf16 test's class (0.2 relative norm,
    test_cnn_models.py::test_bf16_io_serving_mode_all_archs) of the int8
    float32 form and of the JAX package's int8 + bf16 forward.  bfloat16
    rounds at other places in the two libraries and the rounding spreads
    through deep stacks: measured here, MobileNet-v2 0.14 from its float32
    form in either package and 0.15 between the two; the other archs
    below 0.06 and 0.01."""
    x = torch.from_numpy(case.a.x)
    got, _ = tconv_cnn.make_cnn_apply(case.a.tm, case.tqc, track=False,
                                      compute_dtype=torch.bfloat16)(
        case.tpk, case.tqs, x)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    f32, _ = tconv_cnn.make_cnn_apply(case.a.tm, case.tqc, track=False)(
        case.tpk, case.tqs, x)
    assert _rel_norm(got.numpy(), f32.numpy()) < 0.2
    want, _, _ = case.jax_packed(compute_dtype=jnp.bfloat16)
    assert _rel_norm(got.numpy(), want) < 0.2
