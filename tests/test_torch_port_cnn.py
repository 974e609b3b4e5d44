"""The ResNet-18 slice of the port against the JAX package.

The full ResNet-18 graph at a small image (32 px, batch 2), with the JAX
package's ``resnet.init(PRNGKey(0))`` weights carried over through
``params_from_jax``: the conv, BN and pool pieces, the fp32 forward, the
spec tables and the policy, the cost columns against
``results/resnet18-results.json``, conversion, the two-phase cycle layer by
layer, the bf16 and int8 serving modes, torch checkpoints, the sweep, the
data, and the kernels' plain versions this slice adds (the bf16 input of
the element-wise body, ``tr_scale_copy``).

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_cnn --expected``, it
prints the JAX package's numbers on ``chip_smoke.resnet_checkpoint``'s
weights at 224x224 (about a minute on 8 CPU cores), the numbers
``chip_smoke.EXPECTED_CNN`` pins.
"""

import dataclasses
import importlib
import importlib.util
import inspect
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.convert import cnn as jconv_cnn
from tq_tpu.convert import policy as jpolicy
from tq_tpu.data import imagenet as jimagenet
from tq_tpu.data import synthetic as jsyn
from tq_tpu.evals import cnn as jeval
from tq_tpu.layers import conv as jconv
from tq_tpu.layers import qctx as jqctx
from tq_tpu.layers.quantize import act_quantize as j_act_quantize
from tq_tpu.models import cnn_common as jcommon
from tq_tpu.models import resnet as jres
from tq_tpu.profilers import cnn_cost as j_cnn_cost
from tq_tpu.profilers import trace_specs as jtrace
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu.utils import torch_import as jtorch_import
from tq_tpu_torch.convert import cnn as tconv_cnn
from tq_tpu_torch.convert import policy as tpolicy
from tq_tpu_torch.data import imagenet as timagenet
from tq_tpu_torch.data import synthetic as tsyn
from tq_tpu_torch.evals import cnn as teval
from tq_tpu_torch.kernels import tr_quantize as ttrq
from tq_tpu_torch.layers import conv as tconv
from tq_tpu_torch.layers import qctx as tqctx
from tq_tpu_torch.layers.quantize import (_tr_elementwise_vals,
                                          calibration_grids)
from tq_tpu_torch.models import cnn_common as tcommon
from tq_tpu_torch.models import resnet as tres
from tq_tpu_torch.profilers import cnn_cost as t_cnn_cost
from tq_tpu_torch.profilers import param_count as t_param_count
from tq_tpu_torch.profilers import trace_specs as ttrace
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils import torch_import as ttorch_import
from tq_tpu_torch.utils.params import params_from_jax

jprof = importlib.import_module("tq_tpu.profilers.term_ops")
jtrq = importlib.import_module("tq_tpu.kernels.tr_quantize")

ROOT = Path(__file__).resolve().parent.parent
IMG, BATCH = 32, 2
# (wb, gs, wt, db, dt): the flagship TR setting, and the UQ row of int8
# serving (bench.py's resnet int8 uq).
TR = (9, 8, 12, 9, 3)
INT8 = (7, 1, 7, 7, 5)


@pytest.fixture(scope="module")
def jparams(cnn_params):
    return cnn_params(jres, 0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.device_get(jparams), "cpu")


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(3).normal(
        size=(BATCH, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def converted(jparams, tparams):
    """(wb, gs, wt, db, dt) -> both packages' (qparams, qcfg, qstate)."""
    cache = {}

    def get(setting):
        if setting not in cache:
            wb, gs, wt, db, dt = setting
            st = jpolicy.static_conv_layer_settings(jres.conv_specs(), wb, gs,
                                                    wt)
            cache[setting] = (
                jconv_cnn.convert_cnn(jres, jparams, st, db, dt),
                tconv_cnn.convert_cnn(tres, tparams, st, db, dt))
        return cache[setting]

    return get


@pytest.fixture(scope="module")
def calibrated(converted, x_np):
    """The TR setting calibrated on ``x_np`` in both packages: (JAX's
    qparams, qcfg, qstate), the port's."""
    (jqp, jqc, jqs), (tqp, tqc, tqs) = converted(TR)
    _, jqs = jconv_cnn.make_cnn_apply(jres, jqc, track=True)(
        jqp, jqs, jnp.asarray(x_np))
    _, tqs = tconv_cnn.make_cnn_apply(tres, tqc, track=True)(
        tqp, tqs, torch.from_numpy(x_np))
    return ((jqp, jqc, jconv_cnn.finalize_cnn(jqs, jqc)),
            (tqp, tqc, tconv_cnn.finalize_cnn(tqs, tqc)))


# ------------------------------------------------- the pieces of the graph


CONV_CASES = [
    # (x shape, w shape (HWIO), stride, padding, groups)
    ((2, 9, 9, 4), (3, 3, 4, 6), (1, 1), [(1, 1), (1, 1)], 1),
    ((2, 9, 9, 4), (3, 3, 4, 6), (2, 2), [(1, 1), (1, 1)], 1),
    ((1, 16, 16, 3), (7, 7, 3, 8), (2, 2), [(3, 3), (3, 3)], 1),
    ((2, 8, 8, 6), (1, 1, 6, 4), (2, 2), [(0, 0), (0, 0)], 1),
    ((2, 8, 7, 4), (3, 3, 4, 5), (2, 2), [(0, 1), (2, 1)], 1),
    ((2, 10, 9, 4), (3, 3, 4, 6), (2, 2), "SAME", 1),
    ((2, 6, 6, 4), (3, 3, 4, 4), (1, 1), "VALID", 1),
    ((2, 8, 8, 6), (3, 3, 2, 6), (1, 1), "SAME", 3),
    ((1, 9, 9, 8), (3, 3, 1, 8), (2, 2), [(1, 1), (1, 1)], 8),
]


@pytest.mark.parametrize("xs,ws,stride,padding,groups", CONV_CASES)
def test_conv2d_matches_jax(xs, ws, stride, padding, groups):
    rng = np.random.default_rng(len(str((xs, ws, stride, padding))))
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride,
                                   padding, groups))
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride,
                       padding, groups)
    assert got.shape == want.shape
    assert got.is_contiguous()  # NHWC out of a channels_last conv
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_batch_norm_and_max_pool_match_jax(rng):
    x = rng.normal(size=(2, 7, 7, 5)).astype(np.float32)
    p = {"scale": rng.normal(size=5), "bias": rng.normal(size=5),
         "mean": rng.normal(size=5), "var": rng.uniform(0.1, 2, 5)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jcommon.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = tcommon.batch_norm(params_from_jax(p, "cpu"), torch.from_numpy(x))
    # rsqrt rounds differently in the two libraries: an ulp or so.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tres._max_pool(torch.from_numpy(x)).numpy(),
                                  np.asarray(jres._max_pool(jnp.asarray(x))))


def test_fp32_apply_matches_jax(jparams, tparams, x_np):
    want = np.asarray(jres.apply(jparams, jnp.asarray(x_np)))
    got = tres.apply(tparams, torch.from_numpy(x_np)).numpy()
    assert got.shape == (BATCH, tres.NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    ctx = tres.apply(tparams, torch.from_numpy(x_np), tqctx.fp32_ctx())
    np.testing.assert_allclose(ctx.numpy(), got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("image", [224, IMG])
def test_conv_specs_and_traced_specs_match_jax(image):
    want = [dataclasses.asdict(s) for s in jres.conv_specs(image)]
    got = [dataclasses.asdict(s) for s in tres.conv_specs(image)]
    assert got == want and len(got) == 20
    assert ttrace.trace_conv_specs(tres, image) == tres.conv_specs(image)
    assert ttrace.trace_dense_specs(tres, image) == tres.dense_specs() \
        == jres.dense_specs()
    assert ttrace.specs_for(tres) == tres.conv_specs()
    assert [dataclasses.asdict(s) for s in ttrace.specs_for(tres, image)] \
        == [dataclasses.asdict(s) for s in jtrace.specs_for(jres, image)]


@pytest.mark.parametrize("setting", [(9, 8, 12), (5, 1, 5), (16, 1, 16)])
def test_static_conv_layer_settings_match_jax(setting):
    want = jpolicy.static_conv_layer_settings(jres.conv_specs(), *setting)
    got = tpolicy.static_conv_layer_settings(tres.conv_specs(), *setting)
    assert got == want and got[0] == tpolicy.EXEMPT_SETTING
    grouped = tcommon.ConvSpec("dw", 8, 8, 3, 3, groups=8)
    se = tcommon.ConvSpec("se.conv", 8, 8, 1, 1, is_se=True)
    specs = [tres.conv_specs()[1], grouped, se, tres.conv_specs()[2]]
    assert tpolicy.static_conv_layer_settings(specs, *setting) == \
        jpolicy.static_conv_layer_settings(
            [jcommon.ConvSpec(**dataclasses.asdict(s)) for s in specs],
            *setting)


def _grid_settings():
    """The 15 published-grid settings of resnet18 as (key, wb, gs, wt, db,
    dt), in run_sweep's order."""
    g = teval.PUBLISHED_GRIDS["resnet18"]
    rows = [("quant", wb, 1, wb, g["uq_db"], g["uq_dt"])
            for wb in g["uq_bits"]]
    rows += [(f"tr-data{dt}", 9, 8, wt, 9, dt) for dt in g["tr_data_terms"]
             for wt in g["tr_weight_terms"]]
    return rows


def test_cnn_cost_and_param_count_equal_published(tparams, jparams):
    published = json.loads((ROOT / "results" / "resnet18-results.json")
                            .read_text())
    specs = tres.conv_specs()
    n_params = t_param_count(tparams)
    assert n_params == jprof.param_count(jparams) == 11689512
    seen = {}
    for key, wb, gs, wt, db, dt in _grid_settings():
        st = tpolicy.static_conv_layer_settings(specs, wb, gs, wt)
        got = t_cnn_cost(specs, st, db, dt)
        assert got == j_cnn_cost(jres.conv_specs(), st, db, dt)
        i = seen.setdefault(key, 0)
        seen[key] += 1
        assert float(got[0]) == published[key]["tmacs"][i], (key, i)
        assert got[1] == published[key]["avg_terms"][i], (key, i)
        assert float(n_params) == published[key]["params"][i]
    assert sum(seen.values()) == 15


# ------------------------------------------------------------- conversion


@pytest.mark.parametrize("setting", [TR, INT8], ids=["tr", "uq"])
def test_convert_cnn_bit_exact(converted, setting):
    (jqp, jqc, jqs), (tqp, tqc, tqs) = converted(setting)
    assert list(tqc) == list(jqc) and len(tqc) == 19
    assert "conv1" not in tqc and tqp["conv1"] is not None
    for name in tqc:
        assert tqc[name] == ttrq_tr(jqc[name])
        np.testing.assert_array_equal(tqp[name]["w"].numpy(),
                                      np.asarray(jqp[name]["w"]),
                                      err_msg=name)
        assert float(tqp[name]["w_sf"]) == float(jqp[name]["w_sf"]), name
        assert float(tqs[name]["sf"]) == 1.0


def ttrq_tr(jtr):
    """The port's TRParams with the JAX TRParams' fields."""
    from tq_tpu_torch.layers.common import TRParams

    return TRParams(**dataclasses.asdict(jtr))


def _mse(hist: torch.Tensor, sf: float, bits: int, terms: int) -> float:
    """The MSE search's objective at one scale, in float64."""
    x_grid, _ = calibration_grids()
    xh = _tr_elementwise_vals(x_grid, torch.tensor(sf), bits, terms)
    return float((hist.double() * (x_grid - xh).double() ** 2).sum())


class _JaxRecorder(jqctx.QuantCtx):
    """The JAX QuantCtx, remembering each conv's input and arguments."""

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1):
        self.__dict__.setdefault("seen", {})[name] = (x, stride, padding)
        return super().conv(name, params, x, stride, padding, groups)


def test_two_phase_cycle_layer_by_layer(calibrated, x_np):
    """Histograms equal but for values moved across a bin edge (counted;
    3 of 82,944 on these inputs), scales equal (or a near-tie on the port's
    histogram), each layer's quantized input exact and output within
    1e-5 * max|y| on the JAX package's own input, and the logits within
    1e-3 * max|logit| (2.9e-7 on these inputs; the limit leaves room for a
    rounding-boundary flip, which spreads through the later layers)."""
    (jqp, jqc, jqs), (tqp, tqc, tqs) = calibrated
    moved = 0
    for name in tqc:
        jh, th = np.asarray(jqs[name]["hist"]), tqs[name]["hist"].numpy()
        assert jh.sum() == th.sum()
        moved += int(np.abs(jh - th).sum()) // 2
        a, b = float(tqs[name]["sf"]), float(jqs[name]["sf"])
        if a != b:  # a near-tie: both candidates' errors within 1e-6
            tr = tqc[name]
            ea = _mse(tqs[name]["hist"], a, tr.data_bits, tr.data_terms)
            eb = _mse(tqs[name]["hist"], b, tr.data_bits, tr.data_terms)
            assert abs(ea - eb) <= 1e-6 * max(ea, eb), (name, a, b)
    total = sum(int(tqs[n]["hist"].sum()) for n in tqc)
    assert moved <= total * 1e-4, (moved, total)

    # Layer by layer on the JAX package's inputs, with its scales.
    rec = _JaxRecorder(cfg=jqc, state=jqs, track=False)
    want = np.asarray(jres.apply(jqp, jnp.asarray(x_np), rec))
    tqs_j = {n: {**tqs[n], "sf": torch.tensor(float(jqs[n]["sf"]))}
             for n in tqc}
    for name, (xj, stride, padding) in rec.seen.items():
        if name not in tqc:
            continue
        tr, sf = tqc[name], jqs[name]["sf"]
        xt = torch.from_numpy(np.array(xj))
        np.testing.assert_array_equal(
            ttrq.tr_quantize(xt, tqs_j[name]["sf"], tr.data_bits, 1,
                             tr.data_terms).numpy(),
            np.asarray(j_act_quantize(xj, sf, tr.data_bits, tr.data_terms)),
            err_msg=name)
        yj, _ = jconv.tr_conv_apply(jqp[name], jqc[name], jqs[name], xj,
                                    False, stride, padding)
        yt, _ = tconv.tr_conv_apply(tqp[name], tr, tqs_j[name], xt, False,
                                    stride, padding)
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                   atol=1e-5 * np.abs(yj).max(), err_msg=name)
    got, _ = tconv_cnn.make_cnn_apply(tres, tqc, track=False)(
        tqp, tqs_j, torch.from_numpy(x_np))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_bf16_serving_mode_matches_jax(calibrated, x_np):
    """The whole graph in bfloat16 (quantized in float32, rounded to
    bfloat16): logits within 5e-2 * max|logit| of the JAX package's bf16
    mode (1.8e-2 on these inputs: the two libraries round bf16 convolutions
    and element-wise chains at other places)."""
    (jqp, jqc, jqs), (tqp, tqc, tqs) = calibrated
    tqs_j = {n: {**tqs[n], "sf": torch.tensor(float(jqs[n]["sf"]))}
             for n in tqc}
    want, _ = jconv_cnn.make_cnn_apply(jres, jqc, track=False,
                                       compute_dtype=jnp.bfloat16)(
        jqp, jqs, jnp.asarray(x_np))
    got, _ = tconv_cnn.make_cnn_apply(tres, tqc, track=False,
                                      compute_dtype=torch.bfloat16)(
        tqp, tqs_j, torch.from_numpy(x_np))
    assert got.dtype == torch.float32 and got.shape == want.shape
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    # The cast: >= 1-d float32 leaves to bf16, 0-d scales stay float32.
    cast = tconv_cnn._cast(tqp, torch.bfloat16)
    assert cast["layer1.0.conv1"]["w"].dtype == torch.bfloat16
    assert cast["layer1.0.conv1"]["w_sf"].dtype == torch.float32
    assert cast["bn1"]["mean"].dtype == torch.bfloat16


def test_bf16_elementwise_plain_version_matches_jax(rng):
    """The bf16 instantiation's plain version: the JAX package's
    element-wise term reveal of a bfloat16 tensor (float32 division by the
    float32 scale) cast to bfloat16, bit for bit; its int variant too."""
    x = (rng.normal(size=20000) * 8).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for bits, terms in [(9, 3), (9, 2), (7, 5), (8, 8), (4, 1)]:
        sf = np.float32(0.0371)
        want = j_act_quantize(xb, jnp.float32(sf), bits, terms).astype(
            jnp.bfloat16)
        got = ttrq.tr_quantize(xt, torch.tensor(sf), bits, 1, terms)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        from tq_tpu.ops.term_reveal import term_reveal_elementwise_int

        np.testing.assert_array_equal(
            ttrq.tr_quantize_int(xt, torch.tensor(sf), bits, terms).numpy(),
            np.asarray(term_reveal_elementwise_int(xb, jnp.float32(sf), bits,
                                                   terms)))


def test_tr_scale_copy_matches_jax_interpret(rng):
    for shape in [(3, 1000), (2, 9, 9, 5), (4096,)]:
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jtrq.tr_scale_copy(jnp.asarray(x), 0.0371,
                                             interpret=True))
        got = ttrq.tr_scale_copy(torch.from_numpy(x), 0.0371)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            ttrq.tr_scale_copy_ref(torch.from_numpy(x), 0.0371).numpy(), want)


# ---------------------------------------------------------- int8 serving


def test_pack_cnn_and_int8_conv_exact(converted, rng):
    """pack_cnn byte for byte; each converted conv's int8 output equal to
    its int64 plain version and to the JAX package's int32 conv; the packed
    model's logits within 1e-3 * max|logit| of the JAX package's (2.4e-7
    on these inputs; room for a rounding-boundary flip)."""
    (jqp, jqc, jqs), (tqp, tqc, tqs) = converted(INT8)
    jpk, tpk = jconv_cnn.pack_cnn(jqp, jqc), tconv_cnn.pack_cnn(tqp, tqc)
    for name in tqc:
        assert tpk[name]["w"].dtype == torch.int8
        np.testing.assert_array_equal(tpk[name]["w"].numpy(),
                                      np.asarray(jpk[name]["w"]))
        assert float(tpk[name]["w_sf"]) == float(jpk[name]["w_sf"])
    specs = {s.name: s for s in tres.conv_specs(IMG)}
    for name in ("layer1.0.conv1", "layer2.0.conv1", "layer2.0.downsample.0",
                 "layer4.1.conv2"):
        s = specs[name]
        size = s.out_h * s.stride
        xi = rng.integers(-127, 128, (BATCH, size, size, s.in_ch)).astype(
            np.int8)
        pad = [(1, 1), (1, 1)] if s.kh == 3 else [(0, 0), (0, 0)]
        stride = (s.stride, s.stride)
        got = tconv.int8_conv2d(torch.from_numpy(xi), tpk[name]["w"], stride,
                                pad)
        assert got.dtype == torch.int32
        ref = tconv.int8_conv2d_ref(torch.from_numpy(xi), tpk[name]["w"],
                                    stride, pad)
        assert torch.equal(got.to(torch.int64), ref), name
        want = jconv.conv2d(jnp.asarray(xi), jpk[name]["w"], stride, pad,
                            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Grouped, ragged (K, N not multiples of 8) and fewer than 17 rows.
    xi = rng.integers(-127, 128, (1, 3, 3, 6)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 2, 9)).astype(np.int8)
    got = tconv.int8_conv2d(torch.from_numpy(xi), torch.from_numpy(w),
                            (1, 1), "SAME", groups=3)
    ref = tconv.int8_conv2d_ref(torch.from_numpy(xi), torch.from_numpy(w),
                                (1, 1), "SAME", groups=3)
    assert torch.equal(got.to(torch.int64), ref)

    x = np.random.default_rng(4).normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32)
    sfs = {n: {"hist": jqs[n]["hist"], "sf": jnp.float32(0.05)} for n in jqc}
    tsfs = {n: {"hist": tqs[n]["hist"], "sf": torch.tensor(0.05)}
            for n in tqc}
    want, _ = jconv_cnn.make_cnn_apply(jres, jqc, track=False)(
        jpk, sfs, jnp.asarray(x))
    got, _ = tconv_cnn.make_cnn_apply(tres, tqc, track=False)(
        tpk, tsfs, torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_pack_cnn_int16_dequantizes_like_jax(converted, x_np):
    (jqp, jqc, jqs), (tqp, tqc, tqs) = converted(TR)
    jpk, tpk = jconv_cnn.pack_cnn(jqp, jqc), tconv_cnn.pack_cnn(tqp, tqc)
    name = "layer3.0.conv2"
    assert tpk[name]["w"].dtype == torch.int16
    np.testing.assert_array_equal(tpk[name]["w"].numpy(),
                                  np.asarray(jpk[name]["w"]))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 4, 4, 256)).astype(np.float32)
    yj, _ = jconv.tr_conv_apply(jpk[name], jqc[name],
                                {"sf": jnp.float32(0.05)}, jnp.asarray(x),
                                False, (1, 1), [(1, 1), (1, 1)])
    yt, _ = tconv.tr_conv_apply(tpk[name], tqc[name],
                                {"sf": torch.tensor(0.05)},
                                torch.from_numpy(x), False, (1, 1),
                                [(1, 1), (1, 1)])
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())


# ------------------------------------------------- checkpoints and data


def test_from_state_dict_matches_jax(rng):
    sd = {"conv1.weight": rng.normal(size=(8, 3, 7, 7)),
          "conv1.bias": rng.normal(size=8),
          "bn1.weight": rng.normal(size=8), "bn1.bias": rng.normal(size=8),
          "bn1.running_mean": rng.normal(size=8),
          "bn1.running_var": rng.uniform(0.5, 2, 8),
          "bn1.num_batches_tracked": np.asarray(3),
          "fc.weight": rng.normal(size=(10, 8)), "fc.bias": rng.normal(size=10),
          "ln.weight": rng.normal(size=4),
          "rnn.weight_ih_l0": rng.normal(size=(16, 5)),
          "rnn.weight_hh_l0": rng.normal(size=(16, 4)),
          "rnn.bias_ih_l0": rng.normal(size=16),
          "rnn.bias_hh_l0": rng.normal(size=16),
          "misc.thing": rng.normal(size=3)}
    sd_t = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    for rename in (None, lambda p: p.replace("conv1", "stem")):
        want = jtorch_import.from_state_dict(sd, rename=rename)
        got = ttorch_import.from_state_dict(sd_t, rename=rename)
        a, b = tckpt.flatten_tree(got), jckpt.flatten_tree(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            assert a[k].flags.c_contiguous, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_checkpoint_loads_like_jax(tmp_path, tparams):
    sd = {}
    for name, p in tparams.items():
        if "w" in p and p["w"].ndim == 4:
            sd[f"{name}.weight"] = p["w"].permute(3, 2, 0, 1).contiguous()
        elif "w" in p:
            sd[f"{name}.weight"] = p["w"].t().contiguous()
            sd[f"{name}.bias"] = p["b"]
        else:
            sd.update({f"{name}.weight": p["scale"], f"{name}.bias": p["bias"],
                       f"{name}.running_mean": p["mean"],
                       f"{name}.running_var": p["var"],
                       f"{name}.num_batches_tracked": torch.tensor(0)})
    torch.save(sd, tmp_path / "resnet18.pt")
    m, got = teval.load_params("resnet18", str(tmp_path / "resnet18.pt"),
                               device="cpu")
    want = jtorch_import.load_torch_checkpoint(tmp_path / "resnet18.pt")
    assert m is tres and got.keys() == tparams.keys() == want.keys()
    for name in tparams:
        for leaf in tparams[name]:
            assert torch.equal(got[name][leaf], tparams[name][leaf])
            np.testing.assert_array_equal(got[name][leaf].numpy(),
                                          want[name][leaf])


def test_synthetic_imagenet_batch_identical():
    for seed in (0, 3):
        a = jsyn.synthetic_imagenet_batch(3, 20, seed=seed)
        b = tsyn.synthetic_imagenet_batch(3, 20, seed=seed)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_imagenet_loader_identical(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(2)
    root = tmp_path / "imagenet" / "val"
    for wnid, size in (("n01", (300, 260)), ("n02", (240, 320))):
        (root / wnid).mkdir(parents=True)
        for i in range(2):
            arr = rng.integers(0, 256, size[::-1] + (3,)).astype(np.uint8)
            Image.fromarray(arr).save(root / wnid / f"{i}.png")
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    for d in (tmp_path, tmp_path / "imagenet", root, tmp_path / "none"):
        assert timagenet.find_imagenet_val(str(d)) == \
            jimagenet.find_imagenet_val(str(d))
    assert timagenet.find_imagenet_val(None) is None
    monkeypatch.setenv("TQ_DATA_DIR", str(tmp_path))
    assert timagenet.find_imagenet_val(None) == root \
        == jimagenet.find_imagenet_val(None)
    for bicubic in (False, True):
        a = list(jimagenet.iter_imagenet_val(root, 3, 64, bicubic))
        b = list(timagenet.iter_imagenet_val(root, 3, 64, bicubic))
        assert len(a) == len(b) == 2
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xb.shape[1:] == (64, 64, 3)
            assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


# --------------------------------------------------------- the sweep


def test_run_sweep_cpu_deterministic_columns_and_resume(tmp_path,
                                                        monkeypatch):
    """The published grid's first TR row at n_synth=2 on the port's random
    init: tmacs, avg_terms and params equal the published file's; a partial
    file resumes (its UQ rows are kept as they are)."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    published = json.loads((ROOT / "results" / "resnet18-results.json")
                           .read_text())
    out = tmp_path / "r.json"
    partial = {"quant": {"accs": [1.5, 2.5], "tmacs": [2.0, 3.0],
                         "avg_terms": [3.0, 4.0], "params": [4.0, 5.0]}}
    out.write_text(json.dumps(partial))
    got = teval.run_sweep("resnet18", out_file=str(out), batch_size=2,
                          n_synth=2, uq_bits=(5, 6), uq_wt="wb", uq_db=9,
                          uq_dt=8, tr_data_terms=(2,), tr_weight_terms=(8,),
                          verbose=False, device="cpu")
    assert got["quant"] == partial["quant"]
    assert json.loads(out.read_text()) == got
    for col in ("tmacs", "avg_terms", "params"):
        assert got["tr-data2"][col] == published["tr-data2"][col][:1], col
    assert got["tr-data2"]["accs"][0] in (0.0, 50.0, 100.0)


def test_get_model_and_entry_points():
    assert teval.get_model("resnet18") is tres
    for arch, name in (("alexnet", "alexnet"), ("vgg16_bn", "vgg"),
                       ("mobilenet_v2", "mobilenet"),
                       ("efficientnet_b0", "efficientnet")):
        assert teval.get_model(arch).__name__ == f"tq_tpu_torch.models.{name}"
    with pytest.raises(ValueError, match="unknown arch"):
        teval.get_model("lenet")
    assert teval.ARCHS == jeval.ARCHS
    assert teval.COMMITTED_GRID == jeval.COMMITTED_GRID
    assert teval.PUBLISHED_GRIDS == jeval.PUBLISHED_GRIDS
    assert inspect.signature(teval.run_sweep).parameters[
        "device"].default == "cuda"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.run_sweep("resnet18", n_synth=0, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--out-file", str(tmp_path / "o.json")])
    assert not torch.backends.cudnn.allow_tf32  # main turned TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32


def test_init_shapes_and_apply():
    params = tres.init(torch.Generator().manual_seed(0), device="cpu")
    again = tres.init(torch.Generator().manual_seed(0), device="cpu")
    assert t_param_count(params) == 11689512
    w = params["layer1.0.conv1"]["w"]
    assert w.shape == (3, 3, 64, 64) and torch.equal(w, again[
        "layer1.0.conv1"]["w"])
    assert abs(float(w.std()) - (2 / (9 * 64)) ** 0.5) < 0.005
    assert float(params["fc"]["w"].abs().max()) <= 512 ** -0.5
    logits = tres.apply(params, torch.zeros(1, IMG, IMG, 3))
    assert logits.shape == (1, 1000) and torch.isfinite(logits).all()


# ------------------------------------------------- chip_smoke's numbers


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resnet_checkpoint_loads_in_both_packages(tmp_path):
    cs = _chip_smoke()
    path = tmp_path / "resnet.npz"
    cs.resnet_checkpoint(path, seed=1)
    jp, tp = jckpt.load_params(path), tckpt.load_params(path)
    shapes = jax.eval_shape(jres.init, jax.random.PRNGKey(0))
    assert jp.keys() == shapes.keys()
    for name, leaves in shapes.items():
        for leaf, sds in leaves.items():
            assert jp[name][leaf].shape == sds.shape, (name, leaf)
            np.testing.assert_array_equal(tp[name][leaf], jp[name][leaf])
    w = jp["layer4.1.conv2"]["w"]
    assert abs(w.std() - (2 / (9 * 512)) ** 0.5) < 1e-3


def jax_expected_cnn(image: int = 224, batch: int = 16,
                     calib_batch: int = 64) -> dict:
    """The JAX package on ``chip_smoke.resnet_checkpoint``'s weights: the
    flagship program's logits statistics and top-1 per image, and the
    TR setting's 19 calibrated scales after the sweep's calibration pass
    (the first synthetic batch)."""
    cs = _chip_smoke()
    f = cs.FLAGSHIP
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "resnet.npz"
        cs.resnet_checkpoint(ckpt)
        params = jax.tree.map(jnp.asarray, jckpt.load_params(ckpt))
    st = jpolicy.static_conv_layer_settings(jres.conv_specs(), *f["tr"])
    qp, qc, qs = jconv_cnn.convert_cnn(jres, params, st, f["db"], f["dt"])
    fixed = {k: {**v, "sf": jnp.float32(f["sf"])} for k, v in qs.items()}
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(batch, image, image, 3)), jnp.float32)
    logits, _ = jconv_cnn.make_cnn_apply(jres, qc, track=False)(qp, fixed, x)
    logits = np.asarray(logits, np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    xc, _ = jsyn.synthetic_imagenet_batch(calib_batch, image, seed=0)
    _, qs = jconv_cnn.make_cnn_apply(jres, qc, track=True)(qp, qs,
                                                           jnp.asarray(xc))
    qs = jconv_cnn.finalize_cnn(qs, qc)
    return {"flagship": {"top1": np.argmax(logits, 1).tolist(),
                         "top2_margin": (top2[:, 1] - top2[:, 0]).tolist(),
                         "mean": float(logits.mean()),
                         "std": float(logits.std()),
                         "max_abs": float(np.abs(logits).max()),
                         "row_max": logits.max(1).tolist(),
                         "first": logits[0, :8].tolist()},
            "sweep_sf": {"setting": [*f["tr"], f["db"], f["dt"]],
                         "sf": {k: float(v["sf"]) for k, v in qs.items()}}}


def test_expected_cnn_pinned(monkeypatch):
    """chip_smoke's flagship is the JAX package's entry() program, and
    EXPECTED_CNN has the form jax_expected_cnn gives (run at a small
    size; the scale search, held in the two-phase test, stubbed out)."""
    cs = _chip_smoke()
    f = cs.FLAGSHIP
    assert (f["tr"], f["db"], f["dt"], f["sf"], f["batch"], f["image"]) == \
        ((9, 8, 12), 9, 3, 0.05, 16, 224)
    src = inspect.getsource(importlib.import_module("__graft_entry__").entry)
    assert "conv_specs(), 9, 8, 12)" in src and "settings, 9, 3)" in src
    assert "jnp.float32(0.05)" in src and "size=(16, 224, 224, 3)" in src
    monkeypatch.setattr(jconv_cnn, "finalize_cnn", lambda qs, qc: {
        k: {**v, "sf": jnp.float32(0.5)} for k, v in qs.items()})
    small = jax_expected_cnn(image=IMG, batch=2, calib_batch=2)
    exp = cs.EXPECTED_CNN
    assert small.keys() == exp.keys()
    assert small["flagship"].keys() == exp["flagship"].keys()
    assert len(exp["flagship"]["top1"]) == f["batch"]
    assert small["sweep_sf"]["setting"] == exp["sweep_sf"]["setting"]
    assert list(exp["sweep_sf"]["sf"]) == list(small["sweep_sf"]["sf"])
    assert len(exp["sweep_sf"]["sf"]) == 19


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps(jax_expected_cnn()))
