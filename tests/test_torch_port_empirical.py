"""The port's empirical term-pair profiler against the JAX package's.

``tq_tpu_torch.profilers.empirical`` counts, on a converted CNN's live
activations, the term-pair multiplications a term-MAC array would run.
Every count is an integer and must equal the JAX package's bit for bit on
the same inputs: the plane-pair maps in both encodings, the count-map
totals, the dense totals (an input on an exact half of the grid pins
``_int_grid``'s round-half-even), and ResNet-18's per-layer report at 64
px, batch 2 (the JAX test's size) on ``chip_smoke.zoo_params``' weights.
"""

import dataclasses
import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.convert import cnn as jconv_cnn
from tq_tpu.convert import policy as jpolicy
from tq_tpu.layers.common import TRParams as JTRParams
from tq_tpu.layers.common import quantize_weight as j_quantize_weight
from tq_tpu.models import resnet as jres
from tq_tpu.ops.term_reveal import term_reveal as j_term_reveal
from tq_tpu_torch.convert import cnn as tconv_cnn
from tq_tpu_torch.convert import policy as tpolicy
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.quantize import act_quantize
from tq_tpu_torch.models import resnet as tres
from tq_tpu_torch.ops.hese import binary_digit_planes
from tq_tpu_torch.profilers import conv2d_term_macs
from tq_tpu_torch.profilers import empirical as temp
from tq_tpu_torch.profilers import trace_specs as ttrace
from tq_tpu_torch.utils.params import params_from_jax

jemp = importlib.import_module("tq_tpu.profilers.empirical")

ROOT = Path(__file__).resolve().parent.parent
IMG, BATCH = 64, 2
TR = (9, 8, 12, 9, 3)  # (wb, gs, wt, db, dt): the flagship setting
# Within this of the avg-terms factorization (the JAX test's limit).
FACTOR_RTOL = 0.12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _operands(rng, shape_x=(2, 8, 8, 16), shape_w=(3, 3, 16, 8), db=9,
              dt=3, wb=9, g=8, wt=12, sf=0.05):
    """The JAX test's quantized operands, as numpy: the JAX package's
    term reveal of a normal x, its ``quantize_weight`` of a normal w."""
    x = jnp.asarray(rng.normal(size=shape_x), jnp.float32)
    w = jnp.asarray(0.2 * rng.normal(size=shape_w), jnp.float32)
    xq = j_term_reveal(x, jnp.float32(sf), db, 1, dt)
    w_q, w_sf = j_quantize_weight(w, JTRParams(wb, g, wt, db, dt), axis=2)
    return (np.array(xq), np.array(w_q), np.float32(sf),
            np.float32(w_sf))


def _on_halves(rng, shape):
    """Values whose |v| / 0.25 is an integer or lies on an exact half
    (2.5, 7.5, ...), the cases where round-half-even and the quantizer's
    floor(|v| / sf + 0.5) part."""
    k = rng.integers(-40, 41, size=shape)
    half = rng.random(size=shape) < 0.5
    return ((k + np.where(half, np.sign(k) * 0.5, 0.0)) * 0.25).astype(
        np.float32)


def _both(fn_name, xq, w_q, sf, w_sf, *args, **kw):
    """The JAX package's and the port's ``fn_name`` on the same numpy
    operands (the scales as 0-d arrays / tensors)."""
    ops = (xq, w_q, sf, w_sf)
    j = getattr(jemp, fn_name)(*map(jnp.asarray, ops), *args, **kw)
    t = getattr(temp, fn_name)(*map(torch.as_tensor, ops), *args, **kw)
    return j, t


def test_int_grid_rounds_half_to_even():
    """2.5 and 3.5 grid steps round to 2 and 4, as ``jnp.round``: the one
    place the port uses ``torch.round`` rather than floor(x + 0.5)."""
    v = np.float32([0.625, 0.875, -0.625, 0.375, 1.0])  # steps of 0.25
    got = temp._int_grid(torch.from_numpy(v), 0.25, 9)
    want = np.asarray(jemp._int_grid(jnp.asarray(v), jnp.float32(0.25), 9))
    assert got.tolist() == [2, 4, 2, 2, 4] == want.tolist()
    assert got.dtype == torch.int32
    # and the clamp at 2**bits - 1
    assert temp._int_grid(torch.tensor([100.0]), 0.25, 6).tolist() == [63]


@pytest.mark.parametrize("encoding", ["hese", "binary"])
@pytest.mark.parametrize("padding", ["SAME", "VALID", [(1, 1), (1, 1)]],
                         ids=["same", "valid", "explicit"])
@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_pair_map_equals_jax(rng, encoding, padding, stride):
    xq, w_q, sf, w_sf = _operands(rng)
    j, t = _both("conv_term_pair_map", xq, w_q, sf, w_sf, 9, 9, stride,
                 padding, encoding=encoding)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("encoding", ["hese", "binary"])
def test_pair_map_on_exact_halves_equals_jax(rng, encoding):
    """Inputs on exact halves of the grid: the counts follow the JAX
    package's round-half-even, not the quantizer's rounding."""
    xq = _on_halves(rng, (2, 6, 6, 8))
    w_q = _on_halves(rng, (3, 3, 8, 4))
    sf = w_sf = np.float32(0.25)
    j, t = _both("conv_term_pair_map", xq, w_q, sf, w_sf, 9, 9,
                 encoding=encoding)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jt, tt = _both("conv_term_pair_total", xq, w_q, sf, w_sf, 9, 9)
    assert tt == jt
    # The quantizer's rounding would count other integers here.
    up = torch.floor(torch.from_numpy(np.abs(xq)) / 0.25 + 0.5)
    assert not torch.equal(up.to(torch.int32), temp._int_grid(
        torch.from_numpy(xq), 0.25, 9))


@pytest.mark.parametrize("padding", ["SAME", [(1, 1), (1, 1)], "VALID"],
                         ids=["same", "explicit", "valid"])
def test_pair_total_equals_jax_and_the_map(rng, padding):
    """The count-map total equals the JAX package's and the plane-pair
    map summed (the identity of tests/test_empirical_cost.py)."""
    xq, w_q, sf, w_sf = _operands(rng)
    jt, tt = _both("conv_term_pair_total", xq, w_q, sf, w_sf, 9, 9, (1, 1),
                   padding)
    assert isinstance(tt, int) and tt == jt > 0
    m = temp.conv_term_pair_map(torch.from_numpy(xq), torch.from_numpy(w_q),
                                torch.tensor(sf), torch.tensor(w_sf), 9, 9,
                                padding=padding, encoding="hese")
    assert int(m.sum()) == tt


@pytest.mark.parametrize("g,wt", [(8, 12), (1, 9), (16, 20)])
def test_dense_total_equals_jax(rng, g, wt):
    xq, w_q, sf, w_sf = _operands(rng, shape_x=(4, 32), shape_w=(32, 8),
                                  g=g, wt=wt)
    # quantize_weight groups along axis 2 in _operands; a dense weight is
    # (in, out) and any grid tensor counts the same way.
    jt, tt = _both("dense_term_pair_total", xq, w_q, sf, w_sf, 9, 9)
    assert tt == jt > 0
    assert tt <= 4 * min(wt, 9 if g == 1 else wt) / g * 3 * 32 * 8


def test_binary_map_matches_direct_loop(rng):
    """The binary encoding equals a direct per-tap popcount product (the
    JAX test's tiny oracle)."""
    xq, w_q, sf, w_sf = _operands(rng, shape_x=(1, 5, 5, 4),
                                  shape_w=(3, 3, 4, 2))
    m = temp.conv_term_pair_map(torch.from_numpy(xq), torch.from_numpy(w_q),
                                sf, w_sf, 9, 9, padding="VALID",
                                encoding="binary").numpy()
    xi = np.round(np.abs(xq) / sf).astype(np.int64)
    wi = np.round(np.abs(w_q) / w_sf).astype(np.int64)
    pc = np.vectorize(lambda v: bin(v).count("1"))
    cx, cw = pc(xi), pc(wi)
    want = np.zeros((1, 3, 3, 2), np.int64)
    for i in range(3):
        for j in range(3):
            for o in range(2):
                want[0, i, j, o] = np.sum(cx[0, i:i + 3, j:j + 3, :]
                                          * cw[:, :, :, o])
    np.testing.assert_array_equal(m, want)
    planes = binary_digit_planes(torch.from_numpy(xi), 9)
    np.testing.assert_array_equal(planes.sum(-1).numpy(), cx)


def test_unknown_encoding_refused(rng):
    xq, w_q, sf, w_sf = _operands(rng)
    with pytest.raises(ValueError, match="unknown encoding"):
        temp.conv_term_pair_map(torch.from_numpy(xq), torch.from_numpy(w_q),
                                sf, w_sf, 9, 9, encoding="csd")


@pytest.fixture(scope="module")
def resnet_run():
    """ResNet-18 at 64 px, batch 2, the flagship setting, every scale
    0.05, on the same converted weights (the JAX package's conversion,
    which the port's equals bit for bit: tests/test_torch_port_cnn.py):
    the JAX package's ``empirical_cnn_cost`` report and the captures it
    counted, the port's captures and report."""
    torch.set_num_threads(1)  # the test workers share the cores
    jparams = jax.tree_util.tree_map(
        jnp.asarray, _chip_smoke().zoo_params("resnet18"))
    wb, gs, wt, db, dt = TR
    specs = ttrace.specs_for(tres, image=IMG)
    settings = tpolicy.static_conv_layer_settings(specs, wb, gs, wt)
    assert settings == jpolicy.static_conv_layer_settings(
        jres.conv_specs(IMG), wb, gs, wt)
    jqp, jqc, jqs = jconv_cnn.convert_cnn(jres, jparams, settings, db, dt,
                                          image=IMG)
    jqs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in jqs.items()}
    tqp = params_from_jax(jax.device_get(jqp), "cpu")
    tqc = {k: TRParams(*dataclasses.astuple(v)) for k, v in jqc.items()}
    tqs = {k: {"sf": torch.tensor(0.05)} for k in jqs}
    x = np.random.default_rng(0).normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32)

    jcaptured = {}
    real = jemp.capture_activations

    def recording(*args):
        jcaptured.update(real(*args))
        return jcaptured

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jemp, "capture_activations", recording)
        jreport = jemp.empirical_cnn_cost(jres, jqp, jqs, jqc,
                                          jnp.asarray(x))
    tcaptured = temp.capture_activations(tres, tqp, tqs, tqc,
                                         torch.from_numpy(x))
    treport = temp.empirical_cnn_cost(tres, tqp, tqs, tqc,
                                      torch.from_numpy(x), specs)
    return SimpleNamespace(specs=specs, jreport=jreport,
                           jcaptured=jcaptured, tcaptured=tcaptured,
                           treport=treport, tqp=tqp, tqc=tqc, tqs=tqs)


def test_captures_equal_jax(resnet_run):
    """The port captures the same 19 converted convs with the same
    arguments.  Each input is within 1e-5 of max |x| of the JAX package's
    up to the first layer whose quantized input differs (a float32 sum in
    another order moves a value across a rounding boundary; it spreads
    through every later layer, ROADMAP C): that layer's flips all lie
    within 1e-4 of a half step of the grid.  On these inputs the first
    flip is one element of layer1.1.conv2's 32,768."""
    j, t = resnet_run.jcaptured, resnet_run.tcaptured
    assert list(t) == list(j) and len(t) == 19
    held = 0
    for name, (xj, sj, pj, gj) in j.items():
        xt, st, pt, gt = t[name]
        assert (tuple(st), gt) == (tuple(sj), gj), name
        assert [tuple(p) for p in pt] == [tuple(p) for p in pj], name
        xj = np.array(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                                   atol=1e-5 * np.abs(xj).max(),
                                   err_msg=name)
        held += 1
        tr, sf = resnet_run.tqc[name], 0.05
        qt = act_quantize(xt, sf, tr.data_bits, tr.data_terms)
        qj = act_quantize(torch.from_numpy(xj), sf, tr.data_bits,
                          tr.data_terms)
        flipped = (qt != qj).numpy()
        if flipped.any():
            steps = np.abs(xj[flipped]) / sf
            assert np.all(np.abs(steps - np.floor(steps) - 0.5) < 1e-4), name
            break
    assert held >= 4


def test_counts_on_jax_captures_equal_jax(resnet_run):
    """Fed the JAX package's captures, the port's counters give its report
    exactly: pairs, macs and effective macs bit for bit, the mean term
    counts (exact int64 sums over the count, where the JAX package takes a
    float32 mean) within 1e-6."""
    r = resnet_run
    captured = {name: (torch.from_numpy(np.array(x)), s, p, g)
                for name, (x, s, p, g) in r.jcaptured.items()}
    got = temp.captured_cost(captured, r.tqp, r.tqs, r.tqc, r.specs, BATCH)
    assert list(got) == list(r.jreport)
    for name, want in r.jreport.items():
        for key in ("pairs", "macs", "effective_macs"):
            assert got[name][key] == want[key], (name, key)
        for key in ("avg_dt", "avg_wt_elem"):
            assert got[name][key] == pytest.approx(want[key], rel=1e-6), (
                name, key)


def test_own_report_holds_the_invariants(resnet_run):
    """The port's own report: every counted layer within its analytic
    budget and within 12% of the avg-terms factorization (the JAX test's
    invariants), the same layers and macs as the JAX report, and the
    weight-side means (no activation in them) equal to it."""
    r = resnet_run
    by_name = {s.name: s for s in r.specs}
    assert list(r.treport) == list(r.jreport) and len(r.treport) >= 10
    for name, got in r.treport.items():
        spec, tr = by_name[name], r.tqc[name]
        analytic = BATCH * conv2d_term_macs(spec.out_elems, spec.in_ch,
                                            spec.kh, spec.kw, tr,
                                            spec.groups)
        assert 0 < got["pairs"] <= analytic, name
        model = got["avg_dt"] * got["avg_wt_elem"] * got["effective_macs"]
        assert abs(model - got["pairs"]) / got["pairs"] < FACTOR_RTOL, name
        want = r.jreport[name]
        assert got["macs"] == want["macs"]
        assert got["effective_macs"] == want["effective_macs"]
        assert got["avg_wt_elem"] == pytest.approx(want["avg_wt_elem"],
                                                   rel=1e-6)


def test_full_channel_map_sums_to_total(resnet_run):
    """On a whole layer4 conv's captured input the plane-pair map summed
    equals the count-map total (the check chip_smoke makes at 224)."""
    r = resnet_run
    name = "layer4.1.conv1"
    xin, stride, padding, _ = r.tcaptured[name]
    tr, sf = r.tqc[name], r.tqs[name]["sf"]
    xq = act_quantize(xin, sf, tr.data_bits, tr.data_terms)
    w_q, w_sf = r.tqp[name]["w"], r.tqp[name]["w_sf"]
    m = temp.conv_term_pair_map(xq, w_q, sf, w_sf, tr.data_bits,
                                tr.weight_bits, stride, padding)
    assert int(m.sum()) == temp.conv_term_pair_total(
        xq, w_q, sf, w_sf, tr.data_bits, tr.weight_bits, stride, padding)
    assert m.shape == (BATCH, 2, 2, 512)


def test_grouped_conv_not_counted():
    """A grouped conv is captured but not counted (the analytic counter
    skips it)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 2, 4)).astype(np.float32))
    captured = {"dw": (x, (1, 1), "SAME", 2)}
    qcfg = {"dw": TRParams(9, 1, 9, 9, 3)}
    got = temp.captured_cost(captured, {"dw": {"w": w, "w_sf": 0.1}},
                             {"dw": {"sf": 0.05}}, qcfg, [], 1)
    assert got == {}


@pytest.mark.parametrize("tf32", [True, False])
def test_counting_products_run_without_tf32(rng, monkeypatch, tf32):
    """The counting convolutions and the dense product run with TF32 off
    whatever the caller set (the configuration checked on the card), and
    the caller's setting is restored after."""
    seen = []
    real_conv, real_matmul = temp.conv2d, torch.matmul

    def spy(fn):
        def call(*args, **kw):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(temp, "conv2d", spy(real_conv))
    monkeypatch.setattr(torch, "matmul", spy(real_matmul))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    xq, w_q, sf, w_sf = map(torch.as_tensor, _operands(rng))
    temp.conv_term_pair_map(xq, w_q, sf, w_sf, 9, 9)
    temp.conv_term_pair_total(xq, w_q, sf, w_sf, 9, 9)
    temp.dense_term_pair_total(xq.reshape(-1, 16), w_q.reshape(-1, 8)[:16],
                               sf, w_sf, 9, 9)
    assert seen == [(False, False)] * 3
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
