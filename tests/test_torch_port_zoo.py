"""The rest of the CNN zoo in the port against the JAX package.

AlexNet and VGG-16-bn at 224 px with batch 1, MobileNet-v2 and
EfficientNet-b0 at 64 px with batch 2, on the same seeded numpy weights
(``chip_smoke.zoo_params``) carried into both packages (the port's through
``params_from_jax``): the fp32 forward, the spec tables (hand, traced and
dispatch-recorded) and the policy, the cost columns against JAX and
``results/``, conversion bit for bit with the exempt layers, the two-phase
calibration, each converted conv and the quantized logits, the bf16
serving mode, torch checkpoints, and the sweep CLI.

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_zoo --expected``, it
prints the JAX package's numbers on ``chip_smoke.zoo_params``' weights at
224x224, the numbers ``chip_smoke.EXPECTED_ZOO`` pins (a few minutes on 8
CPU cores).
"""

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.convert import cnn as jconv_cnn
from tq_tpu.convert import policy as jpolicy
from tq_tpu.data import synthetic as jsyn
from tq_tpu.evals import cnn as jeval
from tq_tpu.layers import qctx as jqctx
from tq_tpu.layers.quantize import act_quantize as j_act_quantize
from tq_tpu.profilers import cnn_cost as j_cnn_cost
from tq_tpu.profilers import trace_specs as jtrace
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu.utils import torch_import as jtorch_import
from tq_tpu_torch.convert import cnn as tconv_cnn
from tq_tpu_torch.convert import policy as tpolicy
from tq_tpu_torch.evals import cnn as teval
from tq_tpu_torch.evals import compare as tcompare
from tq_tpu_torch.kernels import tr_quantize as ttrq
from tq_tpu_torch.layers import conv as tconv
from tq_tpu_torch.layers import qctx as tqctx
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.quantize import (_tr_elementwise_vals,
                                          calibration_grids)
from tq_tpu_torch.profilers import cnn_cost as t_cnn_cost
from tq_tpu_torch.profilers import param_count as t_param_count
from tq_tpu_torch.profilers import trace_specs as ttrace
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.params import params_from_jax

jprof = importlib.import_module("tq_tpu.profilers.term_ops")

ROOT = Path(__file__).resolve().parent.parent
ZOO = ("alexnet", "vgg16_bn", "mobilenet_v2", "efficientnet_b0")
# (image, batch) of each arch: AlexNet and VGG flatten a 6x6 / 7x7 map into
# their classifiers, so they run at 224 only.
SIZES = {"alexnet": (224, 1), "vgg16_bn": (224, 1), "mobilenet_v2": (64, 2),
         "efficientnet_b0": (64, 2)}
TR = (9, 8, 12, 9, 3)
# The quantized logits of an image with a boundary flip against the JAX
# package's on the same scales, relative to max |logit|.  A float32 sum in
# another order moves a quantized input across a rounding boundary now and
# then, and the flip spreads through every later layer, the more so the
# deeper the stack of converted convs.  Measured here on these weights:
# AlexNet 1.8e-3, VGG 4.8e-2, MobileNet 3.9e-2 (one of its two images;
# the other 3.8e-7), EfficientNet no flip.
LOGIT_RTOL = {"alexnet": 1e-2, "vgg16_bn": 1e-1, "mobilenet_v2": 1e-1,
              "efficientnet_b0": 1e-2}
# The bf16 serving modes of the two packages: bfloat16 rounds at other
# places in the two libraries (VGG measures 2.6e-2 on these weights).
BF16_RTOL = {"alexnet": 5e-2, "vgg16_bn": 1e-1, "mobilenet_v2": 5e-2,
             "efficientnet_b0": 5e-2}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image_arg(arch, image):
    """The ``image`` argument of conv_specs / convert_cnn (None at the
    models' own 224)."""
    return None if image == 224 else image


class _JaxRecorder(jqctx.QuantCtx):
    """The JAX QuantCtx, remembering each conv's input, arguments and
    output (traced values: return them from the jitted function)."""

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1):
        y = super().conv(name, params, x, stride, padding, groups)
        if name in self.cfg:
            self.__dict__.setdefault("seen", {})[name] = (x, y)
            self.__dict__.setdefault("args", {})[name] = (stride, padding,
                                                          groups)
        return y


class _Arch:
    """Both packages' state for one arch, built on first use."""

    def __init__(self, arch):
        self.arch = arch
        self.image, self.batch = SIZES[arch]
        self.jm, self.tm = jeval.get_model(arch), teval.get_model(arch)
        p = _chip_smoke().zoo_params(arch)
        self.jp = jax.tree.map(jnp.asarray, p)
        self.tp = params_from_jax(p, "cpu")
        self.x = np.random.default_rng(3).normal(
            size=(self.batch, self.image, self.image, 3)).astype(np.float32)
        self.img = _image_arg(arch, self.image)
        self.specs = (self.jm.conv_specs(self.img) if self.img
                      else self.jm.conv_specs())
        self._cache = {}

    def converted(self):
        """Both packages' (qparams, qcfg, qstate) at the TR setting."""
        if "conv" not in self._cache:
            wb, gs, wt, db, dt = TR
            st = jpolicy.static_conv_layer_settings(self.specs, wb, gs, wt)
            self._cache["conv"] = (
                jconv_cnn.convert_cnn(self.jm, self.jp, st, db, dt,
                                      image=self.img),
                tconv_cnn.convert_cnn(self.tm, self.tp, st, db, dt,
                                      image=self.img))
        return self._cache["conv"]

    def calibrated(self):
        """The TR setting calibrated on ``x`` in both packages."""
        if "calib" not in self._cache:
            (jqp, jqc, jqs), (tqp, tqc, tqs) = self.converted()
            _, jqs = jconv_cnn.make_cnn_apply(self.jm, jqc, track=True)(
                jqp, jqs, jnp.asarray(self.x))
            _, tqs = tconv_cnn.make_cnn_apply(self.tm, tqc, track=True)(
                tqp, tqs, torch.from_numpy(self.x))
            self._cache["calib"] = (
                (jqp, jqc, jconv_cnn.finalize_cnn(jqs, jqc)),
                (tqp, tqc, tconv_cnn.finalize_cnn(tqs, tqc)))
        return self._cache["calib"]

    def jax_eval(self):
        """JAX's eval forward at its scales: logits and every converted
        conv's (input, output) and arguments."""
        if "eval" not in self._cache:
            (jqp, jqc, jqs), _ = self.calibrated()
            args = {}

            def fwd(qp, qs, x):
                rec = _JaxRecorder(cfg=jqc, state=qs, track=False)
                logits = self.jm.apply(qp, x, rec)
                args.update(rec.args)
                return logits, rec.seen

            logits, seen = jax.jit(fwd)(jqp, jqs, jnp.asarray(self.x))
            self._cache["eval"] = (np.asarray(logits), seen, args)
        return self._cache["eval"]

    def port_scales(self):
        """The port's calibrated state with JAX's scales."""
        (_, _, jqs), (_, tqc, tqs) = self.calibrated()
        return {n: {**tqs[n], "sf": torch.tensor(float(jqs[n]["sf"]))}
                for n in tqc}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the test workers run several
    files at once, and PyTorch's default of a thread a core in each of
    them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["alexnet", "vgg16_bn"])
def zoo_arch(request):
    """One arch's state in both packages; MobileNet and EfficientNet run
    the same tests in files of their own (test_torch_port_zoo_*.py), so
    that the test workers share the load."""
    return _Arch(request.param)


# ------------------------------------------------------ graph and tables


def test_fp32_apply_matches_jax(zoo_arch):
    """The float32 forward within 1e-5 of max |logit| (the two libraries'
    convolutions sum in other orders)."""
    a = zoo_arch
    arch = a.arch
    want = np.asarray(jax.jit(a.jm.apply)(a.jp, jnp.asarray(a.x)))
    got = a.tm.apply(a.tp, torch.from_numpy(a.x)).numpy()
    assert got.shape == (a.batch, 1000) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _asdicts(specs, drop=()):
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in drop}
            for s in specs]


def test_specs_and_settings_match_jax(zoo_arch):
    """Hand tables, the SpecRecorder trace and the dispatch-recorded specs
    equal the JAX package's (its hand tables and jaxpr walk), at 224 and
    the test's image; so do the policy's per-layer settings."""
    a = zoo_arch
    arch = a.arch
    for image in sorted({224, a.image}):
        img = _image_arg(arch, image)
        want = _asdicts(jtrace.specs_for(a.jm, img))
        assert _asdicts(a.tm.conv_specs(image)) == want
        assert ttrace.trace_conv_specs(a.tm, image) == a.tm.conv_specs(image)
    assert ttrace.trace_dense_specs(a.tm) == a.tm.dense_specs() \
        == a.jm.dense_specs()
    # Any callable, positional names: the JAX jaxpr walk's tables.
    x = torch.empty(1, a.image, a.image, 3, device="meta")
    meta = a.tm.init(torch.Generator(), device="meta")
    got = ttrace.dispatch_conv_specs(a.tm.apply, meta, x)
    shapes = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype),
                          a.jp)
    want = jtrace.jaxpr_conv_specs(
        a.jm.apply, shapes,
        jax.ShapeDtypeStruct((1, a.image, a.image, 3), jnp.float32))
    assert _asdicts(got[0]) == _asdicts(want[0]) and got[1] == want[1]
    assert _asdicts(got[0], ("name", "is_se")) == _asdicts(
        a.tm.conv_specs(a.image), ("name", "is_se"))
    specs = a.tm.conv_specs()
    for setting in [(9, 8, 12), (6, 1, 9), (16, 1, 16)]:
        got = tpolicy.static_conv_layer_settings(specs, *setting)
        assert got == jpolicy.static_conv_layer_settings(
            a.jm.conv_specs(), *setting)
        exempt = [i for i, s in enumerate(specs)
                  if i == 0 or s.groups > 1 or s.is_se]
        assert all(got[i] == tpolicy.EXEMPT_SETTING for i in exempt)


def _grid_rows(arch):
    """The arch's published-grid settings as (key, wb, gs, wt, db, dt), in
    run_sweep's order."""
    g = teval.PUBLISHED_GRIDS[arch]
    rows = [("quant", wb, 1, wb if g["uq_wt"] == "wb" else g["uq_wt"],
             g["uq_db"], g["uq_dt"]) for wb in g["uq_bits"]]
    rows += [(f"tr-data{dt}", 9, 8, wt, 9, dt) for dt in g["tr_data_terms"]
             for wt in g["tr_weight_terms"]]
    return rows


def _cost_columns(arch, params) -> dict:
    """The sweep's deterministic columns from the port's cost model."""
    specs = teval.get_model(arch).conv_specs()
    n_params = float(t_param_count(params))
    out: dict = {}
    for key, wb, gs, wt, db, dt in _grid_rows(arch):
        st = tpolicy.static_conv_layer_settings(specs, wb, gs, wt)
        tmacs, avg = t_cnn_cost(specs, st, db, dt)
        assert (tmacs, avg) == j_cnn_cost(
            jeval.get_model(arch).conv_specs(), st, db, dt)
        row = out.setdefault(key, {"tmacs": [], "avg_terms": [],
                                   "params": []})
        row["tmacs"].append(float(tmacs))
        row["avg_terms"].append(avg)
        row["params"].append(n_params)
    return out


def test_cost_columns_match_jax_and_results(zoo_arch, tmp_path):
    """tmacs and avg_terms equal the JAX package's at every published-grid
    setting, the parameter count equals JAX's, and the three columns equal
    ``results/<arch>-results.json`` (the JAX package's sweeps; its
    MobileNet TR rows count no depthwise conv, so the port's compare
    reports them as the documented offset from the upstream file) with no
    mismatch in the compare."""
    a = zoo_arch
    arch = a.arch
    assert t_param_count(a.tp) == jprof.param_count(a.jp)
    cols = _cost_columns(arch, a.tp)
    path = ROOT / "results" / f"{arch}-results.json"
    ref = json.loads(path.read_text())
    assert cols == {k: {c: v[c] for c in ("tmacs", "avg_terms", "params")}
                    for k, v in ref.items()}
    ours = tmp_path / path.name
    ours.write_text(json.dumps({k: {**v, "accs": ref[k]["accs"]}
                                for k, v in cols.items()}))
    lines = tcompare.compare_file(ours, path)
    assert len(lines) == 1 + 4 * len(ref)
    assert not any(w in ln for ln in lines
                   for w in ("MISMATCH", "LENGTH", "missing")), lines
    if arch == "alexnet":  # no published file: the JAX package's, pinned
        assert cols == _chip_smoke().EXPECTED_ZOO["alexnet"]["columns"]


# ------------------------------------------------------------- conversion


def test_convert_cnn_bit_exact(zoo_arch):
    """Every converted conv's weights and scale equal JAX's bit for bit:
    the swept layers (B2, g = 8) and the exempt depthwise and
    squeeze-excite layers at (16, 1, 16) (B1 on the weights)."""
    a = zoo_arch
    arch = a.arch
    (jqp, jqc, jqs), (tqp, tqc, tqs) = a.converted()
    assert list(tqc) == list(jqc) == [s.name for s in a.specs[1:]]
    assert a.specs[0].name not in tqc
    for name in tqc:
        assert tqc[name] == TRParams(**dataclasses.asdict(jqc[name]))
        np.testing.assert_array_equal(tqp[name]["w"].numpy(),
                                      np.asarray(jqp[name]["w"]),
                                      err_msg=name)
        assert float(tqp[name]["w_sf"]) == float(jqp[name]["w_sf"]), name
    exempt = [s.name for s in a.specs[1:] if s.groups > 1 or s.is_se]
    assert all(tqc[n].weight_bits == 16 for n in exempt)
    assert bool(exempt) == (arch in ("mobilenet_v2", "efficientnet_b0"))


def _mse(hist: torch.Tensor, sf: float, bits: int, terms: int) -> float:
    """The MSE search's objective at one scale, in float64."""
    x_grid, _ = calibration_grids()
    xh = _tr_elementwise_vals(x_grid, torch.tensor(sf), bits, terms)
    return float((hist.double() * (x_grid - xh).double() ** 2).sum())


def test_two_phase_calibration_equal_scales(zoo_arch):
    """Histograms equal but for values moved across a bin edge (at most
    1e-4 of them), every calibrated scale equal to JAX's or a near-tie on
    the port's histogram (both errors within 1e-6)."""
    (jqp, jqc, jqs), (tqp, tqc, tqs) = zoo_arch.calibrated()
    moved = total = 0
    for name in tqc:
        jh, th = np.asarray(jqs[name]["hist"]), tqs[name]["hist"].numpy()
        assert jh.sum() == th.sum()
        moved += int(np.abs(jh - th).sum()) // 2
        total += int(th.sum())
        a, b = float(tqs[name]["sf"]), float(jqs[name]["sf"])
        if a != b:
            tr = tqc[name]
            ea = _mse(tqs[name]["hist"], a, tr.data_bits, tr.data_terms)
            eb = _mse(tqs[name]["hist"], b, tr.data_bits, tr.data_terms)
            assert abs(ea - eb) <= 1e-6 * max(ea, eb), (name, a, b)
    assert moved <= total * 1e-4, (moved, total)


def test_quantized_convs_and_logits_match_jax(zoo_arch):
    """With JAX's scales: each converted conv's quantized input exact and
    its output within 1e-5 * max|y| on the JAX package's own input.  End
    to end, the images whose quantized inputs all equal JAX's (none moved
    across a rounding boundary) within 1e-4 of max |logit|, the others
    within LOGIT_RTOL[arch]."""
    a = zoo_arch
    (_, _, jqs), (tqp, tqc, _) = a.calibrated()
    tqs = a.port_scales()
    want, seen, args = a.jax_eval()
    assert seen.keys() == tqc.keys()  # a jitted output's keys come sorted
    for name in tqc:
        xj, yj = seen[name]
        tr, sf = tqc[name], jqs[name]["sf"]
        stride, padding, groups = args[name]
        xt = torch.from_numpy(np.array(xj))
        np.testing.assert_array_equal(
            ttrq.tr_quantize(xt, tqs[name]["sf"], tr.data_bits, 1,
                             tr.data_terms).numpy(),
            np.asarray(j_act_quantize(xj, sf, tr.data_bits, tr.data_terms)),
            err_msg=name)
        yt, _ = tconv.tr_conv_apply(tqp[name], tr, tqs[name], xt, False,
                                    stride, padding, groups)
        yj = np.asarray(yj)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                   atol=1e-5 * np.abs(yj).max(),
                                   err_msg=name)
    mine = {}

    class Recorder(tqctx.QuantCtx):
        def conv(self, name, params, x, stride=(1, 1), padding="SAME",
                 groups=1):
            if name in self.cfg:
                mine[name] = x
            return super().conv(name, params, x, stride, padding, groups)

    got = a.tm.apply(tqp, torch.from_numpy(a.x),
                     Recorder(cfg=tqc, state=tqs)).numpy()
    flipped = np.zeros(a.batch, bool)
    for name, tr in tqc.items():
        q = [ttrq.tr_quantize(x, tqs[name]["sf"], tr.data_bits, 1,
                              tr.data_terms).reshape(a.batch, -1)
             for x in (mine[name], torch.from_numpy(np.array(seen[name][0])))]
        flipped |= (q[0] != q[1]).any(dim=1).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max(axis=1) / scale
    assert (err[~flipped] <= 1e-4).all(), (err, flipped)
    assert (err <= LOGIT_RTOL[a.arch]).all(), (err, flipped)


def test_bf16_serving_mode(zoo_arch):
    """The whole graph in bfloat16: float32 logits, finite, within
    BF16_RTOL[arch] of max |logit| of the JAX package's bf16 mode and, as
    the JAX package's own test holds it, within 0.2 (relative norm) of the
    float32 mode."""
    a = zoo_arch
    arch = a.arch
    (jqp, jqc, jqs), (tqp, tqc, _) = a.calibrated()
    tqs = a.port_scales()
    want, _ = jax.jit(jconv_cnn.make_cnn_apply(
        a.jm, jqc, track=False, compute_dtype=jnp.bfloat16))(
            jqp, jqs, jnp.asarray(a.x))
    got, _ = tconv_cnn.make_cnn_apply(a.tm, tqc, track=False,
                                      compute_dtype=torch.bfloat16)(
        tqp, tqs, torch.from_numpy(a.x))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_RTOL[arch] * np.abs(want).max())
    f32, _ = tconv_cnn.make_cnn_apply(a.tm, tqc, track=False)(
        tqp, tqs, torch.from_numpy(a.x))
    assert float((got - f32).norm() / f32.norm()) < 0.2


# ------------------------------------------------- checkpoints and CLIs


def _state_dict(tparams) -> dict:
    """A torch state_dict with the models' module names: OIHW convs, (out,
    in) linears, BN with running statistics."""
    sd = {}
    for name, p in tparams.items():
        if "scale" in p:
            sd.update({f"{name}.weight": p["scale"], f"{name}.bias": p["bias"],
                       f"{name}.running_mean": p["mean"],
                       f"{name}.running_var": p["var"],
                       f"{name}.num_batches_tracked": torch.tensor(0)})
            continue
        w = p["w"]
        sd[f"{name}.weight"] = (w.permute(3, 2, 0, 1) if w.ndim == 4
                                else w.t()).contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]
    return sd


@pytest.mark.parametrize("arch", ["mobilenet_v2", "efficientnet_b0"])
def test_torch_checkpoint_loads_like_jax(arch, tmp_path):
    """A torchvision / efficientnet_pytorch state_dict (the models' names
    are their module names) loads through ``load_params`` as the JAX
    package loads it, without a rename."""
    tp = params_from_jax(_chip_smoke().zoo_params(arch), "cpu")
    path = tmp_path / f"{arch}.pt"
    torch.save(_state_dict(tp), path)
    m, got = teval.load_params(arch, str(path), device="cpu")
    want = jtorch_import.load_torch_checkpoint(path)
    assert m is teval.get_model(arch) and got.keys() == tp.keys() \
        == want.keys()
    for name in tp:
        assert got[name].keys() == tp[name].keys() == want[name].keys()
        for leaf in tp[name]:
            assert torch.equal(got[name][leaf], tp[name][leaf])
            np.testing.assert_array_equal(got[name][leaf].numpy(),
                                          want[name][leaf])


def test_zoo_checkpoint_loads_in_both_packages(tmp_path):
    """chip_smoke's seeded checkpoint has the JAX init's tree and shapes
    and loads equal in both packages; its weights have the init's
    spread."""
    cs = _chip_smoke()
    for arch in ("mobilenet_v2", "alexnet"):
        path = tmp_path / f"{arch}.npz"
        cs.zoo_checkpoint(arch, path, seed=1)
        jp, tp = jckpt.load_params(path), tckpt.load_params(path)
        shapes = jax.eval_shape(jeval.get_model(arch).init,
                                jax.random.PRNGKey(0))
        assert jp.keys() == shapes.keys()
        for name, leaves in shapes.items():
            assert jp[name].keys() == leaves.keys(), name
            for leaf, sds in leaves.items():
                assert jp[name][leaf].shape == sds.shape, (name, leaf)
                np.testing.assert_array_equal(tp[name][leaf], jp[name][leaf])
    w = jp["features.10"]["w"]  # AlexNet's last conv: 3x3x256 -> 256
    assert abs(w.std() - (2 / (9 * 256)) ** 0.5) < 1e-3


def test_get_model_every_arch():
    for arch in teval.ARCHS:
        m = teval.get_model(arch)
        assert m.__name__.rsplit(".", 1)[1] == \
            jeval.get_model(arch).__name__.rsplit(".", 1)[1]
        assert m.__name__.startswith("tq_tpu_torch.models.")
    with pytest.raises(ValueError, match="unknown arch"):
        teval.get_model("lenet")


def test_cnn_cli_runs_a_zoo_arch_on_cpu(tmp_path, monkeypatch):
    """The sweep CLI on a zoo arch (AlexNet, the one with fewest convs) at
    one UQ and one TR setting on two synthetic images: its deterministic
    columns equal ``results/``'s."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    out = tmp_path / "alexnet-results.json"
    got = teval.run_sweep("alexnet", out_file=str(out), batch_size=2,
                          n_synth=2, uq_bits=(9,), tr_data_terms=(4,),
                          tr_weight_terms=(24,), verbose=False, device="cpu")
    assert json.loads(out.read_text()) == got
    published = json.loads((ROOT / "results" / out.name).read_text())
    for key, i in (("quant", 3), ("tr-data4", 3)):
        for col in ("tmacs", "avg_terms", "params"):
            assert got[key][col] == published[key][col][i:i + 1], (key, col)
        assert got[key]["accs"][0] in (0.0, 50.0, 100.0)


# ------------------------------------------------- chip_smoke's numbers


def jax_expected_zoo(arch: str, image: int = 224, batch: int | None = None,
                     calib_batch: int = 64) -> dict:
    """The JAX package on ``chip_smoke.zoo_params(arch)``'s weights: the
    pinned program's logits statistics and top-1 per image, the TR
    setting's calibrated scales (in conversion order) after the sweep's
    calibration pass on the first synthetic batch, and for AlexNet the
    sweep's deterministic columns."""
    cs = _chip_smoke()
    f = cs.ZOO_PROGRAM
    batch = batch or f["batch"]
    m = jeval.get_model(arch)
    img = _image_arg(arch, image)
    params = jax.tree.map(jnp.asarray, cs.zoo_params(arch))
    specs = m.conv_specs(img) if img else m.conv_specs()
    st = jpolicy.static_conv_layer_settings(specs, *f["tr"])
    qp, qc, qs = jconv_cnn.convert_cnn(m, params, st, f["db"], f["dt"],
                                       image=img)
    fixed = {k: {**v, "sf": jnp.float32(f["sf"])} for k, v in qs.items()}
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(batch, image, image, 3)), jnp.float32)
    logits, _ = jax.jit(jconv_cnn.make_cnn_apply(m, qc, track=False))(
        qp, fixed, x)
    logits = np.asarray(logits, np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    xc, _ = jsyn.synthetic_imagenet_batch(calib_batch, image, seed=0)
    _, qs = jax.jit(jconv_cnn.make_cnn_apply(m, qc, track=True))(
        qp, qs, jnp.asarray(xc))
    qs = jconv_cnn.finalize_cnn(qs, qc)
    out = {"program": {"top1": np.argmax(logits, 1).tolist(),
                       "top2_margin": (top2[:, 1] - top2[:, 0]).tolist(),
                       "mean": float(logits.mean()),
                       "std": float(logits.std()),
                       "max_abs": float(np.abs(logits).max()),
                       "row_max": logits.max(1).tolist(),
                       "first": logits[0, :8].tolist()},
           "sweep_sf": {"setting": [*f["tr"], f["db"], f["dt"]],
                        "sf": [float(qs[k]["sf"]) for k in qc]}}
    if arch == "alexnet":
        n_params = float(jprof.param_count(params))
        cols: dict = {}
        for key, wb, gs, wt, db, dt in _grid_rows(arch):
            st = jpolicy.static_conv_layer_settings(m.conv_specs(), wb, gs,
                                                    wt)
            tmacs, avg = j_cnn_cost(m.conv_specs(), st, db, dt)
            row = cols.setdefault(key, {"tmacs": [], "avg_terms": [],
                                        "params": []})
            row["tmacs"].append(float(tmacs))
            row["avg_terms"].append(avg)
            row["params"].append(n_params)
        out["columns"] = cols
    return out


def test_expected_zoo_pinned(monkeypatch):
    """EXPECTED_ZOO holds every zoo arch in the form jax_expected_zoo gives
    (run on MobileNet at a small size, the scale search stubbed out; the
    search is held in the calibration test), for ZOO_PROGRAM's batch and
    one scale per converted conv."""
    cs = _chip_smoke()
    f = cs.ZOO_PROGRAM
    assert (f["tr"], f["db"], f["dt"], f["sf"], f["image"]) == \
        ((9, 8, 12), 9, 3, 0.05, 224) and f["batch"] >= 8
    assert sorted(cs.ZOO_ARCHS) == sorted(ZOO)
    monkeypatch.setattr(jconv_cnn, "finalize_cnn", lambda qs, qc: {
        k: {**v, "sf": jnp.float32(0.5)} for k, v in qs.items()})
    small = jax_expected_zoo("mobilenet_v2", image=32, batch=2, calib_batch=2)
    for arch in ZOO:
        exp = cs.EXPECTED_ZOO[arch]
        keys = {"program", "sweep_sf"} | ({"columns"} if arch == "alexnet"
                                           else set())
        assert exp.keys() == keys, arch
        assert exp["program"].keys() == small["program"].keys()
        assert len(exp["program"]["top1"]) == f["batch"]
        assert exp["sweep_sf"]["setting"] == small["sweep_sf"]["setting"]
        n_converted = len(teval.get_model(arch).conv_specs()) - 1
        assert len(exp["sweep_sf"]["sf"]) == n_converted, arch
    assert len(small["sweep_sf"]["sf"]) == 51


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps({arch: jax_expected_zoo(arch) for arch in
                      ("vgg16_bn", "mobilenet_v2", "efficientnet_b0",
                       "alexnet")}))
