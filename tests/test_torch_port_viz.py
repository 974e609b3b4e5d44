"""The port's figures and the ResNet-18 example against the JAX package's.

The compute functions of ``tq_tpu_torch.viz`` (``gen_frontier``,
``quant_error.layer_errors``, ``term_dist.group_term_counts``) against the
JAX package's on the same weights (``chip_smoke.zoo_params``); every plot
function writes its file (where matplotlib is installed); and
``python -m tq_tpu_torch.examples.quantize_resnet18`` at 64 px on the CPU
prints the JAX example's tmacs and params and the serving-mode line.
"""

import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.convert import policy as jpolicy
from tq_tpu.models import resnet as jres
from tq_tpu.profilers import cnn_cost as j_cnn_cost
from tq_tpu.profilers import param_count as j_param_count
from tq_tpu.viz import gen_frontier as j_gen_frontier
from tq_tpu.viz import quant_error as jquant_error
from tq_tpu.viz import term_dist as jterm_dist
from tq_tpu_torch.examples import quantize_resnet18 as texample
from tq_tpu_torch.models import resnet as tres
from tq_tpu_torch.utils.params import params_from_jax
from tq_tpu_torch.viz import gen_frontier
from tq_tpu_torch.viz import quant_error as tquant_error
from tq_tpu_torch.viz import term_dist as tterm_dist

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights():
    """ResNet-18's seeded numpy weights in both packages' trees."""
    torch.set_num_threads(1)  # the test workers share the cores
    np_params = _chip_smoke().zoo_params("resnet18")
    return SimpleNamespace(np=np_params,
                           jax={k: {n: jnp.asarray(v) for n, v in d.items()}
                                for k, d in np_params.items()},
                           torch=params_from_jax(np_params, "cpu"))


def _stub(module, n: int):
    """``module`` with its first ``n`` conv specs only: the stem, the four
    64-channel 3x3 convs and layer2.0.conv1 (two weight shapes)."""
    specs = module.conv_specs()[:n]
    return SimpleNamespace(conv_specs=lambda: specs)


@pytest.mark.parametrize("seed", range(4))
def test_gen_frontier_equals_jax(seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 20, size=30).tolist()
    ys = rng.normal(size=30).round(1).tolist()
    assert gen_frontier(xs, ys) == j_gen_frontier(xs, ys)
    assert gen_frontier([3, 1, 2, 4], [5, 1, 6, 4]) == ([1, 2], [1, 6])


@pytest.mark.parametrize("setting", [(8, 1, 8), (9, 8, 12), (4, 16, 6)],
                         ids=["uq8", "tr9-8-12", "tr4-16-6"])
def test_layer_errors_equal_jax(weights, setting):
    """The relative weight error of each converted conv within 1e-6 of
    the JAX package's (the port's norms in float64, the JAX package's in
    float32)."""
    got = tquant_error.layer_errors(_stub(tres, 6), weights.torch, setting)
    want = jquant_error.layer_errors(_stub(jres, 6), weights.jax, setting)
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 5
    for (name, e), (_, ej) in zip(got, want):
        assert isinstance(e, float)
        assert e == pytest.approx(ej, rel=1e-6, abs=1e-7), name


@pytest.mark.parametrize("layer", ["layer1.0.conv1", "layer2.0.downsample.0",
                                   "layer3.0.conv1"])
@pytest.mark.parametrize("g", [1, 8, 16, 24])
def test_group_term_counts_equal_jax(weights, layer, g):
    """Exact, with g = 24 leaving a zero-padded last group."""
    got = tterm_dist.group_term_counts(weights.torch[layer]["w"], 9, g)
    want = np.asarray(jterm_dist.group_term_counts(weights.jax[layer]["w"],
                                                   9, g))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_group_term_counts_round_half_to_even():
    """A weight on an exact half of the grid (|w| / sf = 2.5) counts as
    the JAX package's ``jnp.round`` makes it: 2 (one term), not 3 (two)."""
    w = np.zeros((1, 1, 4, 1), np.float32)
    w[0, 0, :, 0] = [64.0, 0.625, -0.625, 0.875]  # 9 bits: sf = 0.25
    got = tterm_dist.group_term_counts(torch.from_numpy(w), 9, 1)
    want = np.asarray(jterm_dist.group_term_counts(jnp.asarray(w), 9, 1))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, 1, 1, 1]  # 256, 2, 2, 4


def test_term_pair_histogram_on_the_cpu(weights):
    """The activation-side panel's statistic: a distribution over pair
    counts up to the theoretical maximum, its 99% point inside it."""
    h = tterm_dist.term_pair_histogram(tres, weights.torch, image=32)
    assert h["layer"] == "layer1.0.conv1"
    assert h["pct"].sum() == pytest.approx(100.0)
    assert len(h["pct"]) <= h["theo_max"] + 1 == 16 * 10 * 10 + 1
    assert 0 < h["long_tail"] < len(h["pct"])


# ------------------------------------------------------------------ plots


@pytest.fixture
def cnn_results(tmp_path):
    res = {
        "quant": {"accs": [60, 65, 69], "tmacs": [1e10, 2e10, 3e10],
                  "avg_terms": [6, 7, 8], "params": [1e7] * 3},
        "tr-data3": {"accs": [67, 69], "tmacs": [5e9, 8e9],
                     "avg_terms": [1.5, 2.0], "params": [1e7] * 2},
    }
    p = tmp_path / "resnet18-results.json"
    p.write_text(json.dumps(res))
    return p


@pytest.fixture
def matplotlib():
    return pytest.importorskip("matplotlib")


def test_pareto_plots(matplotlib, cnn_results, tmp_path):
    from tq_tpu_torch.viz import pareto

    assert pareto.plot([cnn_results], tmp_path / "p.pdf") == \
        tmp_path / "p.pdf"
    q, t = tmp_path / "q.json", tmp_path / "t.json"
    q.write_text(json.dumps({"ppls": [90, 87], "tmacs": [3e11, 5e11],
                             "param_bits": [1, 2]}))
    t.write_text(json.dumps({"ppls": [88, 87], "tmacs": [6e10, 1.8e11],
                             "param_bits": [1, 2]}))
    pareto.main([str(q), str(t), "--pair", "--out",
                 str(tmp_path / "pair.pdf")])
    assert (tmp_path / "p.pdf").stat().st_size > 0
    assert (tmp_path / "pair.pdf").stat().st_size > 0


def test_group_size_and_fpga_plots(matplotlib, tmp_path):
    from tq_tpu_torch.viz import fpga, group_size

    p = tmp_path / "gs.json"
    p.write_text(json.dumps({
        "1": {"avg_terms": [1, 2, 3], "accs": [62, 69, 69.6],
              "tmacs": [1, 2, 3]},
        "8": {"avg_terms": [1, 2, 3], "accs": [67, 69.6, 69.6],
              "tmacs": [1, 2, 3]},
    }))
    group_size.plot(p, tmp_path / "gs.pdf")
    fpga.main(["--out", str(tmp_path / "f.pdf")])
    assert (tmp_path / "gs.pdf").stat().st_size > 0
    assert (tmp_path / "f.pdf").stat().st_size > 0


def test_weight_plots_on_the_cpu(matplotlib, tmp_path):
    """AlexNet (four converted convs) keeps the term reveals short."""
    tquant_error.main(["-a", "alexnet", "--out", str(tmp_path / "qe.pdf"),
                       "--device", "cpu"])
    tterm_dist.main(["-a", "alexnet", "--out", str(tmp_path / "td.pdf"),
                     "--device", "cpu"])
    assert (tmp_path / "qe.pdf").stat().st_size > 0
    assert (tmp_path / "td.pdf").stat().st_size > 0


def test_term_pair_plot_on_the_cpu(matplotlib, tmp_path):
    out = tterm_dist.plot_term_pair_dist(image=32, device="cpu",
                                         out_file=tmp_path / "tp.pdf")
    assert Path(out).stat().st_size > 0


def test_plots_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tquant_error.plot("alexnet")


# ---------------------------------------------------------------- example


def test_example_prints_the_jax_examples_numbers(weights, capsys):
    """``python -m tq_tpu_torch.examples.quantize_resnet18 --image 64
    --batch 2 --device cpu``: the JAX example's tmacs and params (pure
    functions of the specs and the parameter tree), and its last line."""
    texample.main(["--image", "64", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    specs = jres.conv_specs(64)
    settings = jpolicy.static_conv_layer_settings(specs, 9, 8, 12)
    tmacs, avg_terms = j_cnn_cost(specs, settings, 9, 3)
    assert f"term-pair MACs/img: {tmacs:,}  avg terms/value: {avg_terms}" \
        in out
    assert f"params: {j_param_count(weights.np):,}" in out
    assert re.search(r"logits: \(2, 1000\) top-1: \[\d+, \d+\]", out)
    assert "serving-mode top-1 agrees: True" in out
