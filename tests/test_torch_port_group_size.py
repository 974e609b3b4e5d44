"""The group-size grid and the compare CLI of the port against the JAX
package and ``results/``.

All 25 (g, alpha) settings' tmacs and avg_terms from the port's cost model
equal ``results/resnet18-group-size-results.json`` (pure arithmetic);
``run_grid`` runs on the CPU and resumes a partial file; the port's
compare prints what the JAX package's prints, returns 0 on ``results/``
and flags a doctored file.
"""

import inspect
import json
import shutil
from pathlib import Path

import pytest
import torch

from tq_tpu.convert import policy as jpolicy
from tq_tpu.evals import compare as jcompare
from tq_tpu.evals import group_size as jgs
from tq_tpu.models import alexnet as jalex
from tq_tpu.models import resnet as jres
from tq_tpu.profilers import cnn_cost as j_cnn_cost
from tq_tpu_torch.convert import policy as tpolicy
from tq_tpu_torch.evals import compare as tcompare
from tq_tpu_torch.evals import group_size as tgs
from tq_tpu_torch.models import resnet as tres
from tq_tpu_torch.profilers import cnn_cost as t_cnn_cost

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results"
GRID_FILE = RESULTS / "resnet18-group-size-results.json"


def test_grid_constants_match_jax():
    assert tgs.GROUP_SIZES == jgs.GROUP_SIZES == (1, 2, 8, 16, 32)
    assert tgs.ALPHAS == jgs.ALPHAS == (1.0, 1.25, 1.5, 2.0, 3.0)
    params = inspect.signature(tgs.run_grid).parameters
    assert params["device"].default == "cuda"
    assert params["mesh"].default is None  # the JAX package's local_mesh()
    assert list(params)[:-2] == list(inspect.signature(jgs.run_grid)
                                     .parameters)
    assert list(params)[-2:] == ["device", "mesh"]


@pytest.mark.parametrize("g", tgs.GROUP_SIZES)
def test_grid_columns_equal_published(g):
    """Each of the five alphas at group size ``g``: the port's tmacs and
    avg_terms equal the JAX package's and the published file's."""
    published = json.loads(GRID_FILE.read_text())[str(g)]
    specs = tres.conv_specs()
    for i, alpha in enumerate(tgs.ALPHAS):
        wt = round(alpha * g)
        st = tpolicy.static_conv_layer_settings(specs, 9, g, wt)
        assert st == jpolicy.static_conv_layer_settings(jres.conv_specs(), 9,
                                                        g, wt)
        got = t_cnn_cost(specs, st, 9, 3)
        assert got == j_cnn_cost(jres.conv_specs(), st, 9, 3)
        assert float(got[0]) == published["tmacs"][i], (g, alpha)
        assert got[1] == published["avg_terms"][i], (g, alpha)


def test_run_grid_cpu_columns_and_resume(tmp_path, monkeypatch):
    """``run_grid`` at g = 2 on two synthetic images, on AlexNet (the
    arch with fewest convs; ResNet-18's columns are held above): a partial
    file keeps its first setting as it is, and the second one's columns
    equal the cost model's."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    out = tmp_path / "grid.json"
    partial = {"2": {"avg_terms": [9.0], "accs": [1.5], "tmacs": [3.0]}}
    out.write_text(json.dumps(partial))
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    try:
        got = tgs.run_grid("alexnet", out_file=str(out), batch_size=2,
                           n_synth=2, group_sizes=(2,), alphas=(1.0, 3.0),
                           verbose=False, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert json.loads(out.read_text()) == got
    specs = jalex.conv_specs()
    tmacs, avg = j_cnn_cost(
        specs, jpolicy.static_conv_layer_settings(specs, 9, 2, 6), 9, 3)
    assert got["2"]["avg_terms"] == [9.0, avg]
    assert got["2"]["tmacs"] == [3.0, float(tmacs)]
    assert got["2"]["accs"][0] == 1.5
    assert got["2"]["accs"][1] in (0.0, 50.0, 100.0)


def test_group_size_main_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.main(["--out-file", str(tmp_path / "g.json")])
    assert not torch.backends.cudnn.allow_tf32


def test_compare_prints_what_jax_prints():
    """Every committed results file against itself, in both packages: the
    same lines."""
    for path in sorted(RESULTS.glob("*.json")):
        assert tcompare.compare_file(path, path) == \
            jcompare.compare_file(path, path), path.name
    assert tcompare.COLUMN_NOTES == jcompare.COLUMN_NOTES


def test_compare_returns_0_on_results_and_flags_a_doctored_file(tmp_path,
                                                                capsys):
    assert tcompare.REFERENCE_DIR == RESULTS
    assert tcompare.main([str(RESULTS)]) == 0
    ref = tmp_path / "ref"
    ours = tmp_path / "ours"
    ref.mkdir()
    ours.mkdir()
    name = "vgg16_bn-results.json"
    shutil.copy(RESULTS / name, ref / name)
    shutil.copy(RESULTS / name, ours / name)
    assert tcompare.main([str(ours), str(ref)]) == 0
    doctored = json.loads((ours / name).read_text())
    doctored["tr-data3"]["tmacs"][2] *= 1.001
    (ours / name).write_text(json.dumps(doctored))
    capsys.readouterr()
    assert tcompare.main([str(ours), str(ref)]) == 1
    assert "tr-data3.tmacs: MISMATCH" in capsys.readouterr().out
    (ours / name).unlink()
    assert tcompare.main([str(ours), str(ref)]) == 1  # not generated
    assert tcompare.main([str(ours), str(tmp_path / "none")]) == 0


def test_compare_mobilenet_offset_is_exact(tmp_path):
    """MobileNet's TR rows: ours plus dt * 16 * 20,716,416 is what the
    upstream file publishes (its counter billed the depthwise convs); the
    compare adds it to those rows only, in both packages."""
    name = "mobilenet_v2-results.json"
    ours = json.loads((RESULTS / name).read_text())
    upstream = {k: {**v, "tmacs": [t + (int(k[len("tr-data"):]) * 16 *
                                        20_716_416 if k != "quant" else 0)
                                   for t in v["tmacs"]]}
                for k, v in ours.items()}
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    (tmp_path / "ours" / name).write_text(json.dumps(ours))
    (tmp_path / "ref" / name).write_text(json.dumps(upstream))
    lines = tcompare.compare_file(tmp_path / "ours" / name,
                                  tmp_path / "ref" / name)
    assert lines == jcompare.compare_file(tmp_path / "ours" / name,
                                          tmp_path / "ref" / name)
    tmacs = [ln for ln in lines if ".tmacs:" in ln]
    assert len(tmacs) == 4 and tmacs[0] == "  quant.tmacs: MATCH (4 values)"
    assert all("MATCH (after documented" in ln for ln in tmacs[1:])
