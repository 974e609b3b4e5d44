"""The port stands alone: no JAX, nothing of the JAX package, imports
without a GPU, and entry points that run on the card unless told
otherwise."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tq_tpu_torch
from tq_tpu_torch.evals import mlp as port_mlp

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(tq_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "tq_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tq_tpu'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in"
        " sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_kernels_not_built_at_import():
    from tq_tpu_torch.kernels import _build

    assert _build._LIB is None


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    assert inspect.signature(port_mlp.run_sweep).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mlp.run_sweep([2], [2], [6], [6], [1], None, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mlp.main(["--wb", "2", "--wt", "2", "--db", "6", "--dt", "6",
                       "--gs", "1", "--out-file", "unused.json"])
    assert port_mlp.resolve_device("cpu") == torch.device("cpu")


def test_parallel_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """The meshes (and so ``BatchRunner``, whose device is its mesh's),
    the pipeline demo and the parallel examples run on the card unless
    told otherwise, and raise without a GPU before starting a rank."""
    from tq_tpu_torch.examples import (lm_serving, pipeline_inference,
                                       sharded_inference)
    from tq_tpu_torch.parallel import mesh, multihost, pp

    for fn in (mesh.make_mesh, mesh.local_mesh, pp.make_pipeline_mesh,
               pp.build_mlp_pipeline, multihost.global_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh.make_mesh(1, 1), mesh.local_mesh,
                 lambda: pp.make_pipeline_mesh(1),
                 lambda: pp.build_mlp_pipeline(torch.Generator(), 1),
                 multihost.global_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for example in (sharded_inference, pipeline_inference, lm_serving):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(["--world", "2"])


def test_viz_and_the_leaf_modules_import_without_matplotlib():
    """matplotlib is optional (the card's machine has none): every module
    of the port and ``chip_smoke`` import with it blocked, the compute
    functions of ``viz`` run, and a plot function asks for it only when
    called."""
    code = (
        "import importlib, sys\n"
        "sys.modules['matplotlib'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import torch\n"
        "from types import SimpleNamespace\n"
        "from tq_tpu_torch.models import resnet\n"
        "from tq_tpu_torch.viz import gen_frontier, fpga\n"
        "from tq_tpu_torch.viz.quant_error import layer_errors\n"
        "from tq_tpu_torch.viz.term_dist import group_term_counts\n"
        "assert gen_frontier([2, 1], [1, 2]) == ([1], [2])\n"
        "w = torch.randn(3, 3, 16, 4, generator=torch.Generator()"
        ".manual_seed(0))\n"
        "assert group_term_counts(w, 9, 8).shape == (36 * 2,)\n"
        "spec = resnet.conv_specs()[1]\n"
        "m = SimpleNamespace(conv_specs=lambda: [spec, spec])\n"
        "errs = layer_errors(m, {spec.name: {'w': w}}, (9, 8, 12))\n"
        "assert len(errs) == 1 and 0 < errs[0][1] < 1\n"
        "try:\n"
        "    fpga.plot('unused.pdf')\n"
        "except ImportError:\n"
        "    print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
