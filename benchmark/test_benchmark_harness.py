"""CPU tests of the harness: BENCHMARK.json's form, the work counts, the
trace arithmetic, the look for JAX and the per-layer readers.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

from benchmark import harness, roofline
from benchmark.harness import Trace, forbidden_modules
from benchmark.work import lstm_lm as lstm_work
from benchmark.work import resnet18 as resnet_work

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _cfg(name):
    entry = {c["name"]: c for c in MANIFEST["configs"]}[name]
    return json.loads((ROOT / entry["file"]).read_text())


def test_manifest_keys_and_sizes():
    m = MANIFEST
    assert set(m) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and len(m["command"]) <= 32
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert all(LINE.match(w) and not w.startswith("/") for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for kind, lo, hi in (("configs", 1, 24), ("workloads", 1, 24),
                         ("end_to_end", 1, 16), ("per_layer", 1, 128)):
        assert lo <= len(m[kind]) <= hi
    for c in m["configs"]:
        assert set(c) == KEYS["config"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
    for w in m["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == KEYS["end_to_end"]
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == KEYS["per_layer"]
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines():
    m = MANIFEST
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["configs"] + m["workloads"]:
        assert LINE.match(x["why"])
    for x in m["workloads"]:
        assert NAME.match(x["config"]) and NAME.match(x["traffic"])
    for x in m["per_layer"]:
        assert LINE.match(x["layer"])
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_cells_metrics_and_files():
    m = MANIFEST
    configs = {c["name"] for c in m["configs"]}
    used = {w["config"] for w in m["workloads"]}
    assert used == configs
    assert {"setup_s"} <= {e["name"] for e in m["end_to_end"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for w in m["workloads"]:
        n = w["name"]
        reported = {k for k, e in e2e.items()
                    if n in e.get("workloads", [n])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [p for p in m["per_layer"]
                 if n in p.get("workloads", [n])]
        assert layer and all(p["moves"] in reported for p in layer)
        traffic = json.loads((BENCH / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
        assert (BENCH / "limits" / f"{n}.json").is_file()
    for p in m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
        assert p["moves"] in e2e
    layers = {}
    for p in m["per_layer"]:
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_resnet18_counts():
    cfg = _cfg("resnet18-tr")
    # torchvision resnet18: 11,689,512 parameters, 1.814 GMAC an image.
    assert resnet_work.parameters(cfg) == 11_689_512
    ops, nbytes = resnet_work.step(cfg, 1)
    assert ops == pytest.approx(2 * 1.814e9, rel=1e-3)
    assert nbytes == 4 * (11_689_512 + 2 * 4800 + 224 * 224 * 3 + 1000)
    # B1 on every converted conv's input: layer1 4 x (56*56*64), layer2
    # (56*56*64) + 3 x (28*28*128) + the downsample's (56*56*64), ...
    elems = (4 * 56 * 56 * 64 + 2 * 56 * 56 * 64 + 3 * 28 * 28 * 128
             + 2 * 28 * 28 * 128 + 3 * 14 * 14 * 256
             + 2 * 14 * 14 * 256 + 3 * 7 * 7 * 512)
    assert resnet_work.kernel(cfg, "tr_quantize", 64) == (0.0,
                                                         8.0 * 64 * elems)


def test_lstm_counts():
    cfg = _cfg("lstm650-tr")
    ops, nbytes = lstm_work.step(cfg, 64)
    per_row = 2 * (650 * 2600 * 4 + 650 * 33278)
    assert ops == 64 * per_row
    weights = 650 * 2600 * 2 * 9 / 8 + 650 * 2600 * 2 * 4 + 650 * 33278 * 9 / 8
    biases = (2 * 2 * 2600 + 33278) * 4
    io = 64 * (650 + 4 * 2 * 650 + 33278) * 4
    assert nbytes == pytest.approx(weights + biases + io)
    kops, kbytes = lstm_work.kernel(cfg, "term_matmul", 1)
    assert kops == 2 * (650 * 2600 * 2 + 650 * 33278)
    assert kbytes == pytest.approx(
        (650 * 2600 * 2 + 650 * 33278) * 9 / 8
        + 4 * (650 + 2600) * 2 + 4 * (650 + 33278))


def test_least_seconds_takes_the_longer_bound():
    assert roofline.least_seconds(495e12, 0, "tf32") == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12, "tf32") == pytest.approx(1.0)
    assert roofline.least_seconds(495e12, 6.7e12, "tf32") == pytest.approx(
        2.0)


def _events():
    """A window of 100 us: kernels at [10, 30) and [20, 40) (overlapping)
    and [60, 70); a host op over [40, 60); one kernel outside."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "w", "ts": 1000,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void tr_elementwise_kernel<1>",
         "ts": 1010, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "cudnn_conv", "ts": 1020,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "term_matmul_mma_kernel",
         "ts": 1060, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 1200, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::argmax", "ts": 1040,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 1000,
         "dur": 100},
    ]


def test_trace_arithmetic():
    t = Trace.from_events(_events(), "w")
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(60.0)
    assert t.kernel_seconds(("tr_elementwise",)) == (pytest.approx(20e-6), 1)
    assert t.kernel_seconds(("term_matmul",))[1] == 1
    assert [k for k, _ in t.top_kernels()][0] in ("cudnn_conv",
                                                  "void tr_elementwise_kernel<1>")
    gaps = t.idle_gaps()
    assert gaps[0] == ["outer", pytest.approx(30e-6)]
    assert gaps[1] == ["aten::argmax", pytest.approx(20e-6)]
    assert Trace(0, 1, [], []).idle_share() is None


class _Run:
    """A traced run as the readers see it."""

    def __init__(self):
        self.cfg = _cfg("resnet18-tr")
        self.trace = Trace.from_events(_events(), "w")
        self.lead_steps, self.lead_seconds, self.trace_steps = 10, 0.1, 1
        self.spans = harness.Spans(__import__("torch").device("cpu"))
        self.spans.seconds = {"convert": [0.01, 0.03]}

        class _Loop:
            rows = 64
        self.loop = _Loop()


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_a_synthetic_run():
    run = _Run()
    assert _reader("idle_share.images")(run) == pytest.approx(60.0)
    ops, nbytes = resnet_work.step(run.cfg, 64)
    want = 100 * roofline.least_seconds(ops, nbytes, "tf32") / 0.01
    assert _reader("step_mfu.images")(run) == pytest.approx(want)
    b1 = resnet_work.kernel(run.cfg, "tr_quantize", 64)[1] / 3.35e12
    assert _reader("tr_quantize_roofline.images")(run) == pytest.approx(
        100 * b1 / 20e-6)
    assert _reader("convert_ms.calib")(run) == pytest.approx(20.0)
    assert _reader("search_ms.calib")(run) is None
    run.trace = Trace(0, 1, [], [])
    assert _reader("idle_share.images")(run) is None
    assert _reader("tr_quantize_roofline.images")(run) is None


def test_forbidden_modules_compares_whole_top_level_names():
    assert forbidden_modules(["tq_tpu_torch", "tq_tpu_torch.x", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["tq_tpu.x", "jax", "jaxlib.xla", "flax.nn",
                              "torch"]) == ["flax.nn", "jax", "jaxlib.xla",
                                            "tq_tpu.x"]


def test_reservoir_is_uniform_and_seeded():
    def sample(seed):
        r = harness.Reservoir(3, seed)
        for i in range(100):
            if r.wants():
                r.put(i)
        return r.items

    assert sample(5) == sample(5) and sample(5) != sample(6)
    assert len(set(sample(5))) == 3


def test_sub_seeds_take_large_seeds():
    a = harness.sub_seed(2**31 + 12345, 1)
    assert 0 <= a < 2**63 and a != harness.sub_seed(2**31 + 12345, 2)


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        text = f.read_text()
        assert not re.search(r"^\s*(from|import)\s+(tq_tpu|jax|flax)",
                             text, re.M), f
