"""The port's leaf modules against the JAX package's.

The NumPy oracle (``ops/oracle.py``), the native oracle's loader
(``utils/native.py``; held also against the port's ``tr_quantize``),
``lstm_recurrent_term_macs``, the run config (``config.py``: the same
JSON, the same refusals, the same sweep columns), the meters, the device
trace and the build-directory helper.  Integers bit for bit; floats as
each test states.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu import config as jconfig
from tq_tpu.layers.common import TRParams as JTRParams
from tq_tpu.ops import oracle as joracle
from tq_tpu.utils import meters as jmeters
from tq_tpu.utils import native as jnative
from tq_tpu_torch import config as tconfig
from tq_tpu_torch.kernels import _build
from tq_tpu_torch.kernels.tr_quantize import tr_quantize
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.ops import oracle as toracle
from tq_tpu_torch.profilers.term_ops import lstm_recurrent_term_macs
from tq_tpu_torch.utils import cache as tcache
from tq_tpu_torch.utils import meters as tmeters
from tq_tpu_torch.utils import native as tnative
from tq_tpu_torch.utils import trace as ttrace

jterm_ops = importlib.import_module("tq_tpu.profilers.term_ops")

ROOT = Path(__file__).resolve().parent.parent
# (bits, group_size, budget): tests/test_native_oracle.py's settings.
ORACLE_SETTINGS = [(8, 1, 3), (9, 8, 12), (4, 16, 14), (6, 5, 7)]
NATIVE_SETTINGS = [(8, 1, 3), (9, 8, 12), (9, 32, 40)]


# ------------------------------------------------------------------ oracles


@pytest.mark.parametrize("bits", [1, 4, 8, 9, 12])
def test_hese_encode_oracle_equals_jax(rng, bits):
    sf = 0.05
    vals = list(rng.normal(0, 2.0 ** bits * sf / 3, size=200)) + [
        0.0, -0.0, 0.025, -0.025, 1e9, -1e9]
    for v in vals:
        assert (toracle.hese_encode_oracle(v, sf, bits)
                == joracle.hese_encode_oracle(v, sf, bits)), v


@pytest.mark.parametrize("bits,g,k", ORACLE_SETTINGS)
def test_term_reveal_oracle_equals_jax(rng, bits, g, k):
    x = rng.normal(0, 2.0, size=(3, 40)).astype(np.float32)
    got = toracle.term_reveal_oracle(x, 0.05, bits, g, k)
    want = joracle.term_reveal_oracle(x, 0.05, bits, g, k)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,g,k", ORACLE_SETTINGS)
def test_native_through_both_loaders(rng, bits, g, k):
    """The same library through the port's loader and the JAX package's,
    and against the Python oracle's integer terms."""
    x = rng.normal(0, 2.0, size=(3, 40)).astype(np.float32)
    got = tnative.tr_reveal_native(x, 0.05, bits, g, k)
    np.testing.assert_array_equal(
        got, jnative.tr_reveal_native(x, 0.05, bits, g, k))
    ref = toracle.term_reveal_oracle(x, 0.05, bits, g, k)
    np.testing.assert_array_equal(np.round(got / 0.05).astype(int),
                                  np.round(ref / 0.05).astype(int))


def test_native_term_counts_through_both_loaders():
    q = np.arange(1 << 12)
    np.testing.assert_array_equal(tnative.hese_term_counts_native(q, 13),
                                  jnative.hese_term_counts_native(q, 13))


@pytest.mark.parametrize("bits,g,k", NATIVE_SETTINGS)
def test_native_equals_port_tr_quantize(rng, bits, g, k):
    """The port's ``tr_quantize`` (its plain version on the CPU; the card's
    kernels in chip_smoke's ``oracle`` phase) bit for bit against the
    native library, grouped along the last axis."""
    x = rng.normal(0, 3.0, size=(8, 512)).astype(np.float32)
    want = tnative.tr_reveal_native(x, 0.04, bits, g, k)
    got = tr_quantize(torch.from_numpy(x), torch.tensor(0.04), bits, g, k,
                      axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- cost profiler


@pytest.mark.parametrize("shape", [
    (35, 20, 650, 650, 2),   # the LSTM trainer at full width
    (35, 10, 650, 650, 2),   # the LSTM sweep's eval batches
    (35, 20, 200, 200, 2),   # GRU, RNN_TANH, RNN_RELU at width 200
    (35, 20, 16, 16, 1)],
    ids=["lstm-train", "lstm-eval", "gru-rnn", "tiny"])
@pytest.mark.parametrize("setting", [(8, 8, 24, 8, 8), (6, 1, 6, 8, 8),
                                     (9, 1, 12, 9, 3), (4, 16, 6, 6, 6)])
def test_lstm_recurrent_term_macs_equals_jax(shape, setting):
    got = lstm_recurrent_term_macs(*shape, TRParams(*setting))
    assert isinstance(got, int)
    assert got == jterm_ops.lstm_recurrent_term_macs(*shape,
                                                     JTRParams(*setting))


def test_lstm_recurrent_term_macs_not_exported():
    """As in the JAX package, an extension kept out of the profilers'
    exports."""
    import tq_tpu_torch.profilers as tprof

    assert not hasattr(tprof, "lstm_recurrent_term_macs")


# ------------------------------------------------------------------ config


CONFIG = {
    "workload": "mlp",
    "settings": [
        {"weight_bits": 4, "weight_terms": 6, "data_bits": 6,
         "data_terms": 6, "group_size": 16},
        [2, 2, 6, 6, 1],
    ],
    "calib": {"num_bins": 4096},
    "mesh": {"n_data": 2},
    "batch_size": 32,
}


def _write(tmp_path, d, name="cfg.json"):
    p = tmp_path / name
    p.write_text(json.dumps(d))
    return p


def test_same_json_same_dataclasses(tmp_path):
    p = _write(tmp_path, CONFIG)
    got, want = tconfig.load_config(p), jconfig.load_config(p)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.settings[1] == tconfig.Setting(2, 2, 6, 6, 1)
    assert type(got.calib).__module__ == "tq_tpu_torch.layers.quantize"
    assert (tconfig.MAX_GROUP_SIZE, tconfig.MAX_GROUP_BUDGET,
            tconfig.MAX_DATA_TERMS) == (31, 127, 15)


@pytest.mark.parametrize("setting,oversize", [
    ((9, 24, 9, 3, 32), False),   # g > 31 (5-bit field)
    ((9, 128, 9, 3, 8), False),   # budget > 127 (7-bit field)
    ((9, 24, 9, 16, 8), False),   # data terms > 15 (4-bit field)
    ((9, 24, 9, 3, 0), False),    # no group
    ((9, -1, 9, 3, 8), True),     # negative budget, even oversize
])
def test_same_refusals_of_settings(setting, oversize):
    with pytest.raises(ValueError) as want:
        jconfig.Setting(*setting).validate(oversize)
    with pytest.raises(ValueError) as got:
        tconfig.Setting(*setting).validate(oversize)
    assert str(got.value) == str(want.value)


def test_oversize_allowed_as_in_jax():
    """The group-size grid's g = 32 point needs the explicit override."""
    s = (9, 32, 9, 3, 32)
    assert tconfig.Setting(*s).validate(allow_oversize=True) == \
        tconfig.Setting(*s)
    jconfig.Setting(*s).validate(allow_oversize=True)


@pytest.mark.parametrize("bad,match", [
    ({"workload": "mlp", "typo_key": 1}, "typo_key"),
    ({"workload": "gan"}, "unknown workload"),
    ({"workload": "mlp", "calib": {"bins": 3}}, "bins"),
    ({"workload": "mlp", "settings": [[9, 24, 9, 3, 32]]}, "group_size"),
])
def test_same_refusals_of_configs(tmp_path, bad, match):
    p = _write(tmp_path, bad)
    with pytest.raises((ValueError, TypeError)) as want:
        jconfig.load_config(p)
    with pytest.raises(type(want.value), match=match) as got:
        tconfig.load_config(p)
    assert str(got.value) == str(want.value)


def test_unknown_workload_rejected():
    with pytest.raises(ValueError):
        tconfig.RunConfig(workload="gan").validate()


def test_run_mlp_config_equals_jax(tmp_path):
    """One UQ setting through the port's CLI (``--device cpu``) and the
    JAX package's ``run``: equal columns (accs, tmacs, param_bits), the
    port's also in its out_file."""
    cfg = {"workload": "mlp", "settings": [[2, 2, 6, 6, 1]],
           "checkpoint": str(ROOT / "pretrained" / "mnist_mlp.npz")}
    tcfg = _write(tmp_path, {**cfg, "out_file": str(tmp_path / "t.json")},
                  "t_cfg.json")
    jcfg = _write(tmp_path, {**cfg, "out_file": str(tmp_path / "j.json")},
                  "j_cfg.json")
    tconfig.main([str(tcfg), "--device", "cpu"])
    want = jconfig.run(jconfig.load_config(jcfg))
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == want
    assert got["tmacs"] == [8024064.0]


def test_run_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconfig.run(tconfig.RunConfig(
            workload="mlp", settings=(tconfig.Setting(2, 2, 6, 6, 1),)))


# ------------------------------------------------------------------ meters


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3, 10)])
def test_accuracy_equals_jax(rng, topk):
    """Ties included (scores rounded to a coarse grid): both packages
    rank a tie's higher index first."""
    scores = np.round(rng.normal(size=(37, 10)), 1).astype(np.float32)
    labels = rng.integers(0, 10, size=37)
    got = tmeters.accuracy(torch.from_numpy(scores),
                           torch.from_numpy(labels), topk)
    want = jmeters.accuracy(jnp.asarray(scores), jnp.asarray(labels), topk)
    assert got == want
    assert got == tmeters.accuracy(scores, labels, topk)


def test_meters_equal_jax(capsys):
    vals = [(0.5, 4), (1.25, 2), (3.0, 1), (2.0, 0)]
    tm, jm = tmeters.AverageMeter("loss", ":.4f"), jmeters.AverageMeter(
        "loss", ":.4f")
    for v, n in vals:
        tm.update(v, n)
        jm.update(v, n)
        assert str(tm) == str(jm)
        assert (tm.val, tm.sum, tm.count, tm.avg) == (jm.val, jm.sum,
                                                       jm.count, jm.avg)
    tacc = tmeters.AverageMeter("acc")
    tacc.update(99.5)
    tmeters.ProgressMeter(10, [tm, tacc], prefix="Test: ").display(3)
    jacc = jmeters.AverageMeter("acc")
    jacc.update(99.5)
    jmeters.ProgressMeter(10, [jm, jacc], prefix="Test: ").display(3)
    t_line, j_line = capsys.readouterr().out.splitlines()
    assert t_line == j_line
    tm.reset()
    assert (tm.val, tm.sum, tm.count, tm.avg) == (0.0, 0.0, 0.0, 0.0)


# ------------------------------------------------------- trace and cache


def test_device_trace_writes_chrome_trace(tmp_path):
    """On the CPU the trace holds the CPU operators of the block."""
    a = torch.randn(64, 64)
    with ttrace.device_trace(tmp_path, "probe") as path:
        assert path == tmp_path / "probe" and path.is_dir()
        torch.mm(a, a)
    trace = json.loads((path / ttrace.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_compilation_cache_is_the_build_directory(tmp_path, monkeypatch):
    default = _build.BUILD_DIR
    assert tcache.enable_compilation_cache() == default
    assert default == Path(_build.__file__).resolve().parent.parent / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", default)  # restored after
    assert tcache.enable_compilation_cache(str(tmp_path)) == tmp_path
    assert _build.library_path().parent == tmp_path
    assert _build._LIB is None  # nothing built or loaded
