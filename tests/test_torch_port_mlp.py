"""The MNIST MLP slice of the port against the JAX package, at full width.

``pretrained/mnist_mlp.npz`` is loaded through both packages (the port via
``params_from_jax``) and the same synthetic test samples go through
convert -> calibrate -> eval -> profile on the CPU.
"""

import gzip
import importlib.util
import json
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.data.mnist import load_mnist as j_load_mnist
from tq_tpu.data.synthetic import synthetic_mnist as j_synthetic_mnist
from tq_tpu.layers.common import TRParams as JTRParams
from tq_tpu.layers.linear import tr_dense_apply as j_dense_apply
from tq_tpu.layers.quantize import act_quantize as j_act_quantize
from tq_tpu.models import mlp as jmlp
from tq_tpu.profilers import model_cost as j_model_cost
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu_torch.data.mnist import load_mnist as t_load_mnist
from tq_tpu_torch.data.synthetic import synthetic_mnist as t_synthetic_mnist
from tq_tpu_torch.evals.mlp import run_sweep
from tq_tpu_torch.evals.train_mlp import load_or_train
from tq_tpu_torch.layers.common import TRParams as TTRParams
from tq_tpu_torch.layers.linear import tr_dense_apply as t_dense_apply
from tq_tpu_torch.layers.quantize import act_quantize as t_act_quantize
from tq_tpu_torch.models import mlp as tmlp
from tq_tpu_torch.profilers import model_cost as t_model_cost
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.params import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "pretrained" / "mnist_mlp.npz"
N_SAMPLES = 256


@pytest.fixture(scope="module")
def jax_params():
    return jckpt.load_params(CKPT)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, "cpu")


@pytest.fixture(scope="module")
def x_test():
    _, (x, _) = j_synthetic_mnist(num_train=8, num_test=N_SAMPLES)
    return x


def test_synthetic_data_byte_identical():
    for seed in (1234, 7):
        a = j_synthetic_mnist(num_train=40, num_test=30, seed=seed)
        b = t_synthetic_mnist(num_train=40, num_test=30, seed=seed)
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


def _write_idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim)
    header += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def test_load_mnist_idx_files_identical(tmp_path, rng):
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for split, n in (("train", 6), ("t10k", 4)):
        _write_idx(raw / f"{split}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, size=(n, 28, 28)).astype(np.uint8),
                   0x08)
        _write_idx(raw / f"{split}-labels-idx1-ubyte.gz",
                   rng.integers(0, 10, size=(n,)).astype(np.uint8), 0x08)
    a, b = j_load_mnist(str(tmp_path)), t_load_mnist(str(tmp_path))
    assert a[2] == b[2] == "real"
    for (xa, ya), (xb, yb) in zip(a[:2], b[:2]):
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
        assert xb.shape[1:] == (1, 28, 28)


def test_fp32_apply_matches(jax_params, port_params, x_test):
    want = np.asarray(jmlp.apply(jax_params, jnp.asarray(x_test)))
    got = tmlp.apply(port_params, torch.from_numpy(x_test)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _layerwise(dense_apply, act_quantize, qparams, qcfg, qstate, h, relu):
    """Per layer: (input, quantized input, output) of the eval forward."""
    out = []
    for i, name in enumerate(tmlp.LAYER_NAMES):
        tr = qcfg[name]
        hq = act_quantize(h, qstate[name]["sf"], tr.data_bits, tr.data_terms)
        y, _ = dense_apply(qparams[name], tr, qstate[name], h, False)
        out.append((h, hq, y))
        h = relu(y) if i < len(tmlp.LAYER_NAMES) - 1 else y
    return out


@pytest.mark.parametrize("quantize_input", [False, True])
@pytest.mark.parametrize("setting", [(4, 6, 4, 2, 16), (2, 2, 6, 6, 1),
                                     (4, 10, 6, 6, 16)])
def test_slice_matches_jax(jax_params, port_params, x_test, setting,
                           quantize_input):
    wb, wt, db, dt, gs = setting
    layers = jmlp.static_layer_settings(wb, gs, wt)
    jqp, jqc, jqs = jmlp.convert(jax_params, layers, db, dt,
                                 quantize_input=quantize_input)
    tqp, tqc, tqs = tmlp.convert(port_params, layers, db, dt,
                                 quantize_input=quantize_input)
    for name in tmlp.LAYER_NAMES:  # conversion: bit for bit
        np.testing.assert_array_equal(tqp[name]["w"].numpy(),
                                      np.asarray(jqp[name]["w"]))
        assert tqp[name]["w_sf"].numpy() == np.asarray(jqp[name]["w_sf"])

    xj, xt = jnp.asarray(x_test), torch.from_numpy(x_test)
    _, jqs = jmlp.make_quantized_apply(jqc, track=True)(jqp, jqs, xj)
    _, tqs = tmlp.make_quantized_apply(tqc, track=True)(tqp, tqs, xt)
    jqs, tqs = jmlp.finalize(jqs, jqc), tmlp.finalize(tqs, tqc)
    for name in tmlp.LAYER_NAMES:  # calibration: the same scale
        assert float(tqs[name]["sf"]) == float(jqs[name]["sf"]), name

    want, _ = jmlp.make_quantized_apply(jqc, track=False)(jqp, jqs, xj)
    got, _ = tmlp.make_quantized_apply(tqc, track=False)(tqp, tqs, xt)
    want, got = np.asarray(want), got.numpy()
    if not quantize_input:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        # A quantized activation differs only where the two packages'
        # float32 sums (another order) fall on two sides of a rounding
        # boundary.  Given the same input every layer agrees, and every
        # row without such a flip agrees end to end.
        jl = _layerwise(j_dense_apply, j_act_quantize, jqp, jqc, jqs,
                        xj.reshape(N_SAMPLES, -1), lambda v: jnp.maximum(v, 0))
        tl = _layerwise(t_dense_apply, t_act_quantize, tqp, tqc, tqs,
                        xt.reshape(N_SAMPLES, -1), torch.relu)
        flipped = np.zeros(N_SAMPLES, bool)
        for name, (hj, hqj, yj), (_, hqt, _) in zip(tmlp.LAYER_NAMES, jl, tl):
            flipped |= (hqt.numpy() != np.asarray(hqj)).any(axis=1)
            y, _ = t_dense_apply(tqp[name], tqc[name], tqs[name],
                                 torch.from_numpy(np.array(hj)), False)
            np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0,
                                       atol=1e-4, err_msg=name)
        assert flipped.sum() <= N_SAMPLES // 100
        np.testing.assert_allclose(got[~flipped], want[~flipped], rtol=0,
                                   atol=1e-4)

    jtrs = [JTRParams(wb, gs, wt, db, dt)] * 3
    ttrs = [TTRParams(wb, gs, wt, db, dt)] * 3
    jcost = j_model_cost(list(zip(jmlp.layer_costs(1), jtrs)),
                         {n: jqp[n]["w"] for n in jmlp.LAYER_NAMES},
                         {n: jqp[n]["w_sf"] for n in jmlp.LAYER_NAMES},
                         merge_hack=True)
    for merge_hack in (True, False):
        tcost = t_model_cost(list(zip(tmlp.layer_costs(1), ttrs)),
                             {n: tqp[n]["w"] for n in tmlp.LAYER_NAMES},
                             {n: tqp[n]["w_sf"] for n in tmlp.LAYER_NAMES},
                             merge_hack=merge_hack)
        if merge_hack:
            assert tcost == jcost
        else:
            assert tcost == j_model_cost(
                list(zip(jmlp.layer_costs(1), jtrs)),
                {n: jqp[n]["w"] for n in jmlp.LAYER_NAMES},
                {n: jqp[n]["w_sf"] for n in jmlp.LAYER_NAMES},
                merge_hack=False)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_expected_sweeps_pinned_to_jax(jax_params, port_params):
    """chip_smoke.EXPECTED_SWEEPS holds the JAX package's tmacs and
    param_bits (convert + model_cost with the reference's merge hack)."""
    sweeps = _chip_smoke().EXPECTED_SWEEPS
    assert {"mnist-quant", "mnist-tr"} <= set(sweeps)
    for name, exp in sweeps.items():
        s = exp["settings"]
        for i, (wb, wt, db, dt, gs) in enumerate(
                zip(s["wb"], s["wt"], s["db"], s["dt"], s["gs"])):
            layers = jmlp.static_layer_settings(wb, gs, wt)
            qp, _, _ = jmlp.convert(jax_params, layers, db, dt)
            want = j_model_cost(
                list(zip(jmlp.layer_costs(1),
                         [JTRParams(wb, gs, wt, db, dt)] * 3)),
                {n: qp[n]["w"] for n in jmlp.LAYER_NAMES},
                {n: qp[n]["w_sf"] for n in jmlp.LAYER_NAMES}, merge_hack=True)
            assert (exp["tmacs"][i], exp["param_bits"][i]) == want, (name, i)
            tqp, _, _ = tmlp.convert(port_params, layers, db, dt)
            got = t_model_cost(
                list(zip(tmlp.layer_costs(1),
                         [TTRParams(wb, gs, wt, db, dt)] * 3)),
                {n: tqp[n]["w"] for n in tmlp.LAYER_NAMES},
                {n: tqp[n]["w_sf"] for n in tmlp.LAYER_NAMES}, merge_hack=True)
            assert got == want, (name, i)


def test_run_sweep_cpu_schema_and_resume(tmp_path):
    out = tmp_path / "sweep.json"
    # A partial file from a crashed sweep: its first setting is kept as is.
    out.write_text(json.dumps({"accs": [12.5], "tmacs": [1.0],
                               "param_bits": [2.0]}))
    res = run_sweep([2, 3], [2, 3], [6, 6], [6, 6], [1, 1], str(out),
                    checkpoint=str(CKPT), verbose=False, device="cpu")
    assert res == {"accs": [12.5, 100.0], "tmacs": [1.0, 12036096.0],
                   "param_bits": [2.0, 2006016.0]}
    assert json.loads(out.read_text()) == res


def test_load_or_train_without_checkpoint_raises(tmp_path):
    """With no checkpoint, load_or_train no longer raises: it trains (here
    one batch), saves to the path and returns what it saved, which the
    JAX package loads."""
    path = tmp_path / "sub" / "missing.npz"
    params = load_or_train(str(path), device="cpu", dry_run=True,
                           verbose=False)
    assert path.exists()
    saved = jckpt.load_params(path)
    for name in tmlp.LAYER_NAMES:
        for k in ("w", "b"):
            np.testing.assert_array_equal(saved[name][k],
                                          params[name][k].numpy())
    again = load_or_train(str(path), device="cpu")
    assert torch.equal(again["fc1"]["w"], params["fc1"]["w"])


def test_checkpoint_round_trip_across_packages(tmp_path, port_params):
    tree = {"mlp": port_params,
            "state": {"sf": torch.tensor(0.25), "hist": torch.arange(5.0)},
            "layers": [torch.ones(2, dtype=torch.int32), None]}
    tckpt.save_params(tmp_path / "port.npz", tree, meta={"cell": "LSTM"})
    back, meta = tckpt.load_params(tmp_path / "port.npz", with_meta=True)
    assert meta == {"store_dtype": "none", "cell": "LSTM"}
    assert back["layers"][1] is None
    flat_in, flat_back = tckpt.flatten_tree(tree), tckpt.flatten_tree(back)
    assert flat_in.keys() == flat_back.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_back[k], flat_in[k])
        assert flat_back[k].dtype == flat_in[k].dtype
    # Written by the port, read by the JAX package, and the other way.
    jback = jckpt.load_params(tmp_path / "port.npz")
    np.testing.assert_array_equal(jback["mlp"]["fc2"]["w"],
                                  port_params["fc2"]["w"].numpy())
    jckpt.save_params(tmp_path / "jax.npz", jback, store_dtype=np.float16)
    half = tckpt.load_params(tmp_path / "jax.npz")
    assert half["mlp"]["fc1"]["w"].dtype == np.float32
    np.testing.assert_array_equal(
        half["mlp"]["fc1"]["w"],
        port_params["fc1"]["w"].numpy().astype(np.float16).astype(np.float32))
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_params(tmp_path / "bad.npz", {"__meta__": {"x": 1}})


def test_params_from_jax_keeps_layout(jax_params, port_params):
    for name, (d_in, d_out) in zip(tmlp.LAYER_NAMES, tmlp.DIMS):
        w = port_params[name]["w"]
        assert w.shape == (d_in, d_out) and w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), jax_params[name]["w"])


def test_init_shapes_and_bounds():
    params = tmlp.init(torch.Generator().manual_seed(0), device="cpu")
    again = tmlp.init(torch.Generator().manual_seed(0), device="cpu")
    for name, (d_in, d_out) in zip(tmlp.LAYER_NAMES, tmlp.DIMS):
        w, b = params[name]["w"], params[name]["b"]
        assert w.shape == (d_in, d_out) and b.shape == (d_out,)
        assert float(w.abs().max()) <= d_in ** -0.5
        assert torch.equal(w, again[name]["w"])
    logp = tmlp.apply(params, torch.zeros(3, 1, 28, 28))
    torch.testing.assert_close(logp.exp().sum(-1), torch.ones(3))
