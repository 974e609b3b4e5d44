"""The port's ``parallel/`` (mesh, sharding, tensor-parallel term matmuls,
the Transformer's TP serving forward, DP x TP training, multihost, the
sharded checkpoint, the launcher) against the JAX package.

The port runs in gloo ranks on the CPU, started once per world size by a
module-scoped fixture (``tests/_torch_port_parallel_worker.py`` holds the
rank functions); the JAX package runs here on the conftest's virtual
devices, on a mesh of the same shape (``devices=jax.devices()[:n]``) and
the same numpy inputs from a seed.  Tolerances are stated per test:
column-parallel and packed rtol 1e-5, atol 1e-5 (the JAX tests'); row
and overlap rtol 1e-4, atol 1e-4 (K sums in another order); the int8 mode
as the JAX test against JAX and bit for bit against the port's unsharded
call where only N is split; the Transformer rtol 2e-4, atol 2e-4; the
train step's loss rtol 1e-5 at dropout 0; the checkpoint exact.
"""

import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_parallel_worker as W
from tq_tpu.kernels.term_matmul import (PackedWeight8, pack_weight_int,
                                        pack_weight_u8s)
from tq_tpu.layers.common import TRParams, quantize_weight
from tq_tpu.models import mlp as jmlp
from tq_tpu.models import transformer_lm as jtl
from tq_tpu.ops.term_reveal import term_reveal
from tq_tpu.parallel import sharding as jsh
from tq_tpu.parallel import tp as jtp
from tq_tpu.parallel.mesh import make_mesh as j_make_mesh
from tq_tpu_torch.parallel import launch, multihost, sharding
from tq_tpu_torch.utils.checkpoint import load_params_orbax, save_params_orbax
from tq_tpu_torch.utils.params import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32


def _jmesh(n_data, n_model):
    return j_make_mesh(n_data, n_model,
                       devices=jax.devices()[:n_data * n_model])


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ------------------------------------------------------------ the inputs


def _tp_cases():
    """The JAX tests' operands (tests/test_tp_matmul.py), each case
    {fn, x, w or the pack, sf, bits, k, flags} as numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(F32)
    w = (rng.normal(size=(256, 128)) * 0.1).astype(F32)
    f32 = dict(x=x, w=w, sf=0.04, bits=8, k=3)

    rng7 = np.random.default_rng(7)
    x8 = rng7.normal(size=(16, 64)).astype(F32)
    w8 = jnp.asarray(rng7.normal(size=(64, 32)) * 0.1, jnp.float32)
    wq, w_sf = quantize_weight(w8, TRParams(7, 8, 12, 7, 3), axis=0)
    wi, w_sf_i = pack_weight_int(wq, w_sf, 7)
    int8 = dict(x=x8, w=np.asarray(wi), w_sf_int=float(w_sf_i), sf=0.05,
                bits=7, k=3, int8=True)
    wq16, w_sf16 = quantize_weight(w8, TRParams(8, 8, 24, 8, 3), axis=0)
    wi16, w_sf_i16 = pack_weight_int(wq16, w_sf16, 8)
    bf16 = dict(x=x8, w=np.asarray(wi16), w_sf_int=float(w_sf_i16),
                sf=0.05, bits=8, k=3, bf16=True)

    rng1 = np.random.default_rng(1)
    xp = rng1.normal(size=(16, 64)).astype(F32)
    wf = jnp.asarray(rng1.normal(size=(64, 128)) * 0.05, jnp.float32)
    wp = pack_weight_u8s(term_reveal(wf.T, jnp.float32(0.002), 8, 8, 24).T,
                         jnp.float32(0.002), 8)
    pack = dict(x=xp, lo=np.asarray(wp.lo), signs=np.asarray(wp.signs),
                w_sf=np.asarray(wp.w_sf, F32), bits=8, k=3)
    cases = {}
    for mode, case in (("f32", f32), ("int8", int8), ("bf16_int16", bf16)):
        for fn in ("col", "row", "overlap"):
            cases[f"{fn}_{mode}"] = {**case, "fn": fn}
    cases["col_packed_bf16"] = {**pack, "fn": "col_packed", "sf": 0.04,
                                "bf16": True, "quantize_x": True}
    cases["col_packed_raw"] = {**pack, "fn": "col_packed", "sf": 1.0,
                               "bf16": False, "quantize_x": False}
    return cases


def _jax_tp(case, mesh):
    fn = {"col": jtp.tp_term_matmul_col, "row": jtp.tp_term_matmul_row,
          "overlap": jtp.tp_term_matmul_overlap}
    x, sf = jnp.asarray(case["x"]), jnp.float32(case["sf"])
    if case["fn"] == "col_packed":
        wp = PackedWeight8(*(jnp.asarray(case[k])
                             for k in ("lo", "signs", "w_sf")))
        return np.asarray(jtp.tp_term_matmul_col_packed(
            x, wp, sf, case["bits"], case["k"], mesh, bf16=case["bf16"],
            quantize_x=case["quantize_x"]))
    w_sf = case.get("w_sf_int")
    return np.asarray(fn[case["fn"]](
        x, jnp.asarray(case["w"]), sf, case["bits"], case["k"], mesh,
        w_sf=None if w_sf is None else jnp.float32(w_sf),
        int8=case.get("int8", False), bf16=case.get("bf16", False)))


def _mlp_inputs():
    rng = np.random.default_rng(0)
    return {"params": _np_tree(jmlp.init(jax.random.PRNGKey(0))),
            "x": rng.normal(size=(32, 1, 28, 28)).astype(F32),
            "y": rng.integers(0, 10, size=(32,)).astype(np.int64),
            "xq": rng.normal(size=(64, 1, 28, 28)).astype(F32)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tfm = jtl.init(jax.random.PRNGKey(0), vocab=64, emsize=16, nhead=2,
                   nhid=16, nlayers=1)
    return {
        "tp": _tp_cases(),
        "mlp": _mlp_inputs(),
        "transformer": {"params": _np_tree(tfm), "tokens": np.random
                        .default_rng(3).integers(0, 64, (7, 2))
                        .astype(np.int32)},
        "ckpt_path": str(tmp_path_factory.mktemp("ckpt") / "tp_mlp"),
        "batch": np.arange(32, dtype=F32).reshape(16, 2),
    }


@pytest.fixture(scope="module")
def world2(inputs):
    return launch.run(W.parallel_world2, 2, args=(inputs,),
                      timeout=300)


@pytest.fixture(scope="module")
def world4(inputs):
    return launch.run(W.parallel_world4, 4, args=(inputs,),
                      timeout=300)


# ---------------------------------------------------------------- mesh


def test_mesh_shapes(world2, world4):
    assert world2["shapes"]["m12"] == (1, 2)
    assert world2["shapes"]["m21"] == (2, 1)
    assert world2["shapes"]["local"] == (2, 1)
    assert world2["shapes"]["names"] == ("data", "model")
    assert world4["shape"] == tuple(_jmesh(2, 2).devices.shape)


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mesh_bad_factorization(world2, world4):
    """The JAX package's texts, on as many devices as the port's ranks."""
    assert world4["errors"]["n_model_3"] == _jax_error(
        lambda: j_make_mesh(n_model=3, devices=jax.devices()[:4]))
    assert world2["errors"]["n_model_3"] == _jax_error(
        lambda: j_make_mesh(n_model=3, devices=jax.devices()[:2]))
    assert world2["errors"]["too_big"] == _jax_error(
        lambda: j_make_mesh(2, 2, devices=jax.devices()[:2]))


# ------------------------------------------------------------- sharding


def test_param_specs_match_jax():
    jspecs = jsh.mlp_param_specs()
    for name, leaves in sharding.mlp_param_specs().items():
        for leaf, spec in leaves.items():
            assert spec == tuple(jspecs[name][leaf]), (name, leaf)
    assert sharding.batch_spec() == tuple(jsh.batch_spec())
    cnn = {"conv": {"w": np.zeros((3, 3, 4, 8)), "b": np.zeros(8)},
           "fc": {"w": np.zeros((8, 10)), "sf": np.zeros(())}, "n": 3}
    want = jsh.cnn_param_specs(cnn)
    for name, leaves in sharding.cnn_param_specs(cnn).items():
        for leaf, spec in leaves.items():
            assert spec == tuple(want[name][leaf]), (name, leaf)


def test_shard_pytree_places_leaves(world2, inputs):
    """fc1 column-parallel, fc2 row-parallel, fc3 replicated: each rank
    holds the shard the JAX spec names (here rank 0's of a (1, 2) mesh)."""
    p = world2["placement"]
    assert p["fc1/w"] == (784, 256) and p["fc1/b"] == (256,)
    assert p["fc2/w"] == (256, 512) and p["fc2/b"] == (512,)
    assert p["fc3/w"] == (512, 10) and p["fc3/b"] == (10,)
    np.testing.assert_array_equal(world2["fc1_w_rank0"],
                                  inputs["mlp"]["params"]["fc1"]["w"][:, :256])


def test_shard_pytree_splits_a_packed_weight_per_field(world2, inputs):
    case = inputs["tp"]["col_packed_bf16"]
    assert world2["packed_shard"] == [(64, 64), (8, 64), ()]
    assert case["lo"].shape == (64, 128)
    assert world2["packed_contiguous"]


SPEC_CASES = [
    (("fc1", "w"), (None, "model")),
    (("fc2", "w"), ("model", None)),
    (("fc1", "w_sf"), ()),
    (("dec", "w", "lo"), (None, "model")),
    (("dec", "w", "signs"), (None, "model")),
    (("dec", "w", "w_sf"), ()),
    ("dec/w/lo", (None, "model")),
    (("absent", "w"), ()),
]


@pytest.mark.parametrize("path,want", SPEC_CASES,
                         ids=[str(p) for p, _ in SPEC_CASES])
def test_spec_of_names_each_leaf(path, want):
    """One rule for shard_pytree and the checkpoint: a leaf takes its
    path's spec, a PackedWeight8's planes its node's, the rest ()."""
    specs = {**sharding.mlp_param_specs(),
             "dec": {"w": sharding.P(None, "model")}}
    assert sharding.spec_of(specs, path) == want


def test_sharded_checkpoint_roundtrip_packed_weight(world2, inputs):
    """A 9-bit pack saved under the spec of its path: its planes split
    over N, its scale replicated; read back into zeroed shards and read
    whole, exact."""
    ck = world2["checkpoint_packed"]
    case = inputs["tp"]["col_packed_bf16"]
    assert ck["type"] == ck["whole_type"] == "PackedWeight8"
    assert ck["shard_shapes"] == [(64, 64), (8, 64), ()]
    assert ck["shards_equal"]
    for k in ("lo", "signs", "w_sf"):
        np.testing.assert_array_equal(ck["whole"][k], case[k], err_msg=k)


def test_shard_batch_rows_and_tail(world2):
    x = np.arange(18.0, dtype=F32).reshape(6, 3)
    np.testing.assert_array_equal(world2["shard_batch"]["even"], x[:3])
    np.testing.assert_array_equal(world2["shard_batch"]["tail"], x[:5])
    np.testing.assert_array_equal(world2["shard_batch"]["axis1"], x.T[:, :3])


def test_ppermute_and_psum_semantics(world2):
    """ppermute over [(0, 1)]: rank 0 receives zeros (as in JAX), and the
    gradient goes back the other way; psum sums over the dimension."""
    pp = world2["ppermute"]
    np.testing.assert_array_equal(pp["value"], np.zeros(3))
    np.testing.assert_array_equal(pp["grad"], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(pp["psum"], np.full(3, 3.0))


# ------------------------------------------------------ tensor-parallel


TP_NAMES = sorted(_tp_cases())


@pytest.mark.parametrize("name", TP_NAMES)
def test_tp_term_matmul_matches_jax_and_unsharded(world2, inputs, name):
    case = inputs["tp"][name]
    got = world2["tp"][name]
    want = _jax_tp(case, _jmesh(1, 2))
    row_like = case["fn"] in ("row", "overlap")
    tol = 1e-4 if row_like else 1e-5
    np.testing.assert_allclose(got["y"], want, rtol=tol, atol=tol)
    if case.get("int8") and not row_like:
        # Only N is split: the int8 mode's exact sums agree bit for bit.
        np.testing.assert_array_equal(got["y"], got["unsharded"])
    else:
        np.testing.assert_allclose(got["y"], got["unsharded"], rtol=tol,
                                   atol=tol)
    # The unsharded port call itself against the JAX package's.
    np.testing.assert_allclose(got["unsharded"], want, rtol=tol, atol=tol)


def test_column_parallel_under_export(world2, inputs):
    """The column-parallel product traced into a ``torch.export``
    program (the port's jit) gives the eager result."""
    case = inputs["tp"]["col_f32"]
    np.testing.assert_allclose(world2["tp_exported"],
                               _jax_tp(case, _jmesh(1, 2)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(world2["tp_exported"],
                                  world2["tp"]["col_f32"]["y"])


@pytest.mark.parametrize("branch", ["raw", "quantized"])
def test_transformer_tp_packed_decoder_matches(world2, inputs, branch):
    """The u8s decoder column-parallel over 'model' reproduces the
    unsharded quantized forward, and the JAX package's TP forward."""
    qp, qcfg, qs = jtl.convert(
        jax.tree.map(jnp.asarray, inputs["transformer"]["params"]),
        8, 8, 24, 8, 8, quantize_input=branch == "quantized")
    qs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in qs.items()}
    qp = jtl.pack(qp, qcfg, fmt="u8s")
    toks = jnp.asarray(inputs["transformer"]["tokens"])
    want, _ = jtl.make_tp_quantized_apply(qcfg, _jmesh(1, 2))(qp, qs, toks)
    got = world2["transformer"][branch]
    assert got["lo_shard"] == (16, 32)  # 64 vocab columns over 2 ranks
    np.testing.assert_allclose(got["tp"], np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["tp"], got["unsharded"], rtol=2e-4,
                               atol=2e-4)


def test_transformer_tp_requires_packed(world2):
    assert "u8s-packed" in world2["transformer"]["unpacked_error"]


def test_quantized_forward_under_mesh(world2, inputs):
    """The TR-converted MLP on a batch sharded over 'data' equals the JAX
    package's unsharded forward within its serving tolerance."""
    params = jax.tree.map(jnp.asarray, inputs["mlp"]["params"])
    qparams, qcfg, qstate = jmlp.convert(
        params, jmlp.static_layer_settings(4, 16, 14), 6, 6, True)
    qstate = {k: {**v, "sf": jnp.float32(0.05)} for k, v in qstate.items()}
    want, _ = jmlp.make_quantized_apply(qcfg, track=False)(
        qparams, qstate, jnp.asarray(inputs["mlp"]["xq"]))
    got = world2["mlp_under_mesh"]
    assert got.shape == (64, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=1e-2)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


# --------------------------------------------------------------- train


def _jax_sharded_step(monkeypatch, inputs, n_data, n_model):
    """The JAX package's sharded step at dropout 0 (its MLP's DROPOUT set
    to 0 for the call)."""
    from tq_tpu.parallel.train import setup_mlp_training

    monkeypatch.setattr(jmlp, "DROPOUT", 0.0)
    params, _, opt_state, step, evaluate = setup_mlp_training(
        _jmesh(n_data, n_model), lr=1.0, seed=0)
    x, y = (jnp.asarray(inputs["mlp"][k]) for k in ("x", "y"))
    p2, _, loss = step(params, opt_state, x, y.astype(jnp.int32),
                       jax.random.PRNGKey(7))
    return float(loss), _np_tree(p2), int(evaluate(p2, x, y))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["data2", "model2", "data2_model2"])
def test_sharded_train_step_matches_single(monkeypatch, world2, world4,
                                           inputs, shape):
    """One DP x TP step at dropout 0: the loss within rtol 1e-5 of the
    JAX package's sharded step and of the port's single-device step, the
    parameters within rtol 1e-4 of both, the same correct count."""
    got = (world4["train"] if shape == (2, 2)
           else world2["train"][{(2, 1): "m21", (1, 2): "m12"}[shape]])
    loss, p2, correct = _jax_sharded_step(monkeypatch, inputs, *shape)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], got["single_loss"], rtol=1e-5)
    for key, value in got["params"].items():
        name, leaf = key.split("/")
        np.testing.assert_allclose(value, got["single_params"][key],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(value, p2[name][leaf], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert got["correct"] == correct


# ------------------------------------------------------------ multihost


def test_global_mesh_shapes(world4):
    assert world4["global_mesh"] == (2, 2)
    assert world4["errors"]["global_3"] == _jax_error(
        lambda: j_make_mesh(n_model=3, devices=jax.devices()[:4]))


def test_host_local_batch_shards_over_data(world4, inputs):
    np.testing.assert_array_equal(world4["host_local_batch"],
                                  inputs["batch"])


def test_scaling_report_runs(world4):
    rep = world4["scaling_report"]
    assert rep["items_per_s"] > 0
    assert rep["n_devices"] == 4
    assert rep["n_processes"] == 4


def test_two_process_distributed_psum(tmp_path):
    """Two OS processes join through ``multihost.initialize`` (a
    ``file://`` rendezvous); a term-revealed sum over 'data' must give the
    same global value in both, one that depends on both processes'
    rows."""
    worker = Path(__file__).parent / "_torch_port_multihost_worker.py"
    url = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", url],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(ROOT))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    for rec in outs:
        assert rec["world"] == 2 and rec["mesh"] == [2, 1]
        assert rec["psum"] == rec["expect"], rec
    assert outs[0]["psum"] == outs[1]["psum"]


# ----------------------------------------------------------- checkpoint


def test_orbax_roundtrip(tmp_path):
    """The JAX test's tree through the port's pair, one process."""
    tree = params_from_jax({
        "enc": {"w": np.arange(12.0, dtype=F32).reshape(3, 4)},
        "rnn": [{"w_ih": np.ones((2, 8), F32)},
                {"w_ih": np.zeros((2, 8), F32)}],
        "sf": np.float32(0.05)}, "cpu")
    save_params_orbax(tmp_path / "ck", tree)
    back = load_params_orbax(tmp_path / "ck", like=tree)
    np.testing.assert_array_equal(back["enc"]["w"].numpy(),
                                  np.arange(12).reshape(3, 4))
    assert isinstance(back["rnn"], list) and len(back["rnn"]) == 2
    whole = load_params_orbax(tmp_path / "ck")
    for a, b in ((whole["enc"]["w"], tree["enc"]["w"]),
                 (whole["rnn"][1]["w_ih"], tree["rnn"][1]["w_ih"]),
                 (whole["sf"], tree["sf"])):
        assert torch.equal(a, b)


def test_sharded_checkpoint_roundtrip(world2, inputs):
    """Each rank writes its TP shards; read back into zeroed shards they
    are equal bit for bit, and read whole they are the global tree."""
    ck = world2["checkpoint"]
    assert ck["fc1_w_shard"] == (784, 256)
    assert ck["shards_equal"]
    for key, value in ck["whole"].items():
        name, leaf = key.split("/")
        np.testing.assert_array_equal(value,
                                      inputs["mlp"]["params"][name][leaf])


# --------------------------------------------------------------- launch


def test_launch_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*fails on purpose"):
        launch.run(W.fail_on_rank, 2, args=(1,), timeout=120)


def test_launch_kills_hung_ranks_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after"):
        launch.run(W.hang_on_rank, 2, args=(1,), timeout=8)
    assert time.monotonic() - t0 < 60
    assert not [c for c in multiprocessing.active_children() if c.is_alive()]


BACKEND_CASES = [("cpu", 1, 8, "gloo"), ("cuda", 8, 8, "nccl"),
                 ("cuda", 2, 1, "gloo"), ("cuda", 1, 1, "nccl"),
                 ("cuda", 1, 0, "gloo")]


@pytest.mark.parametrize("device,local,cards,want", BACKEND_CASES)
def test_backend_for(monkeypatch, device, local, cards, want):
    """NCCL only where this host has a card for each of its ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert launch.backend_for(device, local) == want


@pytest.mark.parametrize("local_env,want", [("8", "nccl"), (None, "gloo")])
def test_backend_for_a_multi_node_launch(monkeypatch, local_env, want):
    """Two hosts of eight cards, sixteen ranks: the ranks per host
    (``LOCAL_WORLD_SIZE``), not the world, decide the backend."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    if local_env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_env)
    assert launch.backend_for("cuda", launch.local_world_size(16)) == want


INIT_CASES = [(16, "8", 8, "nccl"), (2, None, 1, "gloo"),
              (2, "1", 1, "nccl"), (1, None, 1, None)]


@pytest.mark.parametrize("n,local_env,cards,want", INIT_CASES)
def test_multihost_initialize_backend(monkeypatch, n, local_env, cards,
                                      want):
    """``initialize`` takes launch's rule: two ranks on one card join
    over gloo, a card a rank over NCCL, one process joins nothing."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    if local_env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_env)
    multihost.initialize("localhost:29500", n, 0)
    if want is None:
        assert seen == []
    else:
        assert seen == [(want, {"init_method": "tcp://localhost:29500",
                                "world_size": n, "rank": 0})]


def test_multihost_initialize_without_an_address(monkeypatch):
    """No coordinator address: torchrun's ``env://`` rendezvous, with no
    rank where none is given (the JAX wrapper hands None on to
    ``jax.distributed.initialize``, which discovers the cluster)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    multihost.initialize(None, 2, None)
    multihost.initialize("file:///tmp/rdv", 2, 1)
    assert seen == [("gloo", {"init_method": "env://", "world_size": 2}),
                    ("gloo", {"init_method": "file:///tmp/rdv",
                              "world_size": 2, "rank": 1})]
