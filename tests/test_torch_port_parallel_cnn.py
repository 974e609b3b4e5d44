"""The rest of the JAX package's multi-device dry run on the port's ranks:
the tensor-parallel CNN forward (``parallel/tp.py::make_tp_cnn_apply``),
the data-parallel CNN eval (``evals/cnn.py::eval_setting(mesh=)``) and
the LM rows with the batch over 'data' (the Transformer and GRU train
steps' ``mesh=``, the GRU's quantized eval and greedy loop, the
Transformer's KV-cache decode).

The port runs in gloo ranks on the CPU, started once per world size by a
module-scoped fixture (``tests/_torch_port_parallel_cnn_worker.py``); the
JAX package runs here on the same numpy inputs.  Tolerances: the TP
ResNet-18 forward against the JAX unsharded forward rtol/atol 2e-3 (the
JAX test's, ``tests/test_parallel.py::test_cnn_tensor_parallel_params``),
each converted conv against the port's unsharded conv on the same input
1e-5 of max |y|, the logits against the port's unsharded ones 1e-2 of
max |logit| (the CNN rule of ``chip_smoke.py``); the DP eval's columns
equal to JAX's and its histograms and scales bit for bit with one rank;
the train steps' losses rtol 1e-5 and parameters rtol 1e-4 at dropout 0;
the serving rows gathered over 'data' against one rank atol 1e-5 and
their tokens equal, against JAX atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_parallel_cnn_worker as W
from tq_tpu.convert import convert_cnn, static_conv_layer_settings
from tq_tpu.convert.cnn import make_cnn_apply
from tq_tpu.evals import cnn as jcnn
from tq_tpu.evals.train_lstm import _train_step, _train_step_transformer
from tq_tpu.layers.qctx import QuantCtx as JQuantCtx
from tq_tpu.models import lstm_lm as jlm
from tq_tpu.models import resnet as jresnet
from tq_tpu.models import transformer_lm as jtl
from tq_tpu.parallel.mesh import make_mesh as j_make_mesh
from tq_tpu.parallel.sharding import shard_batch as j_shard_batch
from tq_tpu_torch.data.synthetic import synthetic_imagenet_batch
from tq_tpu_torch.parallel import launch

F32 = np.float32
T, B = 6, 8                # LM tokens (T, B): B/2 columns a 'data' rank
GREEDY_STEPS, CACHE_LEN = 4, 8
EVAL = dict(batch_size=4, n_synth=11, calib_pct=1.0, image=64)
CONV_RTOL = 1e-5
LOGIT_RTOL = 1e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jmesh(n_data, n_model):
    return j_make_mesh(n_data, n_model,
                       devices=jax.devices()[:n_data * n_model])


def _eval_batches():
    """Synthetic batches of 4, 4 and 3 images at 64 px: the last does not
    divide over two 'data' ranks, so it is replicated."""
    out, left, i = [], EVAL["n_synth"], 0
    while left:
        n = min(EVAL["batch_size"], left)
        out.append(synthetic_imagenet_batch(n, EVAL["image"], seed=i))
        left, i = left - n, i + 1
    return out


class _JaxRecorder(JQuantCtx):
    """The JAX package's context, keeping each converted conv's input,
    arguments and output."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = {}

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1):
        y = super().conv(name, params, x, stride, padding, groups)
        if name in self.cfg:
            self.seen[name] = (np.asarray(x), np.asarray(y), tuple(stride),
                               padding, groups)
        return y


@pytest.fixture(scope="module")
def jax_resnet(rng_x):
    """The JAX test's unsharded TR ResNet-18 forward (wb 8, g 8, wt 16,
    db 8, dt 4, every scale 0.05) on its input, jitted; and each
    converted conv's input and output, recorded in an eager forward."""
    params = jresnet.init(jax.random.PRNGKey(0))
    settings = static_conv_layer_settings(jresnet.conv_specs(), 8, 8, 16)
    qp, qcfg, qs = convert_cnn(jresnet, params, settings, 8, 4)
    qs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in qs.items()}
    x = jnp.asarray(rng_x)
    logits, _ = make_cnn_apply(jresnet, qcfg, track=False)(qp, qs, x)
    rec = _JaxRecorder(cfg=qcfg, state=qs, track=False)
    jresnet.apply(qp, x, rec)
    return {"params": _np_tree(params), "logits": np.asarray(logits),
            "layers": rec.seen}


@pytest.fixture(scope="module")
def rng_x():
    """The JAX test's images: the first draw of ``default_rng(0)``."""
    return np.random.default_rng(0).normal(size=(8, 64, 64, 3)).astype(F32)


@pytest.fixture(scope="module")
def inputs(jax_resnet, rng_x):
    rng = np.random.default_rng(1)
    vocab = 64
    tfm = jtl.init(jax.random.PRNGKey(3), vocab=vocab, emsize=16, nhead=2,
                   nhid=16, nlayers=1)
    gru = jlm.init(jax.random.PRNGKey(5), vocab=vocab, emsize=16, nhid=16,
                   nlayers=2, cell="GRU")
    resnet = jax_resnet["params"]
    return {
        "resnet": {"params": resnet, "x": rng_x,
                   "jax_layers": {n: (x, stride, padding, groups) for n, (
                       x, _, stride, padding, groups)
                       in jax_resnet["layers"].items()}},
        "zoo": [("mobilenet_v2", 32, 4), ("efficientnet_b0", 32, 4),
                ("alexnet", 224, 2)],
        "eval": {"params": resnet, "batches": _eval_batches(),
                 **{k: EVAL[k] for k in ("batch_size", "n_synth",
                                         "calib_pct")}},
        "lm": {"transformer": _np_tree(tfm), "gru": _np_tree(gru),
               "tokens": rng.integers(0, vocab, (T, B)).astype(np.int32),
               "targets": rng.integers(0, vocab, (T * B,)).astype(np.int32),
               "gru_hidden": (rng.normal(size=(2, B, 16)) * 0.5).astype(F32),
               "greedy_steps": GREEDY_STEPS, "cache_len": CACHE_LEN},
    }


@pytest.fixture(scope="module")
def world2(inputs):
    return launch.run(W.cnn_world2, 2, args=(inputs,), timeout=300)


@pytest.fixture(scope="module")
def world4(inputs):
    return launch.run(W.cnn_world4, 4, args=({"resnet": inputs["resnet"]},),
                      timeout=300)


# ------------------------------------------------------- tensor-parallel


def _hold_tp(got: dict, what: str) -> None:
    """Each converted conv within CONV_RTOL of the unsharded conv on the
    same input; the logits within LOGIT_RTOL of max |logit| of the
    unsharded forward; the recording pass the entry point's."""
    assert got["recorded_equal"], what
    assert got["conv_errs"], what
    worst = max(got["conv_errs"].items(), key=lambda kv: kv[1])
    assert worst[1] <= CONV_RTOL, (what, worst)
    ref = got["unsharded"]
    assert got["logits"].shape == ref.shape
    assert np.isfinite(got["logits"]).all()
    err = np.abs(got["logits"] - ref).max() / np.abs(ref).max()
    assert err <= LOGIT_RTOL, (what, err)


@pytest.mark.parametrize("world", [2, 4], ids=["mesh1x2", "mesh2x2"])
def test_tp_resnet18_matches_unsharded(world2, world4, world):
    """Conv kernels and the fc over 'model' (and the batch over 'data' on
    (2, 2)) against the port's unsharded forward: each conv on the same
    input, the logits."""
    got = (world2 if world == 2 else world4)["tp"]
    _hold_tp(got, f"resnet18 world {world}")
    assert len(got["conv_errs"]) == 19
    whole = got["w_whole"]
    assert got["w_shard"] == whole[:3] + (whole[3] // 2,)


@pytest.mark.parametrize("world", [2, 4], ids=["mesh1x2", "mesh2x2"])
def test_tp_resnet18_matches_jax_unsharded(world2, world4, jax_resnet,
                                           world):
    """Against the JAX package's unsharded forward on the JAX test's
    inputs: each TP conv fed the JAX forward's own input (the shard's
    reveal, product and gather) within the JAX test's rtol/atol 2e-3, and
    1e-5 of max |y|; the logits end to end within 2e-2 of max |logit|.
    End to end the two packages' float32 sums in another order put one
    quantized input across a rounding boundary at layer1.1.conv1 (scales
    0.05), which spreads to 4,389 of layer4.0.conv1's 32,768: 1.3e-2 of
    max |logit| (0.0366 of 2.81), the port's unsharded forward as far as
    its TP one."""
    got = (world2 if world == 2 else world4)["tp"]
    assert sorted(got["jax_layers"]) == sorted(jax_resnet["layers"])
    for name, y in got["jax_layers"].items():
        want = jax_resnet["layers"][name][1]
        np.testing.assert_allclose(y, want, rtol=2e-3, atol=2e-3,
                                   err_msg=name)
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=CONV_RTOL * np.abs(want).max(),
                                   err_msg=name)
    want = jax_resnet["logits"]
    np.testing.assert_allclose(got["logits"], want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


ZOO = [("mobilenet_v2", 2), ("efficientnet_b0", 2), ("alexnet", 2),
       ("mobilenet_v2", 4)]


@pytest.mark.parametrize("arch,world", ZOO,
                         ids=[f"{a}-world{w}" for a, w in ZOO])
def test_tp_zoo_matches_unsharded(world2, world4, arch, world):
    """The other archs over 'model': depthwise convs take their ranks'
    groups, squeeze-excite and classifier biases their slices."""
    got = (world2 if world == 2 else world4)["zoo"][arch]
    _hold_tp(got, f"{arch} world {world}")
    if arch == "mobilenet_v2":
        assert got["grouped"]  # the depthwise convs ran sharded


def test_tp_refuses_widths_that_do_not_divide(world4):
    """EfficientNet-b0's squeeze-excite reduce convs are 6 and 10 wide:
    four 'model' ranks refuse them by name; MobileNet-v2 divides."""
    msg = world4["refusal"]["efficientnet_b0"]
    assert msg.startswith("_blocks.2._se_reduce/w: dimension 3")
    assert "does not divide over the 4 ranks of 'model'" in msg
    assert world4["refusal"]["mobilenet_v2"] == ""


# -------------------------------------------------------- data-parallel


@pytest.fixture(scope="module")
def jax_eval_columns(inputs):
    """The JAX package's eval_setting (its own device layout) on the same
    batches and parameters."""
    batches = inputs["eval"]["batches"]
    orig = jcnn._batches
    jcnn._batches = lambda *args: iter(batches)
    try:
        params = jax.tree.map(jnp.asarray, inputs["eval"]["params"])
        return jcnn.eval_setting(
            jresnet, params, 9, 8, 12, 9, 3, arch="resnet18",
            **{k: EVAL[k] for k in ("batch_size", "n_synth", "calib_pct")})
    finally:
        jcnn._batches = orig


def test_dp_eval_columns_match_jax(world2, jax_eval_columns):
    """acc, tmacs, avg_terms and params of the (2, 1) run equal the JAX
    package's and the one-rank port run's."""
    got = world2["eval"]
    assert got["mesh"] == got["one_rank"]
    acc, tmacs, avg_terms, n_params = jax_eval_columns
    assert got["mesh"][0] == acc
    assert got["mesh"][1] == float(tmacs)
    assert got["mesh"][2] == avg_terms
    assert got["mesh"][3] == n_params


def test_dp_eval_histograms_bit_for_bit(world2):
    """Every layer's calibration histogram and scale on two 'data' ranks
    equal the one-rank run's bit for bit: split batches' int64 counts
    summed over 'data', the replicated tail counted once."""
    mesh, one = (world2["eval"][k] for k in ("mesh_states",
                                              "one_rank_states"))
    assert sorted(mesh) == sorted(one) and len(mesh) == 19
    for name in mesh:
        np.testing.assert_array_equal(mesh[name][0], one[name][0],
                                      err_msg=name)
        assert mesh[name][1] == one[name][1], name
        assert mesh[name][0].sum() > 0, name


# ----------------------------------------------------------- LM training


@pytest.fixture(scope="module")
def jax_train(inputs):
    """One Transformer and one GRU chunk of the JAX trainer at dropout 0,
    the tokens and hidden state sharded over 'data' of a (2, 1) mesh."""
    lm = inputs["lm"]
    mesh = _jmesh(2, 1)
    toks = j_shard_batch(jnp.asarray(lm["tokens"]), mesh, axis=1)
    targets = jnp.asarray(lm["targets"])
    tparams, tloss = _train_step_transformer(
        jax.tree.map(jnp.asarray, lm["transformer"]), toks, targets,
        jax.random.PRNGKey(4), jnp.float32(5.0), jnp.float32(0.25),
        dropout=0.0)
    hidden = jax.device_put(
        jnp.asarray(lm["gru_hidden"]),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "data", None)))
    gparams, gloss, ghidden = _train_step(
        jax.tree.map(jnp.asarray, lm["gru"]), toks, targets, hidden,
        jax.random.PRNGKey(4), jnp.float32(5.0), jnp.float32(0.25),
        dropout=0.0, cell="GRU")
    return {"transformer_loss": float(tloss),
            "transformer": W._flat(_np_tree(tparams)),
            "gru_loss": float(gloss), "gru_hidden": np.asarray(ghidden),
            "gru": W._flat(_np_tree(gparams))}


@pytest.mark.parametrize("family", ["transformer", "gru"])
def test_dp_train_step_matches_jax(world2, jax_train, family):
    """The batch over 'data', targets taken per column, gradients averaged
    before the clip: loss rtol 1e-5 and parameters rtol 1e-4 against the
    JAX step and the port's one-rank step."""
    got = world2["train"]
    for ref in (jax_train, got["one_rank"]):
        np.testing.assert_allclose(got["mesh"][f"{family}_loss"],
                                   ref[f"{family}_loss"], rtol=1e-5)
        params = got["mesh"][family]
        assert sorted(params) == sorted(ref[family])
        for key, value in params.items():
            np.testing.assert_allclose(value, ref[family][key], rtol=1e-4,
                                       atol=1e-7, err_msg=key)
    if family == "gru":
        for ref in (jax_train, got["one_rank"]):
            np.testing.assert_allclose(got["mesh"]["gru_hidden"],
                                       ref["gru_hidden"], rtol=1e-5,
                                       atol=1e-6)


def test_dp_dropout_masks_differ_by_data_rank(world2):
    """At dropout 0.2 each 'data' rank draws from its own generator; the
    loss, averaged over 'data', is the same on both."""
    d = world2["train"]["dropout"]
    assert not np.array_equal(d["draws"][0], d["draws"][1])
    assert d["losses"][0] == d["losses"][1] == d["loss"]
    assert np.isfinite(d["loss"])


# ------------------------------------------------------------ LM serving


@pytest.fixture(scope="module")
def jax_serving(inputs):
    """The dry run's GRU eval chunk, one-scan greedy sampler and KV-cache
    decode (``__graft_entry__.py``), on one JAX device, returning every
    step's tokens."""
    lm = inputs["lm"]
    gq, gcfg, gqs = jlm.convert(jax.tree.map(jnp.asarray, lm["gru"]), 8, 8,
                                24, 8, 8, cell="GRU")
    gqs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in gqs.items()}
    gfwd = jlm.make_quantized_apply(gcfg, track=False)
    hidden = jnp.zeros(lm["gru_hidden"].shape, jnp.float32)
    logp, gh, _ = gfwd(gq, gqs, jnp.asarray(lm["tokens"]), hidden)
    tok = jnp.zeros((1, B), jnp.int32)
    h, greedy = hidden, []
    for _ in range(GREEDY_STEPS):
        lp, h, _ = gfwd(gq, gqs, tok, h)
        tok = jnp.argmax(lp.reshape(1, B, -1)[-1], -1)[None, :].astype(
            jnp.int32)
        greedy.append(np.asarray(tok[0]))
    qp, qcfg, qs = jtl.convert(jax.tree.map(jnp.asarray, lm["transformer"]),
                               8, 8, 24, 8, 8)
    qs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in qs.items()}
    qp = jtl.pack(qp, qcfg, fmt="u8s")
    cache = jtl.decode_init_cache(CACHE_LEN, B, 16, 2, 1)
    tok, decode = jnp.zeros((1, B), jnp.int32), []
    for n in range(CACHE_LEN - 1):
        lp, cache = jtl.decode_step(qp, tok, n, cache, nhead=2, qcfg=qcfg,
                                    qstate=qs)
        tok = jnp.argmax(lp, -1)[None, :].astype(jnp.int32)
        decode.append(np.asarray(tok[0]))
    return {"gru_logp": np.asarray(logp).reshape(T, B, -1),
            "gru_hidden": np.asarray(gh), "greedy": np.stack(greedy),
            "decode": np.stack(decode)}


@pytest.mark.parametrize("row", ["gru_logp", "gru_hidden", "greedy",
                                 "decode"])
def test_serving_rows_over_data(world2, jax_serving, row):
    """Each rank serves its B/2 columns with no collective; gathered in
    rank order they are the one-rank call (tokens equal), and the JAX
    package's rows."""
    got = world2["serving"]
    assert got["local_batch"] == B // 2
    mesh, one = got["mesh"][row], got["one_rank"][row]
    if row in ("greedy", "decode"):
        np.testing.assert_array_equal(mesh, one)
        np.testing.assert_array_equal(mesh, jax_serving[row])
    else:
        np.testing.assert_allclose(mesh, one, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mesh, jax_serving[row], rtol=1e-4,
                                   atol=1e-4)
