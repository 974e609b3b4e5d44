"""The port's portable serving artifact (``platforms=("cpu", "cuda")``)
against the JAX package's multi-platform one (``platforms=("cpu",
"tpu")``), as ``tests/test_export.py::test_multi_platform_export``.

The u8s LSTM step and the Transformer's u8s KV-cache decode step are
traced on the CPU with the platforms recorded in the file: loaded on the
CPU they give the direct step's log-probs and carry within 1e-6 and the
JAX package's multi-platform artifact's within 1e-4.  Their graphs call
the operators the card's route calls (``tq::term_matmul`` for every
converted product, ``tq::tr_quantize`` for every quantized activation)
and hold no inline reveal; moved to ``"meta"`` (the CPU's stand-in for
the card) no constant and no node's ``device`` stays on the CPU.
"""

import collections

import jax
import jax.numpy as jnp
import pytest
import torch

from tq_tpu.models import lstm_lm as jlm
from tq_tpu.models import transformer_lm as jtf
from tq_tpu.utils import export as jexport
from tq_tpu_torch.evals import generate as tgen
from tq_tpu_torch.models import lstm_lm as tlm
from tq_tpu_torch.models import transformer_lm as ttf
from tq_tpu_torch.utils import export as texport
from tq_tpu_torch.utils.params import params_from_jax

from test_torch_port_export import _close, _jax, _lstm_serving, _with_sf
from test_torch_port_lstm import _np_params as _lstm_np

PLATFORMS = ("cpu", "cuda")
V, E, NH, NL, L = 64, 16, 2, 2, 8  # the Transformer: vocab, width, ...
# The element-wise reveal's arithmetic, which the card's route keeps
# inside tq::tr_quantize / tq::term_matmul.
REVEAL_OPS = ("aten.floor.default", "aten.clamp.default", "aten.abs.default",
              "aten.bitwise_and.Tensor", "aten.__lshift__.Scalar",
              "aten.round.default")


def _lstm_case():
    """(JAX, port) serving models of a 2-layer u8s LSTM (vocab 64, width
    16; the first layer quantized, as the recipe converts)."""
    return _lstm_serving(_lstm_np(V, E, E, 2, "LSTM"), "LSTM", "u8s")


def _tfm_case():
    p = jax.device_get(jtf.init(jax.random.PRNGKey(2), vocab=V, emsize=E,
                                nhead=NH, nhid=E, nlayers=NL))
    jqp, jqc, jqs = jtf.convert(_jax(p), 8, 8, 24, 8, 8)
    jqp = jtf.pack(jqp, jqc, fmt="u8s")
    tqp, tqc, tqs = ttf.convert(params_from_jax(p, "cpu"), 8, 8, 24, 8, 8)
    tqp = ttf.pack(tqp, tqc, fmt="u8s")
    return ((jqp, jqc, _with_sf(jqs, 0.05, jnp.float32)),
            (tqp, tqc, _with_sf(tqs, 0.05, torch.tensor)))


@pytest.fixture(scope="module")
def lstm():
    (jqp, jqc, jqs), (tqp, tqc, tqs) = _lstm_case()
    return dict(
        j=(jqp, jqc, jqs), t=(tqp, tqc, tqs),
        data=texport.export_lm_step(tqp, tqc, tqs, platforms=PLATFORMS),
        jdata=jexport.export_lm_step(jqp, jqc, jqs,
                                     platforms=("cpu", "tpu")))


@pytest.fixture(scope="module")
def tfm():
    (jqp, jqc, jqs), (tqp, tqc, tqs) = _tfm_case()

    def jstep(tok, pos, cache):
        return jtf.decode_step(jqp, tok, pos, cache, nhead=NH, qcfg=jqc,
                               qstate=jqs)

    jdata = jexport.export_serving(
        jstep, (jnp.zeros((1, 1), jnp.int32), jnp.int32(0),
                jtf.decode_init_cache(L, 1, E, NH, NL)),
        platforms=("cpu", "tpu"))
    return dict(j=(jqp, jqc, jqs), t=(tqp, tqc, tqs),
                data=tgen.export_transformer_step(tqp, tqc, tqs, L,
                                                  nhead=NH,
                                                  platforms=PLATFORMS),
                jdata=jdata)


def test_lstm_step_on_the_cpu_matches_direct_and_jax(lstm):
    """The portable LSTM step: both platforms recorded, loaded on the CPU
    the direct step within 1e-6 and the JAX package's multi-platform
    artifact within 1e-4, token after token."""
    tqp, tqc, tqs = lstm["t"]
    assert texport.serving_platforms(lstm["data"]) == PLATFORMS
    jexp = jax.export.deserialize(lstm["jdata"])
    assert set(jexp.platforms) == {"cpu", "tpu"}
    step = texport.load_serving(lstm["data"], device="cpu")
    fwd = tlm.make_quantized_apply(tqc, track=False)
    th = tlm.init_hidden(1, nhid=E, nlayers=2)
    jh = jlm.init_hidden(1, nhid=E, nlayers=2)
    for t in (3, 17, V - 1, 0):
        tok = torch.tensor([[t]])
        logp_d, hid_d, _ = fwd(tqp, tqs, tok, th)
        logp_e, hid_e = step(tok, th)
        logp_j, jh = jexp.call(jnp.asarray([[t]], jnp.int32), jh)
        _close(logp_e, logp_d, 1e-6)
        for a, b in zip(jax.tree.leaves(hid_e), jax.tree.leaves(hid_d)):
            _close(a, b, 1e-6)
        _close(logp_e, logp_j, 1e-4)
        for a, b in zip(jax.tree.leaves(hid_e), jax.tree.leaves(jh)):
            _close(a, b, 1e-4)
        th = hid_e


def test_transformer_step_on_the_cpu_matches_direct_and_jax(tfm):
    """The portable KV-cache decode step, over the positions of the
    cache: the direct step within 1e-6, the JAX package's multi-platform
    artifact within 1e-4 (log-probs and cache)."""
    tqp, tqc, tqs = tfm["t"]
    assert texport.serving_platforms(tfm["data"]) == PLATFORMS
    jexp = jax.export.deserialize(tfm["jdata"])
    assert set(jexp.platforms) == {"cpu", "tpu"}
    loaded = texport.load_serving(tfm["data"], device="cpu")
    tc_d = tc_e = ttf.decode_init_cache(L, 1, E, NH, NL)
    jc = jtf.decode_init_cache(L, 1, E, NH, NL)
    for pos, t in enumerate([7, 3, 60, 0, 9, 9, 41, 2]):
        tok = torch.tensor([[t]])
        logp_d, tc_d = ttf.decode_step(tqp, tok, pos, tc_d, nhead=NH,
                                       qcfg=tqc, qstate=tqs)
        logp_e, tc_e = loaded(tok, torch.tensor(pos), tc_e)
        logp_j, jc = jexp.call(jnp.asarray([[t]], jnp.int32), jnp.int32(pos),
                               jc)
        _close(logp_e, logp_d, 1e-6)
        _close(logp_e, logp_j, 1e-4)
        for leaf in ("k", "v"):
            _close(tc_e[leaf], tc_d[leaf], 1e-6)
            _close(tc_e[leaf], jc[leaf], 1e-4)


def _targets(data) -> collections.Counter:
    program, _ = texport._load(data)
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def test_graphs_call_the_operators(lstm, tfm):
    """Traced on the CPU, each step is the card's graph: a
    ``tq::term_matmul`` for every converted product (the LSTM's quantized
    layer's two and its decoder; the Transformer's out_proj, linear1,
    linear2 of each layer and its decoder), a ``tq::tr_quantize`` for each
    of the LSTM's quantized activations (embedding, h, c), no inline
    reveal, and plain products only where the card runs them too (the
    LSTM's float32 second layer, the Transformer's in_proj)."""
    tqp = lstm["t"][0]
    quantized = sum("w_ih_sf" in layer for layer in tqp["rnn"])
    assert quantized == 1
    got = _targets(lstm["data"])
    assert got["tq.term_matmul.default"] == 2 * quantized + 1
    assert got["tq.tr_quantize.default"] == 3 * quantized
    assert got["aten.matmul.default"] == 2 * (len(tqp["rnn"]) - quantized)
    assert not any(got[op] for op in REVEAL_OPS), got
    # Float32 fake-quant weights (--pack none) and a quantized decoder
    # input: the card fuses the decoder's quantizer into term_matmul's f32
    # mode; the recurrent products stay float32 products on the quantized
    # activations.
    tqp, tqc, tqs = tlm.convert(
        params_from_jax(_lstm_np(V, E, E, 2, "LSTM"), "cpu"), 8, 8, 24, 8, 8,
        quantize_decoder_input=True)
    got = _targets(texport.export_lm_step(
        tqp, tqc, _with_sf(tqs, 0.05, torch.tensor), platforms=PLATFORMS))
    assert got["tq.term_matmul.default"] == 1
    assert got["tq.tr_quantize.default"] == 3 * quantized
    assert got["aten.matmul.default"] == 2 * len(tqp["rnn"])
    assert not any(got[op] for op in REVEAL_OPS), got

    _, tqc, _ = tfm["t"]
    got = _targets(tfm["data"])
    assert got["tq.term_matmul.default"] == len(tqc) == 3 * NL + 1
    assert got["tq.tr_quantize.default"] == 0  # raw inputs (the reference)
    assert got["aten.matmul.default"] == NL  # in_proj, float32 on the card
    assert not any(got[op] for op in REVEAL_OPS), got


def _on_cpu(program) -> list:
    """What of ``program`` still names the CPU: constants, state, and
    nodes with a CPU ``device`` argument."""
    left = [k for k, t in {**program.state_dict, **program.constants}.items()
            if t.device.type == "cpu"]
    for n in program.graph.nodes:
        for v in (*n.args, *n.kwargs.values()):
            if (isinstance(v, (str, torch.device)) and str(v) == "cpu"
                    or isinstance(v, torch.device) and v.type == "cpu"):
                left.append(n.name)
    return left


@pytest.mark.parametrize("which", ["lstm", "tfm"])
def test_move_leaves_nothing_on_the_cpu(which, lstm, tfm):
    """``move_to_device_pass``, which ``load_serving`` applies on the
    card, to "meta": no constant and no node's device left on the CPU, and
    the moved program runs there (the operators' fake versions) with the
    step's output shapes."""
    from torch.export.passes import move_to_device_pass

    case = lstm if which == "lstm" else tfm
    program, platforms = texport._load(case["data"])
    assert platforms == PLATFORMS and _on_cpu(program)
    moved = move_to_device_pass(program, "meta")
    assert _on_cpu(moved) == []
    if which == "lstm":
        hidden = tuple(torch.zeros(2, 1, E, device="meta") for _ in range(2))
        logp, hidden = moved.module()(
            torch.zeros((1, 1), dtype=torch.int64, device="meta"), hidden)
    else:
        cache = ttf.decode_init_cache(L, 1, E, NH, NL, device="meta")
        logp, cache = moved.module()(
            torch.zeros((1, 1), dtype=torch.int64, device="meta"),
            torch.zeros((), dtype=torch.int64, device="meta"), cache)
        assert cache["k"].device.type == "meta"
    assert logp.device.type == "meta" and tuple(logp.shape) == (1, V)


def test_refusals(lstm, monkeypatch):
    """A closure off the CPU (meta stands in for a CUDA tensor here; the
    card's test is in test_torch_port_cuda.py) is refused with platforms
    given, as a device not among the platforms is, and "cuda" without a
    card raises (the default device of a portable artifact).  A
    single-device artifact keeps its one device."""
    w = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="traced from CPU tensors"):
        texport.export_serving(lambda x: x * w, (torch.zeros(4),),
                               platforms=PLATFORMS)
    with pytest.raises(ValueError, match="traced from CPU tensors"):
        texport.export_serving(lambda x: x.to("meta") * w,
                               (torch.zeros(4),), platforms=PLATFORMS)
    cpu_only = texport.export_serving(lambda x: x * 2, (torch.zeros(4),),
                                      platforms=("cpu",))
    assert texport.serving_platforms(cpu_only) == ("cpu",)
    torch.testing.assert_close(texport.load_serving(cpu_only)(torch.ones(4)),
                               torch.full((4,), 2.0))
    with pytest.raises(ValueError, match="serves"):
        texport.load_serving(cpu_only, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_serving(lstm["data"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_serving(lstm["data"], device="cuda")
    single = texport.export_serving(lambda x: x + 1, (torch.zeros(2),))
    assert texport.serving_platforms(single) == ("cpu",)
    with pytest.raises(ValueError, match="platforms="):
        texport.load_serving(single, device="cpu")


def test_generate_cli_export_platforms(tmp_path, monkeypatch):
    """``--export-platforms cpu,cuda`` through the CLI (the LSTM and the
    Transformer): the artifact records both devices and loads on the
    CPU."""
    from test_torch_port_export import _chip_smoke, _lstm_ckpt

    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    art = tmp_path / "step.pt2"
    tgen.main(["--checkpoint", str(_lstm_ckpt(tmp_path)), "--words", "3",
               "--tr", "8", "8", "24", "8", "8", "--pack", "u8s",
               "--export", str(art), "--export-platforms", "cpu,cuda",
               "--outf", str(tmp_path / "out.txt"), "--device", "cpu"])
    assert texport.serving_platforms(art) == PLATFORMS
    logp, _ = texport.load_serving(art, device="cpu")(
        torch.zeros((1, 1), dtype=torch.int64),
        tlm.init_hidden(1, nhid=16, nlayers=1))
    assert logp.shape == (1, 33278)

    ck = tmp_path / "tf.npz"
    _chip_smoke().transformer_checkpoint(ck, vocab=33278, emsize=8, nhid=12,
                                         nlayers=1)
    art = tmp_path / "tf.pt2"
    tgen.main(["--model", "Transformer", "--checkpoint", str(ck), "--words",
               "3", "--tr", "8", "8", "24", "8", "8", "--pack", "u8s",
               "--export", str(art), "--export-platforms", "cuda,cpu",
               "--outf", str(tmp_path / "tf.txt"), "--device", "cpu"])
    assert texport.serving_platforms(art) == ("cuda", "cpu")
    logp, _ = texport.load_serving(art, device="cpu")(
        torch.zeros((1, 1), dtype=torch.int64), torch.tensor(0),
        ttf.decode_init_cache(4, 1, 8, 2, 1))
    assert logp.shape == (1, 33278)
