"""The LSTM LM slice of the port against the JAX package.

The same numpy weights (vocab <= 50, hidden 16, two layers; and the
committed ``pretrained/lstm.npz``) go through both packages on the CPU:
packing, each ``_proj`` weight format, ``tr_lstm_apply`` for every cell,
the packed forward, one sweep setting, TR serving's teacher-forced
log-probs, the data, checkpoints, and the entry points' device default.

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_lstm --expected``, it
prints the JAX package's sweep results at full width on
``chip_smoke.lstm_checkpoint``'s weights (a few minutes on 8 CPU cores),
the numbers ``chip_smoke.EXPECTED_LSTM_SWEEPS`` pins.
"""

import importlib
import importlib.util
import inspect
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.data import synthetic as jsyn
from tq_tpu.data import wikitext as jwiki
from tq_tpu.evals import lstm as jeval
from tq_tpu.layers.common import TRParams as JTRParams
from tq_tpu.models import lstm_lm as jlm
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu_torch.data import synthetic as tsyn
from tq_tpu_torch.data import wikitext as twiki
from tq_tpu_torch.evals import generate as tgen
from tq_tpu_torch.evals import lstm as teval
from tq_tpu_torch.kernels import term_matmul as ttm
from tq_tpu_torch.layers import linear as tlin
from tq_tpu_torch.layers import lstm as tlstm
from tq_tpu_torch.layers.common import TRParams as TTRParams
from tq_tpu_torch.models import lstm_lm as tlm
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.params import params_from_jax

jlin = importlib.import_module("tq_tpu.layers.linear")
jlstm = importlib.import_module("tq_tpu.layers.lstm")
jtm = importlib.import_module("tq_tpu.kernels.term_matmul")

ROOT = Path(__file__).resolve().parent.parent
VOCAB, H = 40, 16

# The sweeps chip_smoke.py runs: the README lstm-quant sweep and one TR
# setting that runs the grouped kernel.
LSTM_SWEEPS = {
    "lstm-quant": dict(wb=[5, 6, 7, 8, 9], wt=[5, 6, 7, 8, 9], db=[8] * 5,
                       dt=[8] * 5, gs=[1] * 5),
    "lstm-tr": dict(wb=[8], wt=[24], db=[8], dt=[8], gs=[8]),
}

# (name, (wb, gs, wt, db, dt), pack, quantize_decoder_input): the serving
# configurations chip_smoke.py runs, and the term_matmul variant each
# sends the decoder through.
SERVING = [
    ("u8s", (8, 8, 24, 8, 8), "u8s", False, "f32_raw_packed8"),
    ("int16", (8, 8, 24, 8, 8), "int", False, "f32_raw_int16"),
    ("int8", (7, 8, 12, 7, 3), "int", False, "f32_raw_int8"),
    ("fixed-bf16-int16", (8, 8, 24, 8, 3), "int", True, "bf16_int16"),
    ("fixed-bf16-u8s", (8, 8, 24, 8, 3), "u8s", True, "bf16_packed8"),
    ("fixed-int8", (7, 8, 12, 7, 3), "int", True, "int8_int8"),
]


def _np_params(vocab=VOCAB, emsize=H, nhid=H, nlayers=2, cell="LSTM",
               seed=0):
    """lstm_lm.init's distributions, made with numpy."""
    rng = np.random.default_rng(seed)
    G = tlstm.GATE_MULT[cell]
    k = 1.0 / np.sqrt(nhid)

    def u(shape, b):
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    return {"encoder": {"w": u((vocab, emsize), 0.1)},
            "rnn": [{"w_ih": u((emsize if i == 0 else nhid, G * nhid), k),
                     "w_hh": u((nhid, G * nhid), k),
                     "b_ih": u((G * nhid,), k), "b_hh": u((G * nhid,), k)}
                    for i in range(nlayers)],
            "decoder": {"b": np.zeros(vocab, np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=1e-4, atol=1e-4):
    """tests/test_lstm_lm.py's tolerance for the packed forward."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _assert_tree_equal(port_tree, jax_tree):
    """Leaf by leaf, bit for bit, dtype included."""
    a = tckpt.flatten_tree(port_tree)
    b = jckpt.flatten_tree(jax.device_get(jax_tree))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def params_np():
    return _np_params()


@pytest.fixture(scope="module")
def stream():
    """Four bptt chunks and a tail at the eval batch of 10."""
    rng = np.random.default_rng(5)
    return jwiki.batchify(rng.integers(0, VOCAB, 1450).astype(np.int32), 10)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("vocab,length,seed", [(50, 300, 7), (33278, 2000, 9)])
def test_synthetic_tokens_equal(vocab, length, seed):
    a = jsyn.synthetic_tokens(vocab, length, seed)
    b = tsyn.synthetic_tokens(vocab, length, seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_batchify_and_corpora_equal(tmp_path, monkeypatch):
    data = np.arange(103, dtype=np.int32)
    for bsz in (1, 4, 10):
        np.testing.assert_array_equal(twiki.batchify(data, bsz),
                                      jwiki.batchify(data, bsz))
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    (jc, js), (tc, ts) = jwiki.load_corpus(), twiki.load_corpus()
    assert js == ts == "synthetic"
    assert len(tc.dictionary.idx2word) == len(jc.dictionary.idx2word) == 33278
    for split in ("train", "valid", "test"):
        assert getattr(tc, split).tobytes() == getattr(jc, split).tobytes()
    d = tmp_path / "wikitext-2"
    d.mkdir()
    (d / "train.txt").write_text("a b c\nb c\n")
    (d / "valid.txt").write_text("c a\n")
    (d / "test.txt").write_text("a d\n")
    (jc, js), (tc, ts) = jwiki.load_corpus(str(d)), twiki.load_corpus(str(d))
    assert js == ts == "real"
    assert tc.dictionary.idx2word == jc.dictionary.idx2word
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(tc, split), getattr(jc, split))


# ------------------------------------------------------------ the layers


# (id, (wb, gs, wt, db, dt), pack, quantize_input, x shape, use_fused):
# every packed route of tr_dense_apply.
DENSE_ROUTES = [
    ("wide-n-int16", (8, 1, 8, 8, 3), "int", True, (300, 16), None),
    ("fused-int8", (7, 1, 7, 7, 3), "int", True, (5, 16), None),
    ("fused-bf16-int16", (8, 1, 8, 8, 3), "int", True, (5, 16), None),
    ("fused-bf16-u8s", (8, 1, 8, 8, 3), "u8s", True, (5, 16), None),
    ("fused-f32-int16", (9, 1, 9, 9, 3), "int", True, (5, 16), None),
    ("raw-u8s", (8, 1, 8, 8, 8), "u8s", False, (5, 16), None),
    ("raw-int8", (7, 1, 7, 7, 3), "int", False, (5, 16), None),
    ("nd-u8s", (8, 1, 8, 8, 3), "u8s", True, (2, 3, 16), None),
    ("nd-int", (8, 1, 8, 8, 3), "int", False, (2, 3, 16), None),
    ("unfused-u8s", (8, 1, 8, 8, 3), "u8s", True, (5, 16), False),
]


@pytest.mark.parametrize("tr,pack,quantize_input,shape,use_fused",
                         [r[1:] for r in DENSE_ROUTES],
                         ids=[r[0] for r in DENSE_ROUTES])
def test_dense_packed_routes_match_jax(rng, tr, pack, quantize_input, shape,
                                       use_fused):
    params = {"w": (rng.normal(size=(16, 64)) * 0.2).astype(np.float32),
              "b": (rng.normal(size=64) * 0.1).astype(np.float32)}
    jtr = JTRParams(*tr, quantize_input=quantize_input)
    ttr = TTRParams(*tr, quantize_input=quantize_input)
    jqp = jlin.pack_dense_weights(jlin.tr_dense_convert(_jax(params), jtr),
                                  jtr, fmt=pack)
    tqp = tlin.pack_dense_weights(
        tlin.tr_dense_convert(params_from_jax(params, "cpu"), ttr), ttr,
        fmt=pack)
    _assert_tree_equal(tqp, jqp)
    x = rng.normal(size=shape).astype(np.float32)
    qs = {"hist": np.zeros(8192, np.float32), "sf": np.float32(0.05)}
    want, _ = jlin.tr_dense_apply(jqp, jtr, _jax(qs), jnp.asarray(x), False,
                                  use_fused=use_fused)
    got, _ = tlin.tr_dense_apply(tqp, ttr, params_from_jax(qs, "cpu"),
                                 torch.from_numpy(x), False,
                                 use_fused=use_fused)
    assert got.shape == want.shape
    _close(got, want, rtol=1e-5, atol=1e-5)


def _proj_weight(fmt, w):
    """(JAX weight, its w_sf) of float weights ``w`` in format ``fmt``."""
    w_sf = np.float32(np.abs(w).max() / 128)
    wq = (np.round(w / w_sf) * w_sf).astype(np.float32)
    if fmt == "f32":
        return jnp.asarray(w), None
    if fmt == "bf16":
        return jnp.asarray(w, jnp.bfloat16), None
    if fmt == "u8s":
        wp = jtm.pack_weight_u8s(jnp.asarray(wq), jnp.float32(w_sf), 8)
        return wp, wp.w_sf
    bits = 7 if fmt == "int8" else 8
    if fmt == "int8":
        w_sf = np.float32(np.abs(w).max() / 64)
        wq = (np.round(w / w_sf) * w_sf).astype(np.float32)
    return jtm.pack_weight_int(jnp.asarray(wq), jnp.float32(w_sf), bits)


@pytest.mark.parametrize("fmt", ["f32", "bf16", "int8", "int16", "u8s"])
@pytest.mark.parametrize("M,K", [(1, 16), (12, 21)])
def test_proj_every_weight_format(rng, fmt, M, K):
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, 4 * H)) * 0.2).astype(np.float32)
    jw, jsf = _proj_weight(fmt, w)
    want = jlstm._proj(jnp.asarray(x), jw, jsf)
    tw = params_from_jax(jax.device_get(jw), "cpu")
    if fmt == "bf16":  # the same rounding on both sides
        assert tw.dtype == torch.bfloat16
        assert torch.equal(tw, torch.from_numpy(w).to(torch.bfloat16))
    tsf = None if jsf is None else torch.tensor(np.asarray(jsf))
    got = tlstm._proj(torch.from_numpy(x), tw, tsf)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN_TANH", "RNN_RELU"])
def test_tr_lstm_apply_track_and_eval_every_cell(rng, cell):
    p = _np_params(cell=cell, seed=1)["rnn"]
    tr = (8, 8, 24, 8, 6)
    jq = jlstm.tr_lstm_convert(_jax(p), JTRParams(*tr))
    tq = tlstm.tr_lstm_convert(params_from_jax(p, "cpu"), TTRParams(*tr))
    _assert_tree_equal(tq, jq)  # conversion: bit for bit
    x = rng.normal(size=(6, 3, H)).astype(np.float32) * 0.5
    h = rng.normal(size=(2, 3, H)).astype(np.float32) * 0.3
    c = rng.normal(size=(2, 3, H)).astype(np.float32) * 0.3
    jhid = (jnp.asarray(h), jnp.asarray(c)) if cell == "LSTM" \
        else jnp.asarray(h)
    thid = (torch.from_numpy(h), torch.from_numpy(c)) if cell == "LSTM" \
        else torch.from_numpy(h)
    jqs = {"hist": jnp.zeros(8192, jnp.float32), "sf": jnp.float32(0.02)}
    tqs = {"hist": torch.zeros(8192), "sf": torch.tensor(0.02)}
    for track in (True, False):
        jout, jnew, jqs2 = jlstm.tr_lstm_apply(jq, JTRParams(*tr), jqs,
                                               jnp.asarray(x), jhid, track,
                                               cell)
        tout, tnew, tqs2 = tlstm.tr_lstm_apply(tq, TTRParams(*tr), tqs,
                                               torch.from_numpy(x), thid,
                                               track, cell)
        _close(tout, jout, rtol=1e-5, atol=1e-5)
        for a, b in zip(jax.tree.leaves(tuple(tnew) if cell == "LSTM"
                                        else tnew),
                        jax.tree.leaves(jnew)):
            _close(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tqs2["hist"].numpy(),
                                      np.asarray(jqs2["hist"]))


@pytest.mark.parametrize("fmt", ["u8s", "int"])
def test_pack_and_packed_forward_match_jax(params_np, fmt):
    """lstm_lm.pack byte for byte; the packed forward within
    tests/test_lstm_lm.py's rtol=1e-4, atol=1e-4."""
    jp, tp = _jax(params_np), params_from_jax(params_np, "cpu")
    jqp, jqc, _ = jlm.convert(jp, 8, 8, 24, 8, 8)
    tqp, tqc, _ = tlm.convert(tp, 8, 8, 24, 8, 8)
    _assert_tree_equal(tqp, jqp)
    jpk = jlm.pack(jqp, jqc, fmt=fmt, rnn=True)
    tpk = tlm.pack(tqp, tqc, fmt=fmt, rnn=True)
    expected = ttm.PackedWeight8 if fmt == "u8s" else torch.Tensor
    assert isinstance(tpk["rnn"][0]["w_ih"], expected)
    assert isinstance(tpk["decoder"]["w"], expected)
    assert tpk["rnn"][1]["w_ih"].dtype == torch.float32
    _assert_tree_equal(tpk, jpk)
    toks = np.random.default_rng(1).integers(0, VOCAB, (5, 3)).astype(np.int32)
    jqs = {k: {"hist": jnp.zeros(8192), "sf": jnp.float32(0.05)}
           for k in ("rnn", "decoder")}
    tqs = {k: {"hist": torch.zeros(8192), "sf": torch.tensor(0.05)}
           for k in ("rnn", "decoder")}
    jh = jlm.init_hidden(3, nhid=H, nlayers=2)
    th = tlm.init_hidden(3, nhid=H, nlayers=2)
    want, jhid, _ = jlm.make_quantized_apply(jqc, track=False)(
        jpk, jqs, jnp.asarray(toks), jh)
    got, thid, _ = tlm.make_quantized_apply(tqc, track=False)(
        tpk, tqs, torch.from_numpy(toks), th)
    _close(got, want)
    _close(thid[0], jhid[0])
    half = tlm.pack(tqp, tqc, fmt="u8s", rnn_unquantized_dtype=torch.bfloat16)
    assert half["rnn"][1]["w_ih"].dtype == torch.bfloat16
    assert tlm.pack(tqp, tqc, fmt="u8s", rnn=False)["rnn"][0]["w_ih"].dtype \
        == torch.float32


def test_pack_overflow_raises_like_jax(params_np):
    """A grid that ``bits`` understates: the same ValueError, raised from
    the model's one deferred fetch."""
    jqp, _, _ = jlm.convert(_jax(params_np), 8, 1, 8, 8, 8)
    tqp, _, _ = tlm.convert(params_from_jax(params_np, "cpu"), 8, 1, 8, 8, 8)
    lie = {"decoder": JTRParams(4, 1, 4, 8, 8), "rnn": JTRParams(4, 1, 4, 8, 8)}
    tlie = {"decoder": TTRParams(4, 1, 4, 8, 8),
            "rnn": TTRParams(4, 1, 4, 8, 8)}
    with pytest.raises(ValueError) as jerr:
        jlm.pack(jqp, lie, fmt="int", rnn=True)
    with pytest.raises(ValueError) as terr:
        tlm.pack(tqp, tlie, fmt="int", rnn=True)
    assert "overflows int8" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------- the sweep path


def test_evaluate_setting_matches_jax(params_np, stream):
    """tmacs and param_bits exact, ppl within rtol=1e-4 (a quantized
    activation can flip at a float32 rounding boundary)."""
    want = jeval.evaluate_setting(_jax(params_np), 8, 24, 8, 8, 8,
                                  stream=stream, vocab=VOCAB)
    got = teval.evaluate_setting(params_from_jax(params_np, "cpu"), 8, 24,
                                 8, 8, 8, stream=stream, vocab=VOCAB)
    assert got[1:] == want[1:]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_run_sweep_pretrained_checkpoint_matches_jax(tmp_path, monkeypatch):
    """pretrained/lstm.npz (64 wide, vocab 33278) on 400 synthetic test
    tokens, with resume from a partial file."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    ckpt = str(ROOT / "pretrained" / "lstm.npz")
    want = jeval.run_sweep([6], [6], [8], [8], [1], checkpoint=ckpt,
                           limit_tokens=400, verbose=False)
    out = tmp_path / "sweep.json"
    out.write_text(json.dumps({"ppls": [1.5], "tmacs": [1.0],
                               "param_bits": [2.0]}))
    got = teval.run_sweep([5, 6], [5, 6], [8, 8], [8, 8], [1, 1],
                          out_file=str(out), checkpoint=ckpt,
                          limit_tokens=400, verbose=False, device="cpu")
    assert got["ppls"][0] == 1.5
    assert got["tmacs"][1:] == want["tmacs"]
    assert got["param_bits"][1:] == want["param_bits"]
    np.testing.assert_allclose(got["ppls"][1:], want["ppls"], rtol=1e-4)
    assert json.loads(out.read_text()) == got


# ------------------------------------------------------- the serving path


@pytest.fixture(scope="module")
def jax_calibrated(params_np, stream):
    """(wb, gs, wt, db, dt), quantize_decoder_input -> the JAX package's
    generate_tr model before packing (convert, calibrate on two chunks),
    made once per module for each."""
    cache = {}

    def get(tr, qdi):
        if (tr, qdi) not in cache:
            wb, gs, wt, db, dt = tr
            jqp, jqc, jqs = jlm.convert(_jax(params_np), wb, gs, wt, db, dt,
                                        quantize_decoder_input=qdi)
            track = jlm.make_quantized_apply(jqc, track=True)
            hidden = jlm.init_hidden(stream.shape[1], nhid=H, nlayers=2)
            for i, (x, _) in enumerate(jeval._chunks(stream)):
                if i >= 2:
                    break
                _, hidden, jqs = track(jqp, jqs, jnp.asarray(x), hidden)
            cache[tr, qdi] = jqp, jqc, jlm.finalize(jqs, jqc)
        return cache[tr, qdi]

    return get


@pytest.mark.parametrize("name,tr,pack,qdi,variant", SERVING,
                         ids=[s[0] for s in SERVING])
def test_serving_teacher_forced_log_probs(params_np, stream, jax_calibrated,
                                          name, tr, pack, qdi, variant):
    """Calibrated scales equal, packs equal byte for byte, and per token
    the port's step on the JAX step's inputs gives its log-probs within
    rtol=1e-4, atol=1e-4; the decoder goes through the named variant."""
    jqp, jqc, jqs = jax_calibrated(tr, qdi)
    jqp = jlm.pack(jqp, jqc, fmt=pack)
    tqp, tqc, tqs = tgen.serving_model(params_from_jax(params_np, "cpu"), tr,
                                       pack, stream, calib_chunks=2,
                                       quantize_decoder_input=qdi)
    for q in ("rnn", "decoder"):
        assert float(tqs[q]["sf"]) == float(jqs[q]["sf"]), q
    _assert_tree_equal(tqp, jqp)
    dec = tqp["decoder"]
    assert ttm.variant(
        bf16=qdi and variant.startswith("bf16"),
        int8=variant == "int8_int8", w=dec["w"],
        quantize_x=qdi) == variant

    jfwd = jlm.make_quantized_apply(jqc, track=False)
    tfwd = tlm.make_quantized_apply(tqc, track=False)
    hidden = jlm.init_hidden(1, nhid=H, nlayers=2)
    for t in np.random.default_rng(2).integers(0, VOCAB, 8):
        tok = np.full((1, 1), t, np.int32)
        want, hidden_next, _ = jfwd(jqp, jqs, jnp.asarray(tok), hidden)
        got, _, _ = tfwd(tqp, tqs, torch.from_numpy(tok),
                         tuple(torch.from_numpy(np.array(h))
                               for h in hidden))
        _close(got, want)
        hidden = hidden_next


def test_generate_tr_samples_in_range(params_np, stream):
    toks = tgen.generate_tr(params_np, VOCAB, words=12, seed=3,
                            pack_fmt="u8s", calib_stream=stream,
                            calib_chunks=2, device="cpu")
    assert len(toks) == 12 and all(0 <= t < VOCAB for t in toks)
    again = tgen.generate_tr(params_np, VOCAB, words=12, seed=3,
                             pack_fmt="u8s", calib_stream=stream,
                             calib_chunks=2, device="cpu")
    assert toks == again  # the seeded generator
    plain = tgen.generate(params_np, VOCAB, words=6, seed=3, device="cpu")
    assert len(plain) == 6 and all(0 <= t < VOCAB for t in plain)
    with pytest.raises(ValueError, match="temperature"):
        tgen.generate(params_np, VOCAB, words=2, temperature=0.0,
                      device="cpu")


def test_sampler_draws_the_categorical_distribution():
    """Gumbel-max over logp / T samples softmax(logp / T)."""
    logp = torch.log_softmax(torch.tensor([[0.0, 1.0, 2.0, -1.0]]), -1)
    counts = np.zeros(4)
    hidden0 = torch.zeros(1)
    toks = tgen._sample_scan(lambda tok, h: (logp, h), hidden0, 4, 4000, 1.0,
                             0, "cpu")
    counts += np.bincount(toks, minlength=4)
    np.testing.assert_allclose(counts / counts.sum(),
                               torch.softmax(logp[0], -1).numpy(), atol=0.03)


# The batch serving step (bench.py::bench_generate's batch-64 sampler,
# examples/lm_serving.py's batch >= 8) at a small width: M = 16 rows in
# every product, above STREAM_MAX_M, so on the card the f32 mode's narrow
# variants take the mma kernel.  (pack, rnn_unquantized_dtype): the 9-bit
# pack (layer 0 and the decoder; layer 1 float32) and int16 with the
# unquantized layer bf16-stored.
BATCH_SERVING = [("u8s", None), ("int", "bfloat16")]


@pytest.mark.parametrize("pack,half", BATCH_SERVING,
                         ids=[p for p, _ in BATCH_SERVING])
def test_batch_serving_forward_matches_jax(pack, half):
    """vocab 256, 64/64, two layers, batch 16: four greedy steps, the JAX
    package's tokens and hidden state fed to both; per step the port's
    log-probs and hidden state within the packed forward's tolerance."""
    vocab, nhid, batch = 256, 64, 16
    params_np = _np_params(vocab=vocab, emsize=nhid, nhid=nhid)
    jqp, jqc, _ = jlm.convert(_jax(params_np), 8, 8, 24, 8, 8)
    tqp, tqc, _ = tlm.convert(params_from_jax(params_np, "cpu"), 8, 8, 24,
                              8, 8)
    jpk = jlm.pack(jqp, jqc, fmt=pack, rnn=True, rnn_unquantized_dtype=(
        getattr(jnp, half) if half else None))
    tpk = tlm.pack(tqp, tqc, fmt=pack, rnn=True, rnn_unquantized_dtype=(
        getattr(torch, half) if half else None))
    if half:  # the bf16-stored layer, bit for bit; the rest leaf by leaf
        for key in ("w_ih", "w_hh"):
            np.testing.assert_array_equal(
                tpk["rnn"][1][key].view(torch.int16).numpy(),
                np.asarray(jpk["rnn"][1][key]).view(np.int16))
        _assert_tree_equal({**tpk, "rnn": tpk["rnn"][:1]},
                           {**jpk, "rnn": jpk["rnn"][:1]})
    else:
        _assert_tree_equal(tpk, jpk)
    narrow = {"u8s": "packed8", "int": "int16"}[pack]
    formats = {ttm._weight_format(w) for w in (
        tpk["decoder"]["w"], tpk["rnn"][0]["w_ih"], tpk["rnn"][1]["w_hh"])}
    assert formats == ({narrow, "f32"} if half is None else {narrow, "bf16"})
    for fmt in formats - {"f32"}:  # the card's route at these shapes
        for N in (4 * nhid, vocab):
            assert ttm.plan(batch, N, nhid, fmt, "f32", 132).kernel == "mma"
    jqs = {k: {"hist": jnp.zeros(8192), "sf": jnp.float32(0.05)}
           for k in ("rnn", "decoder")}
    tqs = {k: {"hist": torch.zeros(8192), "sf": torch.tensor(0.05)}
           for k in ("rnn", "decoder")}
    jfwd = jlm.make_quantized_apply(jqc, track=False)
    tfwd = tlm.make_quantized_apply(tqc, track=False)
    tok = np.random.default_rng(6).integers(0, vocab, (1, batch)).astype(
        np.int32)
    hidden = jlm.init_hidden(batch, nhid=nhid, nlayers=2)
    for _ in range(4):
        want, hidden_next, _ = jfwd(jpk, jqs, jnp.asarray(tok), hidden)
        got, thid, _ = tfwd(tpk, tqs, torch.from_numpy(tok),
                            tuple(torch.from_numpy(np.array(h))
                                  for h in hidden))
        assert got.shape == (batch, vocab)
        _close(got, want)
        for a, b in zip(thid, hidden_next):
            _close(a, b)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[None, :]
        hidden = hidden_next


# --------------------------------------------------- checkpoints, params


def test_packed_checkpoint_round_trip_across_packages(tmp_path, params_np):
    jqp, jqc, _ = jlm.convert(_jax(params_np), 8, 8, 24, 8, 8)
    jpk = jlm.pack(jqp, jqc, fmt="u8s")
    jckpt.save_params(tmp_path / "jax.npz", jpk)
    back = tckpt.load_params(tmp_path / "jax.npz")
    assert isinstance(back["decoder"]["w"], ttm.PackedWeight8)
    tpk = params_from_jax(back, "cpu")
    assert isinstance(tpk["rnn"][0]["w_hh"], ttm.PackedWeight8)
    assert tpk["decoder"]["w"].lo.dtype == torch.int8
    _assert_tree_equal(tpk, jpk)
    tckpt.save_params(tmp_path / "port.npz", tpk)
    jback = jckpt.load_params(tmp_path / "port.npz")
    assert isinstance(jback["decoder"]["w"], jtm.PackedWeight8)
    _assert_tree_equal(tpk, jback)
    # params_from_jax carries a live JAX tree's PackedWeight8 too.
    _assert_tree_equal(params_from_jax(jax.device_get(jpk), "cpu"), jpk)


def test_unknown_namedtuple_in_checkpoint_raises():
    with pytest.raises(KeyError, match="unknown checkpointed namedtuple"):
        tckpt.unflatten_tree({"a/#nt": np.asarray("Other"),
                              "a/x": np.zeros(1)})


def test_init_and_apply_shapes():
    params = tlm.init(torch.Generator().manual_seed(0), vocab=30, emsize=8,
                      nhid=8, device="cpu")
    assert params["encoder"]["w"].shape == (30, 8)
    assert float(params["encoder"]["w"].abs().max()) <= 0.1
    assert params["rnn"][1]["w_hh"].shape == (8, 32)
    logp, (h, c) = tlm.apply(params, torch.zeros(5, 2, dtype=torch.int32),
                             tlm.init_hidden(2, nhid=8, device="cpu"))
    assert logp.shape == (10, 30) and h.shape == (2, 2, 8)
    torch.testing.assert_close(logp.exp().sum(-1), torch.ones(10))
    assert tlm.infer_cell(params) == "LSTM"


def test_fp32_apply_matches_jax(params_np):
    toks = np.random.default_rng(4).integers(0, VOCAB, (7, 2)).astype(np.int32)
    want, _ = jlm.apply(_jax(params_np), jnp.asarray(toks),
                        jlm.init_hidden(2, nhid=H, nlayers=2))
    got, _ = tlm.apply(params_from_jax(params_np, "cpu"),
                       torch.from_numpy(toks),
                       tlm.init_hidden(2, nhid=H, nlayers=2))
    _close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ entry points


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    for fn in (teval.run_sweep, tgen.generate, tgen.generate_tr):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(ROOT / "pretrained" / "lstm.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.run_sweep([8], [8], [8], [8], [1], checkpoint=ckpt,
                        verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--wb", "8", "--wt", "8", "--db", "8", "--dt", "8",
                    "--gs", "1", "--out-file", str(tmp_path / "o.json")])
    p = _np_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate(p, VOCAB, words=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate_tr(p, VOCAB, words=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--checkpoint", ckpt, "--words", "2",
                   "--outf", str(tmp_path / "g.txt")])


def test_unported_options_raise(tmp_path):
    """What still raises: an export platform the port does not serve
    ("tpu", the JAX package's; "cpu" and "cuda" are taken,
    test_torch_port_export_platforms.py)."""
    with pytest.raises(ValueError, match="unknown"):
        tgen.generate_tr(_np_params(), VOCAB, words=2, export_path="x",
                         export_platforms=["cpu", "tpu"], device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tgen.main(["--tr", "8", "8", "24", "8", "8", "--export",
                   str(tmp_path / "x"), "--export-platforms", "tpu",
                   "--device", "cpu"])
    assert not (tmp_path / "x").exists()
    # Torch checkpoints load now (utils/torch_import), as in the JAX package.
    p = _np_params()
    sd = {"encoder.weight": torch.from_numpy(p["encoder"]["w"]),
          "decoder.weight": torch.from_numpy(p["encoder"]["w"]),
          "decoder.bias": torch.from_numpy(p["decoder"]["b"])}
    for i, layer in enumerate(p["rnn"]):
        for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh")):
            sd[f"rnn.{theirs}_l{i}"] = torch.from_numpy(layer[ours].T.copy())
        for ours, theirs in (("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"rnn.{theirs}_l{i}"] = torch.from_numpy(layer[ours])
    torch.save(sd, tmp_path / "lstm.pt")
    got, meta = teval._load_checkpoint(tmp_path / "lstm.pt", VOCAB,
                                       with_meta=True)
    assert meta == {}
    _assert_tree_equal(params_from_jax(got, "cpu"),
                       jeval._load_checkpoint(tmp_path / "lstm.pt", VOCAB))
    _assert_tree_equal(params_from_jax(got, "cpu"), _jax(p))


def test_generate_main_writes_words_on_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    out = tmp_path / "g.txt"
    tgen.main(["--checkpoint", str(ROOT / "pretrained" / "lstm.npz"),
               "--words", "25", "--tr", "8", "8", "24", "8", "8",
               "--pack", "u8s", "--outf", str(out), "--device", "cpu"])
    words = out.read_text().split()
    assert len(words) == 25
    assert all(0 <= int(w) < 33278 for w in words)


# ------------------------------------------------- chip_smoke's constants


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_expected_lstm_sweeps_pinned():
    """chip_smoke runs LSTM_SWEEPS; its tmacs are the JAX package's
    counter's (pure shapes), its g=1 param_bits nelement * wb."""
    cs = _chip_smoke()
    assert [(n, e["settings"]) for n, e in cs.EXPECTED_LSTM_SWEEPS.items()] \
        == list(LSTM_SWEEPS.items())
    from tq_tpu.profilers import dense_term_macs

    for exp in cs.EXPECTED_LSTM_SWEEPS.values():
        s = exp["settings"]
        for i, (wb, wt, db, dt, gs) in enumerate(
                zip(s["wb"], s["wt"], s["db"], s["dt"], s["gs"])):
            tr = JTRParams(wb, gs, wt, db, dt)
            assert exp["tmacs"][i] == dense_term_macs(35 * 10 * 33278, 650,
                                                      tr)
            if gs == 1:
                assert exp["param_bits"][i] == 650 * 33278 * wb
    assert [c[:4] for c in cs.GEN_CONFIGS] == [s[:4] for s in SERVING]


def test_lstm_checkpoint_loads_in_both_packages(tmp_path):
    path = tmp_path / "small.npz"
    _chip_smoke().lstm_checkpoint(path, vocab=30, emsize=8, nhid=8)
    jp, tp = jckpt.load_params(path), tckpt.load_params(path)
    assert jp["rnn"][0]["w_hh"].shape == (8, 32)
    assert jp["decoder"]["b"].shape == (30,) and "w" not in jp["decoder"]
    _assert_tree_equal(params_from_jax(tp, "cpu"), jp)


def jax_expected_sweeps() -> dict:
    """The JAX package's run_sweep (on the CPU) of every LSTM_SWEEPS entry
    over chip_smoke.lstm_checkpoint's weights and the synthetic test
    stream."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "lstm_seeded.npz"
        _chip_smoke().lstm_checkpoint(ckpt)
        for name, s in LSTM_SWEEPS.items():
            res = jeval.run_sweep(s["wb"], s["wt"], s["db"], s["dt"],
                                  s["gs"], checkpoint=str(ckpt),
                                  verbose=True)
            out[name] = {"settings": s, **res}
    return out


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps(jax_expected_sweeps()))
