"""The port's serving export (``torch.export``) against the JAX package's
(StableHLO), as ``tests/test_export.py``.

Round trip: export -> save -> load -> call reproduces the direct step
within 1e-6 (the traced program may order float32 sums as the eager call
does not; on the CPU they come out equal), and the loaded step agrees with
the JAX package's direct step on the same numpy weights within 1e-4.  The
operators the programs call (``tq::term_matmul``, ``tq::tr_quantize``)
are held against the kernels' plain versions on the CPU in every variant
their checks admit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.models import lstm_lm as jlm
from tq_tpu.models import transformer_lm as jtf
from tq_tpu_torch.evals import generate as tgen
from tq_tpu_torch.kernels import term_matmul as ttm
from tq_tpu_torch.kernels import tr_quantize as ttq
from tq_tpu_torch.models import lstm_lm as tlm
from tq_tpu_torch.models import transformer_lm as ttf
from tq_tpu_torch.utils.export import (_Program, export_lm_step,
                                       export_serving, load_serving)
from tq_tpu_torch.utils.params import params_from_jax

from test_torch_port_lstm import _chip_smoke
from test_torch_port_lstm import _np_params as _lstm_np


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _with_sf(qs, sf, tensor):
    return {k: {**v, "sf": tensor(sf)} for k, v in qs.items()}


def _lstm_serving(p, cell, pack):
    """Both packages' converted (and packed) recurrent models, sf 0.05."""
    jqp, jqc, jqs = jlm.convert(_jax(p), 8, 8, 24, 8, 8, cell=cell)
    tqp, tqc, tqs = tlm.convert(params_from_jax(p, "cpu"), 8, 8, 24, 8, 8,
                                cell=cell)
    jqs = _with_sf(jqs, 0.05, jnp.float32)
    tqs = _with_sf(tqs, 0.05, torch.tensor)
    if pack:
        jqp, tqp = jlm.pack(jqp, jqc, fmt=pack), tlm.pack(tqp, tqc, fmt=pack)
    return (jqp, jqc, jqs), (tqp, tqc, tqs)


@pytest.mark.parametrize("vocab,nhid,nlayers,cell,pack", [
    (64, 16, 2, "LSTM", "u8s"), (32, 8, 1, "GRU", None)],
    ids=["lstm-u8s", "gru"])
def test_recurrent_step_roundtrip(tmp_path, vocab, nhid, nlayers, cell,
                                  pack):
    """The packed LSTM step (the u8s planes among the constants) and the
    GRU step (the cell family travels through qcfg): save, load, the same
    log-probs and hidden state as the direct step, and the JAX package's
    direct step within 1e-4."""
    p = _lstm_np(vocab, nhid, nhid, nlayers, cell)  # tied: emsize = nhid
    (jqp, jqc, jqs), (tqp, tqc, tqs) = _lstm_serving(p, cell, pack)
    path = tmp_path / "step.pt2"
    data = export_lm_step(tqp, tqc, tqs, path)
    assert path.read_bytes() == data
    step = load_serving(path)
    tfwd = tlm.make_quantized_apply(tqc, track=False)
    jfwd = jlm.make_quantized_apply(jqc, track=False)
    th = tlm.init_hidden(1, nhid=nhid, nlayers=nlayers, cell=cell)
    jh = jlm.init_hidden(1, nhid=nhid, nlayers=nlayers, cell=cell)
    for t in (3, 17, vocab - 1):
        tok = torch.tensor([[t]])
        logp_d, hid_d, _ = tfwd(tqp, tqs, tok, th)
        logp_e, hid_e = step(tok, th)
        logp_j, jh, _ = jfwd(jqp, jqs, jnp.asarray([[t]], jnp.int32), jh)
        _close(logp_e, logp_d, 1e-6)
        for a, b in zip(jax.tree.leaves(hid_e), jax.tree.leaves(hid_d)):
            _close(a, b, 1e-6)
        _close(logp_e, logp_j, 1e-4)
        th = hid_e


def test_transformer_decode_step_roundtrip(tmp_path):
    """The KV-cache decode step with packed linears among the constants:
    over several positions the loaded step gives the direct step's
    log-probs and cache, and the JAX package's within 1e-4."""
    V, E, NH, NL, L = 64, 16, 2, 1, 8
    p = jax.device_get(jtf.init(jax.random.PRNGKey(2), vocab=V, emsize=E,
                                nhead=NH, nhid=E, nlayers=NL))
    jqp, jqc, jqs = jtf.convert(_jax(p), 8, 8, 24, 8, 8)
    jqp = jtf.pack(jqp, jqc, fmt="u8s")
    jqs = _with_sf(jqs, 0.05, jnp.float32)
    tqp, tqc, tqs = ttf.convert(params_from_jax(p, "cpu"), 8, 8, 24, 8, 8)
    tqp = ttf.pack(tqp, tqc, fmt="u8s")
    tqs = _with_sf(tqs, 0.05, torch.tensor)
    data = tgen.export_transformer_step(tqp, tqc, tqs, L, tmp_path / "tf.pt2",
                                        nhead=NH)
    loaded = load_serving(data)
    tc_d = tc_e = ttf.decode_init_cache(L, 1, E, NH, NL)
    jc = jtf.decode_init_cache(L, 1, E, NH, NL)
    for pos, t in enumerate([7, 3, 60, 0, 9]):
        tok = torch.tensor([[t]])
        logp_d, tc_d = ttf.decode_step(tqp, tok, pos, tc_d, nhead=NH,
                                       qcfg=tqc, qstate=tqs)
        logp_e, tc_e = loaded(tok, torch.tensor(pos), tc_e)
        logp_j, jc = jtf.decode_step(jqp, jnp.asarray([[t]], jnp.int32), pos,
                                     jc, nhead=NH, qcfg=jqc, qstate=jqs)
        _close(logp_e, logp_d, 1e-6)
        for leaf in ("k", "v"):
            _close(tc_e[leaf], tc_d[leaf], 1e-6)
            _close(tc_e[leaf], jc[leaf], 1e-4)
        _close(logp_e, logp_j, 1e-4)


def test_the_program_calls_the_kernels_operator(monkeypatch):
    """The packed step's three products (layer 0's w_ih and w_hh, the
    decoder) are ``tq::term_matmul`` calls in the program; an eager call
    goes around the operator."""
    p = _lstm_np(32, 8, 8, 2)
    _, (tqp, tqc, tqs) = _lstm_serving(p, "LSTM", "u8s")
    fwd = tlm.make_quantized_apply(tqc, track=False)
    h0 = tlm.init_hidden(1, nhid=8, nlayers=2)
    ep = torch.export.export(
        _Program(lambda tok, h: fwd(tqp, tqs, tok, h)[:2]),
        (torch.zeros((1, 1), dtype=torch.int64), h0))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("tq.term_matmul.default") == 3
    calls = []
    real = ttm.term_matmul_op
    monkeypatch.setattr(ttm, "term_matmul_op",
                        lambda *a: calls.append(a) or real(*a))
    fwd(tqp, tqs, torch.zeros((1, 1), dtype=torch.int64), h0)
    assert calls == []


def test_export_signature_mismatch_raises():
    f = load_serving(export_serving(lambda x: x * 2, (torch.zeros(4),)))
    torch.testing.assert_close(f(torch.ones(4)), torch.full((4,), 2.0))
    with pytest.raises(Exception):
        f(torch.zeros(5))


def _lstm_ckpt(tmp_path):
    from tq_tpu_torch.utils.checkpoint import save_params

    ck = tmp_path / "lm.npz"
    save_params(ck, _lstm_np(33278, 16, 16, 1), meta={"model": "LSTM"})
    return ck


def test_generate_cli_export(tmp_path, monkeypatch):
    """``--tr ... --export`` writes a program that reloads: the LSTM step
    and the Transformer decode step at cache length words + 1."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    art = tmp_path / "step.pt2"
    tgen.main(["--checkpoint", str(_lstm_ckpt(tmp_path)), "--words", "5",
               "--tr", "8", "8", "24", "8", "8", "--pack", "u8s",
               "--export", str(art), "--outf", str(tmp_path / "out.txt"),
               "--device", "cpu"])
    logp, _ = load_serving(art)(torch.zeros((1, 1), dtype=torch.int64),
                                tlm.init_hidden(1, nhid=16, nlayers=1))
    assert logp.shape == (1, 33278)

    ck = tmp_path / "tf.npz"
    _chip_smoke().transformer_checkpoint(ck, vocab=33278, emsize=8, nhid=12,
                                         nlayers=1)
    art = tmp_path / "tf.pt2"
    tgen.main(["--model", "Transformer", "--checkpoint", str(ck), "--words",
               "5", "--tr", "8", "8", "24", "8", "8", "--pack", "u8s",
               "--export", str(art), "--outf", str(tmp_path / "tf.txt"),
               "--device", "cpu"])
    cache = ttf.decode_init_cache(6, 1, 8, 2, 1)
    logp, cache = load_serving(art)(torch.zeros((1, 1), dtype=torch.int64),
                                    torch.tensor(0), cache)
    assert logp.shape == (1, 33278) and cache["k"].shape == (1, 1, 2, 6, 4)
    assert len((tmp_path / "tf.txt").read_text().split()) == 5


def test_generate_cli_export_requires_tr(tmp_path):
    with pytest.raises(SystemExit, match="requires --tr"):
        tgen.main(["--checkpoint", str(_lstm_ckpt(tmp_path)), "--export",
                   str(tmp_path / "x"), "--device", "cpu"])


def test_platforms_refused(tmp_path):
    """A platform the port does not serve ("tpu": the JAX package's) is
    refused by the four entry points; "cpu" and "cuda" are taken
    (``test_torch_port_export_platforms.py``)."""
    p = _lstm_np(32, 8, 8, 1)
    _, (tqp, tqc, tqs) = _lstm_serving(p, "LSTM", "u8s")
    with pytest.raises(ValueError, match="unknown: \\['tpu'\\]"):
        export_lm_step(tqp, tqc, tqs, platforms=("cpu", "tpu"))
    with pytest.raises(ValueError, match="unknown: \\['tpu'\\]"):
        export_serving(lambda x: x, (torch.zeros(1),), platforms=("tpu",))
    with pytest.raises(ValueError, match="unknown: \\['tpu'\\]"):
        tgen.generate_tr(p, 32, words=2, export_path=tmp_path / "x",
                         export_platforms=["cuda", "tpu"], device="cpu")
    with pytest.raises(ValueError, match="unknown: \\['tpu'\\]"):
        tgen.main(["--checkpoint", str(_lstm_ckpt(tmp_path)), "--tr", "8",
                   "8", "24", "8", "8", "--export", str(tmp_path / "x"),
                   "--export-platforms", "cpu,tpu", "--device", "cpu"])
    assert not (tmp_path / "x").exists()


# ---------------------------------------------------------- the operators


def _op_weights(fmt, K, N, rng):
    """(weight in format ``fmt``, its w_sf or None)."""
    w_sf = torch.tensor(0.0123)
    if fmt in ("f32", "bf16"):
        w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)
                             * 0.05)
        return (w.to(torch.bfloat16) if fmt == "bf16" else w), None
    if fmt in ("int8", "int16"):
        hi = 127 if fmt == "int8" else 1000
        q = torch.from_numpy(rng.integers(-hi, hi + 1, (K, N)))
        return q.to(getattr(torch, fmt)), w_sf
    q = torch.from_numpy(rng.integers(-255, 256, (K, N)))
    return ttm.pack_weight_u8s(q.to(torch.float32) * w_sf, w_sf, 8), None


@pytest.mark.parametrize("variant", sorted(ttm.VARIANTS))
def test_term_matmul_op_cpu_is_the_plain_version(variant):
    """Every variant the checks admit: the operator's CPU implementation
    equals term_matmul_ref, bit for bit, at a shape the streaming kernel
    and one the others take; its fake gives the (M, N) float32 output."""
    mode, fmt, quantize_x = ttm.VARIANTS[variant]
    rng = np.random.default_rng(len(variant))
    bits, terms = (7, 3) if mode == "int8" else (8, 3)
    kw = dict(bf16=mode == "bf16", int8=mode == "int8",
              quantize_x=quantize_x)
    for M, K, N in ((1, 19, 34), (12, 21, 40)):
        w, w_sf = _op_weights(fmt, K, N, rng)
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
        sf = torch.tensor(0.03)
        want = ttm.term_matmul_ref(x, w, sf, bits, terms, w_sf=w_sf, **kw)
        got = ttm._call_op(x, w, sf, bits, terms, kw["bf16"], kw["int8"],
                           w_sf, quantize_x)
        assert torch.equal(got, want)
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode_:
            fx = mode_.from_tensor(x)
            fw = (ttm.PackedWeight8(*(mode_.from_tensor(t) for t in w))
                  if isinstance(w, ttm.PackedWeight8) else mode_.from_tensor(w))
            fsf = mode_.from_tensor(sf)
            fwsf = None if w_sf is None else mode_.from_tensor(w_sf)
            out = ttm._call_op(fx, fw, fsf, bits, terms, kw["bf16"],
                               kw["int8"], fwsf, quantize_x)
        assert tuple(out.shape) == (M, N) and out.dtype == torch.float32


@pytest.mark.parametrize("dtype,group_size,axis", [
    (torch.float32, 1, 1), (torch.bfloat16, 1, 1), (torch.float32, 8, 0),
    (torch.float32, 3, 1)])
def test_tr_quantize_op_cpu_is_the_plain_version(dtype, group_size, axis):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(20, 13)).astype(np.float32)).to(dtype)
    sf = torch.tensor(0.05)
    want = ttq.tr_quantize_ref(x, sf, 8, group_size, 5, axis)
    got = ttq.tr_quantize_op(x, sf, 8, group_size, 5, axis, "largest")
    assert got.dtype == want.dtype and torch.equal(got, want)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        out = ttq.tr_quantize_op(mode.from_tensor(x), mode.from_tensor(sf),
                                 8, group_size, 5, axis, "largest")
    assert out.shape == x.shape and out.dtype == dtype
