"""The Transformer LM slice of the port against the JAX package.

The same numpy weights (vocab 30-64, emsize 16, nhid 24, one or two
layers) go through both packages on the CPU: the fp32 forward, conversion
and the quantized forward after calibration, packing, the KV-cache decode
step against the full prefix, one sweep setting, both samplers, the
checkpoint of ``chip_smoke.transformer_checkpoint`` and the entry points'
device default.

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_transformer
--expected``, it prints the JAX package's sweep results at full width on
``chip_smoke.transformer_checkpoint``'s weights (minutes on 8 CPU cores),
the numbers ``chip_smoke.EXPECTED_TFM_SWEEPS`` pins.
"""

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

from tq_tpu.data import wikitext as jwiki
from tq_tpu.evals import generate as jgen
from tq_tpu.evals import lstm as jeval
from tq_tpu.layers.common import TRParams as JTRParams
from tq_tpu.models import transformer_lm as jtf
from tq_tpu.profilers import dense_term_macs
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu_torch.evals import generate as tgen
from tq_tpu_torch.evals import lstm as teval
from tq_tpu_torch.kernels import term_matmul as ttm
from tq_tpu_torch.models import transformer_lm as ttf
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.params import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
VOCAB, E, NHID, NHEAD = 40, 16, 24, 2

# The sweeps chip_smoke.py runs on the Transformer: the README lstm-quant
# settings and the lstm-tr one, as for the LSTM.
TFM_SWEEPS = {
    "lstm-quant": dict(wb=[5, 6, 7, 8, 9], wt=[5, 6, 7, 8, 9], db=[8] * 5,
                       dt=[8] * 5, gs=[1] * 5),
    "lstm-tr": dict(wb=[8], wt=[24], db=[8], dt=[8], gs=[8]),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np_params(tmp_path, vocab=VOCAB, nlayers=2, seed=0):
    """chip_smoke.transformer_checkpoint's weights at a small width, as
    the numpy tree either package loads."""
    path = tmp_path / f"tf_{vocab}_{nlayers}_{seed}.npz"
    _chip_smoke().transformer_checkpoint(path, seed=seed, vocab=vocab,
                                         emsize=E, nhid=NHID,
                                         nlayers=nlayers)
    return jckpt.load_params(path)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return params_from_jax(tree, "cpu")


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _assert_tree_equal(port_tree, jax_tree):
    """Leaf by leaf, bit for bit, dtype included."""
    a = tckpt.flatten_tree(port_tree)
    b = jckpt.flatten_tree(jax.device_get(jax_tree))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _tokens(shape, vocab=VOCAB, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def params_np(tmp_path_factory):
    return _np_params(tmp_path_factory.mktemp("tf"))


@pytest.fixture(scope="module")
def stream():
    """Four bptt chunks and a tail at the eval batch of 10."""
    rng = np.random.default_rng(5)
    return jwiki.batchify(rng.integers(0, VOCAB, 1450).astype(np.int32), 10)


# -------------------------------------------------------------- the model


def test_checkpoint_loads_the_same_tree_in_both_packages(tmp_path):
    path = tmp_path / "small.npz"
    _chip_smoke().transformer_checkpoint(path, vocab=30, emsize=8, nhid=12,
                                         nlayers=1)
    jp, tp = jckpt.load_params(path), tckpt.load_params(path)
    pre = "transformer_encoder.layers.0"
    assert jp[f"{pre}.self_attn.in_proj"]["w"].shape == (8, 24)
    assert jp[f"{pre}.linear1"]["w"].shape == (8, 12)
    assert jp["decoder"]["w"].shape == (8, 30)
    assert "transformer_encoder.layers.1.linear1" not in jp
    _assert_tree_equal(params_from_jax(tp, "cpu"), jp)
    # The port's model reads it: the forward at its shapes.
    logp = ttf.apply(_port(tp), torch.zeros(3, 2, dtype=torch.int64))
    assert logp.shape == (6, 30)


def test_init_distributions_and_shapes():
    p = ttf.init(torch.Generator().manual_seed(0), vocab=30, emsize=8,
                 nhid=12, nlayers=2, device="cpu")
    j = jax.device_get(jtf.init(jax.random.PRNGKey(0), vocab=30, emsize=8,
                                nhid=12, nlayers=2))
    assert p.keys() == j.keys()
    for name in p:
        for leaf in p[name]:
            assert tuple(p[name][leaf].shape) == j[name][leaf].shape, name
    assert float(p["encoder"]["w"].abs().max()) <= 0.1
    pre = "transformer_encoder.layers.1"
    assert float(p[f"{pre}.linear2"]["w"].abs().max()) <= 1 / np.sqrt(12)
    assert torch.equal(p[f"{pre}.norm1"]["scale"], torch.ones(8))


def test_fp32_apply_matches_jax(params_np):
    """Within 2e-4, tests/test_transformer_lm.py's limit against torch."""
    toks = _tokens((7, 3))
    want = jtf.apply(_jax(params_np), jnp.asarray(toks))
    got = ttf.apply(_port(params_np), torch.from_numpy(toks))
    assert got.shape == (21, VOCAB)
    _close(got, want, atol=2e-4)


def test_layer_norm_is_the_population_variance():
    x = np.random.default_rng(3).normal(size=(4, 5, 16)).astype(np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 16).astype(np.float32),
         "bias": np.linspace(-1, 1, 16).astype(np.float32)}
    want = jtf._layer_norm(_jax(p), jnp.asarray(x))
    got = ttf._layer_norm(_port(p), torch.from_numpy(x))
    _close(got, want, atol=1e-6)


def test_positional_encoding_equal():
    np.testing.assert_array_equal(
        ttf._positional_encoding(37, 16).numpy(),
        np.asarray(jtf._positional_encoding(37, 16)))


# (id, (wb, gs, wt, db, dt), quantize_input)
QUANT = [("tr-g8", (8, 8, 16, 8, 8), False),
         ("uq-g1", (6, 1, 6, 8, 8), False),
         ("quantized-input", (8, 8, 16, 8, 5), True)]


@pytest.mark.parametrize("tr,quantize_input", [q[1:] for q in QUANT],
                         ids=[q[0] for q in QUANT])
def test_quantized_apply_after_calibration_matches_jax(params_np, tr,
                                                       quantize_input):
    """Conversion bit for bit, every calibrated scale equal, the quantized
    log-probs within 1e-4."""
    toks = _tokens((5, 2), seed=2)
    jqp, jqc, jqs = jtf.convert(_jax(params_np), *tr,
                                quantize_input=quantize_input)
    tqp, tqc, tqs = ttf.convert(_port(params_np), *tr,
                                quantize_input=quantize_input)
    assert list(tqc) == list(jqc)
    assert "transformer_encoder.layers.0.self_attn.in_proj" not in tqc
    _assert_tree_equal(tqp, jqp)
    _, jqs = jtf.make_quantized_apply(jqc, track=True)(jqp, jqs,
                                                       jnp.asarray(toks))
    _, tqs = ttf.make_quantized_apply(tqc, track=True)(tqp, tqs,
                                                       torch.from_numpy(toks))
    for name in jqs:
        np.testing.assert_array_equal(tqs[name]["hist"].numpy(),
                                      np.asarray(jqs[name]["hist"]))
    jqs, tqs = jtf.finalize(jqs, jqc), ttf.finalize(tqs, tqc)
    for name in jqs:
        assert float(tqs[name]["sf"]) == float(jqs[name]["sf"]), name
    want, _ = jtf.make_quantized_apply(jqc, track=False)(jqp, jqs,
                                                         jnp.asarray(toks))
    got, _ = ttf.make_quantized_apply(tqc, track=False)(
        tqp, tqs, torch.from_numpy(toks))
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("fmt", ["int", "u8s"])
def test_pack_matches_jax_leaf_by_leaf(params_np, fmt):
    """Packs equal, byte for byte; the packed forward within 1e-4 of the
    JAX package's packed forward."""
    jqp, jqc, _ = jtf.convert(_jax(params_np), 8, 8, 16, 8, 8)
    tqp, tqc, _ = ttf.convert(_port(params_np), 8, 8, 16, 8, 8)
    jpk, tpk = jtf.pack(jqp, jqc, fmt=fmt), ttf.pack(tqp, tqc, fmt=fmt)
    expected = ttm.PackedWeight8 if fmt == "u8s" else torch.Tensor
    for name in tqc:
        assert isinstance(tpk[name]["w"], expected), name
    assert tpk["transformer_encoder.layers.1.self_attn.in_proj"]["w"].dtype \
        == torch.float32
    _assert_tree_equal(tpk, jpk)
    toks = _tokens((5, 2), seed=3)
    jqs = {n: {"hist": jnp.zeros(8192), "sf": jnp.float32(0.05)}
           for n in jqc}
    tqs = {n: {"hist": torch.zeros(8192), "sf": torch.tensor(0.05)}
           for n in tqc}
    want, _ = jtf.make_quantized_apply(jqc, track=False)(jpk, jqs,
                                                         jnp.asarray(toks))
    got, _ = ttf.make_quantized_apply(tqc, track=False)(
        tpk, tqs, torch.from_numpy(toks))
    _close(got, want, atol=1e-4)


def test_pack_mixed_precision_falls_back_like_jax(params_np):
    """u8s on a 9-bit grid packs 'int' (int16), as in the JAX package."""
    jqp, jqc, _ = jtf.convert(_jax(params_np), 9, 1, 9, 8, 8)
    tqp, tqc, _ = ttf.convert(_port(params_np), 9, 1, 9, 8, 8)
    tpk = ttf.pack(tqp, tqc, fmt="u8s")
    assert tpk["decoder"]["w"].dtype == torch.int16
    _assert_tree_equal(tpk, jtf.pack(jqp, jqc, fmt="u8s"))


def _packed_serving(params, tr=(8, 8, 24, 8, 8), fmt="u8s", sf=0.05):
    qp, qcfg, qs = ttf.convert(params, *tr)
    qs = {k: {**v, "sf": torch.tensor(sf)} for k, v in qs.items()}
    return ttf.pack(qp, qcfg, fmt=fmt), qp, qcfg, qs


def test_decode_step_matches_full_prefix(params_np):
    """KV-cache decoding equals the full-prefix forward at every position:
    within 1e-5 in fp32 and 2e-4 packed (the JAX test's limits)."""
    params = _port(params_np)
    T, B = 6, 3
    toks = torch.from_numpy(_tokens((T, B), seed=4))
    full = ttf.apply(params, toks).reshape(T, B, VOCAB)
    cache = ttf.decode_init_cache(T, B, E, NHEAD, 2)
    for t in range(T):
        logp, cache = ttf.decode_step(params, toks[t:t + 1], t, cache,
                                      nhead=NHEAD)
        _close(logp, full[t], atol=1e-5)
    packed, qp, qcfg, qs = _packed_serving(params)
    qfull, _ = ttf.make_quantized_apply(qcfg, track=False)(qp, qs, toks)
    qfull = qfull.reshape(T, B, VOCAB)
    cache = ttf.decode_init_cache(T, B, E, NHEAD, 2)
    for t in range(T):
        logp, cache = ttf.decode_step(packed, toks[t:t + 1],
                                      torch.tensor(t), cache, nhead=NHEAD,
                                      qcfg=qcfg, qstate=qs)
        _close(logp, qfull[t], atol=2e-4)


def test_decode_step_and_cache_match_jax(params_np):
    """The port's step against the JAX package's on the same tokens: the
    log-probs within 1e-5 and the (nlayers, B, nhead, L, hd) cache leaf
    by leaf within 1e-5, fp32 and u8s-packed."""
    T, B, L = 4, 2, 6
    toks = _tokens((T, B), seed=6)
    jp, tp = _jax(params_np), _port(params_np)
    jqp, jqc, jqs = jtf.convert(jp, 8, 8, 24, 8, 8)
    jqs = {k: {**v, "sf": jnp.float32(0.05)} for k, v in jqs.items()}
    jpk = jtf.pack(jqp, jqc, fmt="u8s")
    tpk, _, tqc, tqs = _packed_serving(tp)
    for jargs, targs in (((jp, None, None), (tp, None, None)),
                         ((jpk, jqc, jqs), (tpk, tqc, tqs))):
        jcache = jtf.decode_init_cache(L, B, E, NHEAD, 2)
        tcache = ttf.decode_init_cache(L, B, E, NHEAD, 2)
        assert tuple(tcache["k"].shape) == jcache["k"].shape == (2, B, NHEAD,
                                                                  L, E // 2)
        for t in range(T):
            jl, jcache = jtf.decode_step(jargs[0], jnp.asarray(toks[t:t + 1]),
                                         t, jcache, nhead=NHEAD,
                                         qcfg=jargs[1], qstate=jargs[2])
            tl, tcache = ttf.decode_step(targs[0],
                                         torch.from_numpy(toks[t:t + 1]), t,
                                         tcache, nhead=NHEAD, qcfg=targs[1],
                                         qstate=targs[2])
            _close(tl, jl, atol=1e-5)
            for leaf in ("k", "v"):
                _close(tcache[leaf], jcache[leaf], atol=1e-5)


def test_fixed_buffer_is_causal(params_np):
    """A buffer longer than the prefix, junk past it: the last prefix
    position's log-probs equal the exact prefix's."""
    params = _port(params_np)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB, 5)
    junk = rng.integers(0, VOCAB, 4)
    exact = ttf.apply(params, torch.from_numpy(prefix)[:, None])
    fixed = ttf.apply(params, torch.from_numpy(
        np.concatenate([prefix, junk]))[:, None])
    _close(fixed[4], exact[4], atol=1e-5)


# --------------------------------------------------------- the sweep path


@pytest.mark.parametrize("setting", [(8, 24, 8, 8, 8), (6, 6, 8, 8, 1)],
                         ids=["tr-g8", "uq-g1"])
def test_evaluate_setting_transformer_matches_jax(params_np, stream,
                                                  setting):
    """tmacs and param_bits equal, ppl within rtol 1e-4."""
    want = jeval.evaluate_setting_transformer(_jax(params_np), *setting,
                                              stream=stream, vocab=VOCAB)
    got = teval.evaluate_setting_transformer(_port(params_np), *setting,
                                             stream=stream, vocab=VOCAB)
    assert got[1:] == want[1:]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_run_sweep_transformer_cli_matches_jax(tmp_path, monkeypatch):
    """``--model Transformer`` on an npz at the corpus vocabulary, 400
    synthetic test tokens, through main()."""
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    ckpt = tmp_path / "tf.npz"
    _chip_smoke().transformer_checkpoint(ckpt, vocab=33278, emsize=8,
                                         nhid=12, nlayers=1)
    want = jeval.run_sweep([7], [7], [8], [8], [1], checkpoint=str(ckpt),
                           limit_tokens=400, verbose=False,
                           model="Transformer")
    out = tmp_path / "sweep.json"
    teval.main(["--wb", "7", "--wt", "7", "--db", "8", "--dt", "8", "--gs",
                "1", "--out-file", str(out), "--checkpoint", str(ckpt),
                "--limit-tokens", "400", "--model", "Transformer",
                "--device", "cpu"])
    got = json.loads(out.read_text())
    assert got["tmacs"] == want["tmacs"]
    assert got["param_bits"] == want["param_bits"]
    np.testing.assert_allclose(got["ppls"], want["ppls"], rtol=1e-4)


# ------------------------------------------------------- the serving path


def test_serving_model_matches_jax(params_np, stream):
    """generate_transformer_tr's model: calibrated on two chunks, the
    scales equal to the JAX package's and the u8s packs equal."""
    jqp, jqc, jqs = jtf.convert(_jax(params_np), 8, 8, 24, 8, 8)
    track = jtf.make_quantized_apply(jqc, track=True)
    for i, (x, _) in enumerate(jeval._chunks(stream)):
        if i >= 2:
            break
        _, jqs = track(jqp, jqs, jnp.asarray(x))
    jqs = jtf.finalize(jqs, jqc)
    tqp, tqc, tqs = tgen.transformer_serving_model(
        _port(params_np), (8, 8, 24, 8, 8), "u8s", stream, calib_chunks=2)
    for name in jqs:
        assert float(tqs[name]["sf"]) == float(jqs[name]["sf"]), name
    _assert_tree_equal(tqp, jtf.pack(jqp, jqc, fmt="u8s"))


def test_samplers_in_range_and_deterministic(params_np, stream):
    toks = tgen.generate_transformer(params_np, VOCAB, words=10, seed=5,
                                     device="cpu")
    assert len(toks) == 10 and all(0 <= t < VOCAB for t in toks)
    assert toks == tgen.generate_transformer(params_np, VOCAB, words=10,
                                             seed=5, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        tgen.generate_transformer(params_np, VOCAB, words=2,
                                  temperature=1e-4, device="cpu")
    kw = dict(words=8, seed=3, tr=(8, 8, 24, 8, 8), pack_fmt="u8s",
              calib_stream=stream, calib_chunks=2, device="cpu")
    toks = tgen.generate_transformer_tr(params_np, VOCAB, **kw)
    assert len(toks) == 8 and all(0 <= t < VOCAB for t in toks)
    assert toks == tgen.generate_transformer_tr(params_np, VOCAB, **kw)
    # The JAX package's sampler on the same model draws other tokens (its
    # PRNG), from the same range.
    jtoks = jgen.generate_transformer_tr(
        params_np, VOCAB, words=8, seed=3, tr=(8, 8, 24, 8, 8),
        pack_fmt="u8s", calib_stream=stream, calib_chunks=2)
    assert len(jtoks) == 8 and all(0 <= t < VOCAB for t in jtoks)


def test_fixed_buffer_sampler_draws_from_the_prefix(params_np, monkeypatch):
    """The fp32 sampler's step n reads the log-probs at position n of the
    buffer holding the tokens drawn so far."""
    params = _port(params_np)
    seen = []
    real = tgen._sample_scan

    def spy(fwd, carry, *args):
        def wrapped(tok, c):
            logp, c2 = fwd(tok, c)
            buf, n = c2
            seen.append((buf[:n, 0].clone(), logp))
            return logp, c2
        return real(wrapped, carry, *args)

    monkeypatch.setattr(tgen, "_sample_scan", spy)
    toks = tgen.generate_transformer(params_np, VOCAB, words=4, seed=2,
                                     device="cpu")
    for n, (prefix, logp) in enumerate(seen):
        assert prefix[1:].tolist() == toks[:n]
        exact = ttf.apply(params, prefix[:, None])
        _close(logp[0], exact[n], atol=1e-5)


def test_generate_main_transformer_on_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("TQ_DATA_DIR", raising=False)
    ckpt = tmp_path / "tf.npz"
    _chip_smoke().transformer_checkpoint(ckpt, vocab=33278, emsize=8,
                                         nhid=12, nlayers=1)
    for extra in ([], ["--tr", "7", "8", "12", "7", "3", "--pack", "int"]):
        out = tmp_path / "g.txt"
        tgen.main(["--model", "Transformer", "--checkpoint", str(ckpt),
                   "--words", "12", "--outf", str(out), "--device", "cpu",
                   *extra])
        words = out.read_text().split()
        assert len(words) == 12
        assert all(0 <= int(w) < 33278 for w in words)


# ------------------------------------------------------------ entry points


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path,
                                                           params_np):
    for fn in (tgen.generate_transformer, tgen.generate_transformer_tr):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.run_sweep([8], [8], [8], [8], [1], model="Transformer",
                        verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--wb", "8", "--wt", "8", "--db", "8", "--dt", "8",
                    "--gs", "1", "--model", "Transformer", "--out-file",
                    str(tmp_path / "o.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate_transformer(params_np, VOCAB, words=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate_transformer_tr(params_np, VOCAB, words=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--model", "Transformer", "--words", "2",
                   "--outf", str(tmp_path / "g.txt")])


# ------------------------------------------------- chip_smoke's constants


def test_expected_tfm_sweeps_pinned():
    """chip_smoke runs TFM_SWEEPS; its tmacs are the JAX package's counter
    summed over the seven converted linears at full width (pure shapes),
    its g=1 param_bits their elements * wb."""
    cs = _chip_smoke()
    assert [(n, e["settings"]) for n, e in cs.EXPECTED_TFM_SWEEPS.items()] \
        == list(TFM_SWEEPS.items())
    shapes = [(650, 33278)] + [(650, 650), (650, 650), (650, 650)] * 2
    for exp in cs.EXPECTED_TFM_SWEEPS.values():
        s = exp["settings"]
        for i, (wb, wt, db, dt, gs) in enumerate(
                zip(s["wb"], s["wt"], s["db"], s["dt"], s["gs"])):
            tr = JTRParams(wb, gs, wt, db, dt)
            assert exp["tmacs"][i] == sum(
                dense_term_macs(35 * 10 * n, k, tr) for k, n in shapes)
            if gs == 1:
                assert exp["param_bits"][i] == sum(
                    k * n for k, n in shapes) * wb


def jax_expected_sweeps() -> dict:
    """The JAX package's run_sweep(model="Transformer") (on the CPU) of
    every TFM_SWEEPS entry over chip_smoke.transformer_checkpoint's
    weights and the synthetic test stream."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "transformer_seeded.npz"
        _chip_smoke().transformer_checkpoint(ckpt)
        for name, s in TFM_SWEEPS.items():
            res = jeval.run_sweep(s["wb"], s["wt"], s["db"], s["dt"],
                                  s["gs"], checkpoint=str(ckpt),
                                  verbose=True, model="Transformer")
            out[name] = {"settings": s, **res}
    return out


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps(jax_expected_sweeps()))
