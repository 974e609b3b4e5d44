"""The LM trainer of the port (five model families) against the JAX
package: the train steps at dropout 0, the train-mode forwards, the
evaluation, training on a tiny on-disk corpus, checkpoints both ways into
the sweeps and ``--export``.

The same numpy weights (vocab 30-31, emsize 16, nhid 16) and chunks go
through both packages on the CPU.

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_train_lm
--expected``, it prints the JAX package's losses of the first
``chip_smoke.LM_CHUNKS`` chunks of the LSTM and the Transformer at full
width (``chip_smoke.lstm_checkpoint`` / ``transformer_checkpoint``'s
weights, the synthetic training stream, dropout 0; about a minute and a
few GB on 8 CPU cores): the LM numbers ``chip_smoke.EXPECTED_TRAIN``
pins.
"""

import importlib.util
import json
import math
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu.data import wikitext as jwiki
from tq_tpu.evals import lstm as jeval
from tq_tpu.evals import train_lstm as jtrain
from tq_tpu.models import lstm_lm as jlm
from tq_tpu.models import transformer_lm as jtf
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu_torch.evals import lstm as teval
from tq_tpu_torch.evals import train_lstm as ttrain
from tq_tpu_torch.models import lstm_lm as tlm
from tq_tpu_torch.models import transformer_lm as ttf
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.export import load_serving
from tq_tpu_torch.utils.params import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
VOCAB, EMSIZE, NHID, BATCH, BPTT = 30, 16, 16, 4, 8


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tiny_corpus(tmp_path):
    """tests/test_train_lm.py's on-disk corpus: 30 Zipf-skewed words."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(30)]
    p = 1.0 / np.arange(1, 31)
    p /= p.sum()
    root = tmp_path / "corpus"
    root.mkdir()
    for split, lines in [("train", 120), ("valid", 30), ("test", 30)]:
        text = "\n".join(" ".join(rng.choice(words, size=8, p=p))
                         for _ in range(lines))
        (root / f"{split}.txt").write_text(text)
    return root


def _jax_init(model: str, seed: int = 0, nlayers: int = 2):
    key = jax.random.PRNGKey(seed)
    if model == "Transformer":
        p = jtf.init(key, vocab=VOCAB, emsize=EMSIZE, nhead=2, nhid=NHID,
                     nlayers=nlayers)
    else:
        p = jlm.init(key, vocab=VOCAB, emsize=EMSIZE, nhid=NHID,
                     nlayers=nlayers, cell=model)
    return jax.device_get(p)


def _jax_hidden(model: str, seed: int):
    rng = np.random.default_rng(seed)

    def h():
        return (rng.normal(size=(2, BATCH, NHID)) * 0.5).astype(np.float32)

    return (h(), h()) if model == "LSTM" else h()


def _stream(seed: int = 1, rows: int = 2 * BPTT + 1):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (rows, BATCH)).astype(np.int32)


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-6):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)


def test_models_list_matches_jax():
    assert ttrain.MODELS == jtrain.MODELS
    assert ttrain.RNN_CELLS == jtrain.RNN_CELLS


@pytest.mark.parametrize("model", jtrain.MODELS)
def test_train_steps_match_jax(model):
    """Two chunks of the trainer's step at dropout 0, lr 5, clip 0.25 (the
    clip binds), the hidden state carried: losses, new hidden state and
    updated parameters against the JAX step within rtol 1e-5."""
    init = _jax_init(model)
    stream = _stream()
    jp = jax.tree.map(jnp.asarray, init)
    tp = params_from_jax(init, "cpu")
    jh = jax.tree.map(jnp.asarray, _jax_hidden(model, 2))
    th = params_from_jax(_jax_hidden(model, 2), "cpu")
    if model == "LSTM":
        th = tuple(th)
    key = jax.random.PRNGKey(0)
    for i in range(0, 2 * BPTT, BPTT):
        x, y = stream[i:i + BPTT], stream[i + 1:i + 1 + BPTT].reshape(-1)
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        if model == "Transformer":
            jp, jl = jtrain._train_step_transformer(
                jp, jnp.asarray(x), jnp.asarray(y), key, jnp.float32(5.0),
                jnp.float32(0.25), 0.0, 2)
            tl = ttrain._train_step_transformer(tp, tx, ty, None, 5.0, 0.25,
                                                0.0, 2)
        else:
            jp, jl, jh = jtrain._train_step(
                jp, jnp.asarray(x), jnp.asarray(y), jh, key,
                jnp.float32(5.0), jnp.float32(0.25), 0.0, model)
            tl, th = ttrain._train_step(tp, tx, ty, th, None, 5.0, 0.25,
                                        0.0, model)
            assert not any(t.requires_grad for t in
                           (th if model == "LSTM" else (th,)))
            _assert_tree_close(th, jh)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _assert_tree_close(tp, jp)


def test_sgd_clip_update_leaves_integer_leaves_and_clips():
    p = [torch.ones(3), torch.arange(3)]
    g = [torch.full((3,), 4.0), torch.ones(3)]
    ttrain._sgd_clip_update(p, g, 2.0, 0.5)
    # |g| = sqrt(48): scale 0.5 / (sqrt(48) + 1e-6) on the float leaf only.
    np.testing.assert_allclose(
        p[0].numpy(), 1 - 2.0 * 0.5 / (math.sqrt(48) + 1e-6) * 4.0,
        rtol=1e-6)
    assert torch.equal(p[1], torch.arange(3))


@pytest.mark.parametrize("model", jtrain.MODELS)
def test_train_forward_at_dropout_0_is_the_eval_forward(model):
    """The train-mode forwards at dropout 0 compute exactly what the
    eval forwards do (and the JAX package's train forward within rtol
    1e-5); at dropout 0.5 a seeded generator gives another, repeatable
    result."""
    init = _jax_init(model)
    tp = params_from_jax(init, "cpu")
    x = _stream()[:BPTT]
    tx = torch.as_tensor(x)
    key = jax.random.PRNGKey(0)
    if model == "Transformer":
        want = jtf.apply_train(init, jnp.asarray(x), key, nhead=2,
                               dropout=0.0)

        def fwd(rate, gen):
            return ttf.apply_train(tp, tx, gen, nhead=2, dropout=rate)

        assert torch.equal(fwd(0.0, None), ttf.apply(tp, tx, nhead=2))
    else:
        jh = _jax_hidden(model, 3)
        th = params_from_jax(jh, "cpu")
        th = tuple(th) if model == "LSTM" else th
        want, _ = jtrain._apply_train(init, jnp.asarray(x), jh, key, 0.0,
                                      model)

        def fwd(rate, gen):
            return ttrain._apply_train(tp, tx, th, gen, rate, model)[0]

        eval_logp, _ = tlm.apply(tp, tx, th, model)
        assert torch.equal(fwd(0.0, None), eval_logp)
    np.testing.assert_allclose(fwd(0.0, None).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    a = fwd(0.5, torch.Generator().manual_seed(4))
    b = fwd(0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.allclose(a, fwd(0.0, None))


@pytest.mark.parametrize("model", ["LSTM", "GRU", "RNN_RELU", "Transformer"])
def test_evaluate_matches_jax(model):
    init = _jax_init(model, nlayers=1)
    stream = _stream(rows=33)
    want = jtrain.evaluate(init, stream, bptt=BPTT, model=model)
    got = ttrain.evaluate(params_from_jax(init, "cpu"), stream, bptt=BPTT,
                          model=model)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("model", jtrain.MODELS)
def test_train_reduces_val_loss(tmp_path, model):
    """Two epochs on the tiny corpus beat the uniform baseline log(31),
    and the best-validation checkpoint is written with the model
    family."""
    root = _tiny_corpus(tmp_path)
    save = tmp_path / "lm.npz"
    params, best_val = ttrain.train(
        epochs=2, batch_size=BATCH, bptt=BPTT, lr=5.0, dropout=0.0,
        data_dir=root, save_path=save, emsize=EMSIZE, nhid=NHID, nlayers=2,
        verbose=False, model=model, device="cpu")
    assert best_val < math.log(31) - 0.05
    back, meta = tckpt.load_params(save, with_meta=True)
    assert meta["model"] == model
    np.testing.assert_array_equal(back["encoder"]["w"],
                                  params["encoder"]["w"].numpy())


def test_best_params_are_a_copy(tmp_path, monkeypatch):
    """The best-validation snapshot does not alias the live parameters:
    when epoch 2 does not improve (its validation loss forced higher), the
    result is epoch 1's parameters, though the live tensors took epoch 2's
    steps."""
    root = _tiny_corpus(tmp_path)
    kw = dict(batch_size=BATCH, bptt=BPTT, lr=5.0, dropout=0.0,
              data_dir=root, emsize=EMSIZE, nhid=NHID, nlayers=1,
              verbose=False, device="cpu")
    losses = iter([1.0, 2.0, 1.0])
    monkeypatch.setattr(ttrain, "evaluate", lambda *a, **k: next(losses))
    params, best = ttrain.train(epochs=2, **kw)
    once, best_once = ttrain.train(epochs=1, **kw)
    assert best == best_once == 1.0
    assert torch.equal(params["encoder"]["w"], once["encoder"]["w"])
    assert not params["encoder"]["w"].requires_grad


def test_train_rejects_unknown_model(tmp_path):
    with pytest.raises(ValueError, match="model must be one of"):
        ttrain.train(epochs=1, data_dir=_tiny_corpus(tmp_path),
                     verbose=False, model="MAMBA", device="cpu")


def test_untied_training_and_fidelity_flags(tmp_path, capsys):
    """Untied training with clip, seed and log_interval: the decoder has
    its own weight, training improves it, the checkpoint records the
    family and the interval lines are printed."""
    root = _tiny_corpus(tmp_path)
    save = tmp_path / "untied.npz"
    params, best_val = ttrain.train(
        epochs=2, batch_size=BATCH, bptt=BPTT, lr=5.0, dropout=0.0, seed=7,
        data_dir=root, save_path=save, emsize=EMSIZE, nhid=NHID, nlayers=1,
        verbose=False, model="LSTM", tied=False, clip=0.5, log_interval=5,
        device="cpu")
    assert params["decoder"]["w"].shape == (EMSIZE, 31)
    assert best_val < math.log(31) - 0.05
    back, meta = jckpt.load_params(save, with_meta=True)
    assert "w" in back["decoder"] and meta["model"] == "LSTM"
    assert "| ppl " in capsys.readouterr().out


@pytest.mark.parametrize("model", ["GRU", "Transformer"])
def test_port_checkpoint_sweeps_in_jax(tmp_path, model):
    """train (port) -> npz -> the JAX package's run_sweep."""
    root = _tiny_corpus(tmp_path)
    save = tmp_path / "lm.npz"
    ttrain.train(epochs=1, batch_size=BATCH, bptt=BPTT, lr=5.0, dropout=0.0,
                 data_dir=root, save_path=save, emsize=EMSIZE, nhid=NHID,
                 nlayers=1, verbose=False, model=model, device="cpu")
    res = jeval.run_sweep([8], [24], [8], [8], [8], checkpoint=save,
                          data_dir=root, verbose=False, model=model)
    assert len(res["ppls"]) == 1 and math.isfinite(res["ppls"][0])


def test_jax_checkpoint_sweeps_in_the_port(tmp_path):
    """train (JAX package) -> npz -> the port's run_sweep, and the port's
    evaluate on those parameters equals the JAX package's."""
    root = _tiny_corpus(tmp_path)
    save = tmp_path / "jax_lm.npz"
    jparams, _ = jtrain.train(epochs=1, batch_size=BATCH, bptt=BPTT, lr=5.0,
                              dropout=0.0, data_dir=root, save_path=save,
                              emsize=EMSIZE, nhid=NHID, nlayers=1,
                              verbose=False, model="LSTM")
    res = teval.run_sweep([8], [24], [8], [8], [8], checkpoint=save,
                          data_dir=root, verbose=False, model="LSTM",
                          device="cpu")
    assert len(res["ppls"]) == 1 and math.isfinite(res["ppls"][0])
    corpus, _ = jwiki.load_corpus(root)
    val = jwiki.batchify(np.asarray(corpus.valid), 10)
    np.testing.assert_allclose(
        ttrain.evaluate(params_from_jax(tckpt.load_params(save), "cpu"), val,
                        BPTT),
        jtrain.evaluate(jparams, val, BPTT), rtol=1e-5)


def test_train_cli_export_reloads(tmp_path):
    """--export writes the best model's fp32 serving step as a
    torch.export program; reloaded, it equals lstm_lm.apply on the saved
    checkpoint."""
    root = _tiny_corpus(tmp_path)
    art, save = tmp_path / "step.pt2", tmp_path / "m.npz"
    ttrain.main(["--model", "GRU", "--epochs", "1", "--batch-size", "4",
                 "--bptt", "8", "--lr", "5", "--dropout", "0",
                 "--log-interval", "0", "--emsize", "8", "--nhid", "8",
                 "--nlayers", "1", "--data", str(root), "--save", str(save),
                 "--export", str(art), "--device", "cpu"])
    step = load_serving(art)
    tok = torch.tensor([[3]])
    hidden = tlm.init_hidden(1, nhid=8, nlayers=1, cell="GRU")
    logp, h = step(tok, hidden)
    assert logp.shape == (1, 31)
    params = params_from_jax(tckpt.load_params(save), "cpu")
    want, want_h = tlm.apply(params, tok, hidden, "GRU")
    torch.testing.assert_close(logp, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h, want_h, rtol=1e-6, atol=1e-6)


def test_train_cli_refuses_transformer_export(tmp_path):
    with pytest.raises(SystemExit):
        ttrain.main(["--model", "Transformer", "--export",
                     str(tmp_path / "x.pt2"), "--device", "cpu"])


def test_entry_point_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(epochs=1, data_dir=_tiny_corpus(tmp_path),
                     verbose=False)


def test_expected_train_lm_form():
    """chip_smoke pins LM_CHUNKS finite losses for the LSTM and the
    Transformer, the first near log(33278) at the seeded inits."""
    cs = _chip_smoke()
    for name in ("lstm", "transformer"):
        losses = cs.EXPECTED_TRAIN[name]["losses"]
        assert len(losses) == cs.LM_CHUNKS
        assert all(math.isfinite(v) for v in losses)
        assert abs(losses[0] - math.log(33278)) < 0.5


def jax_expected_train_lm() -> dict:
    """The JAX package's train steps over the first LM_CHUNKS chunks of
    the synthetic training stream (batch LM_BATCH, bptt LM_BPTT, lr LM_LR,
    clip LM_CLIP, dropout 0) from chip_smoke's seeded checkpoints."""
    cs = _chip_smoke()
    corpus, _ = jwiki.load_corpus()
    stream = jwiki.batchify(np.asarray(corpus.train), cs.LM_BATCH)
    lr, clip = jnp.float32(cs.LM_LR), jnp.float32(cs.LM_CLIP)
    key = jax.random.PRNGKey(0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in (("lstm", cs.lstm_checkpoint),
                           ("transformer", cs.transformer_checkpoint)):
            path = Path(tmp) / f"{name}.npz"
            make(path)
            params = jax.tree.map(jnp.asarray, jckpt.load_params(path))
            hidden = jlm.init_hidden(cs.LM_BATCH)
            losses = []
            for c in range(cs.LM_CHUNKS):
                i = c * cs.LM_BPTT
                x = jnp.asarray(stream[i:i + cs.LM_BPTT])
                y = jnp.asarray(stream[i + 1:i + 1 + cs.LM_BPTT].reshape(-1))
                if name == "lstm":
                    params, loss, hidden = jtrain._train_step(
                        params, x, y, hidden, key, lr, clip, 0.0, "LSTM")
                else:
                    params, loss = jtrain._train_step_transformer(
                        params, x, y, key, lr, clip, 0.0, 2)
                losses.append(float(loss))
            out[name] = losses
    return out


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps(jax_expected_train_lm()))
