"""The training path of the port against the JAX package: the
straight-through ``term_reveal_st``, the MLP trainer's step and schedule,
dropout, QAT and the MLP checkpoint both ways.

The same numpy weights and batches go through both packages on the CPU
(the port's ``tr_quantize`` runs its plain version there; the JAX
package's ``term_reveal_st`` is its ``jnp`` ``term_reveal``).

Run from the repository's root as
``JAX_PLATFORMS=cpu python -m tests.test_torch_port_train --expected``,
it prints the JAX package's first ``chip_smoke.TRAIN_STEPS`` losses of
the MLP recipe (Adadelta, dropout 0) and of each QAT setting from
``chip_smoke.mlp_checkpoint``'s weights on the synthetic training set
(about 20 s): the MLP and QAT numbers ``chip_smoke.EXPECTED_TRAIN`` pins.
"""

import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tq_tpu.data.synthetic import synthetic_mnist
from tq_tpu.evals import mlp as jeval
from tq_tpu.evals import qat_mlp as jqat
from tq_tpu.evals.train_mlp import nll_loss as j_nll
from tq_tpu.models import mlp as jmlp
from tq_tpu.ops.term_reveal import term_reveal as j_term_reveal
from tq_tpu.ops.term_reveal import term_reveal_st as j_st
from tq_tpu.utils import checkpoint as jckpt
from tq_tpu_torch.evals import qat_mlp as tqat
from tq_tpu_torch.evals import train_mlp as ttrain
from tq_tpu_torch.layers.common import dropout
from tq_tpu_torch.models import mlp as tmlp
from tq_tpu_torch.ops.term_reveal import term_reveal_st as t_st
from tq_tpu_torch.utils.params import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), _ = synthetic_mnist(num_train=4 * BATCH, num_test=8)
    return xtr, ytr


@pytest.fixture(scope="module")
def init_np():
    return jax.device_get(jmlp.init(jax.random.PRNGKey(3)))


def _batches(n: int, steps: int, order_seed: int = 1):
    """The trainers' first ``steps`` batches: slices of one epoch's
    ``default_rng(order_seed).permutation(n)``."""
    perm = np.random.default_rng(order_seed).permutation(n)
    return [perm[i * BATCH:(i + 1) * BATCH] for i in range(steps)]


def jax_mlp_recipe(params_np, xtr, ytr, steps: int, steps_per_epoch: int,
                   order_seed: int = 1):
    """The JAX trainer's step at dropout 0 (its ``step`` is a closure, so
    composed here from ``mlp.apply``, ``nll_loss`` and optax): Adadelta at
    ``exponential_decay(1.0, steps_per_epoch, 0.7, staircase=True)``.
    Returns (losses, params)."""
    params = jax.tree.map(jnp.asarray, params_np)
    opt = optax.adadelta(optax.exponential_decay(
        1.0, transition_steps=steps_per_epoch, decay_rate=0.7,
        staircase=True))
    state = opt.init(params)

    @jax.jit
    def step(p, s, x, y):
        loss, g = jax.value_and_grad(lambda p: j_nll(jmlp.apply(p, x), y))(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    losses = []
    for idx in _batches(len(ytr), steps, order_seed):
        params, state, loss = step(params, state, xtr[idx], ytr[idx])
        losses.append(float(loss))
    return losses, params


def port_mlp_recipe(params, xtr, ytr, steps: int, steps_per_epoch: int,
                    order_seed: int = 1):
    """The port's ``train`` loop at dropout 0: ``make_optimizer``,
    ``train_step``, the StepLR stepped once an epoch.  Returns the loss
    tensors (on the parameters' device)."""
    opt, sched = ttrain.make_optimizer(params)
    device = params["fc1"]["w"].device
    losses = []
    for i, idx in enumerate(_batches(len(ytr), steps, order_seed)):
        losses.append(ttrain.train_step(
            params, opt, torch.as_tensor(xtr[idx], device=device),
            torch.as_tensor(ytr[idx], device=device), dropout=False))
        if (i + 1) % steps_per_epoch == 0:
            sched.step()
    return losses


def jax_qat_recipe(params_np, xtr, ytr, setting, steps: int,
                   order_seed: int = 1):
    """``train_qat``'s step (a closure there): Adam(1e-3) on the loss
    through ``qat_apply`` without dropout, the latent parameters clipped
    to [-1, 1].  Returns (losses, params)."""
    params = jax.tree.map(jnp.asarray, params_np)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    @jax.jit
    def step(p, s, x, y):
        loss, g = jax.value_and_grad(
            lambda p: j_nll(jqat.qat_apply(p, x, *setting), y))(p)
        up, s = opt.update(g, s, p)
        p = jax.tree.map(lambda l: jnp.clip(l, -1.0, 1.0),
                         optax.apply_updates(p, up))
        return p, s, loss

    losses, codes = [], []
    for idx in _batches(len(ytr), steps, order_seed):
        codes.append(jax_qat_fingerprints(params, setting))
        params, state, loss = step(params, state, xtr[idx], ytr[idx])
        losses.append(float(loss))
    return losses, params, codes


def jax_qat_fingerprints(params, setting) -> list:
    """chip_smoke.qat_fingerprints of the JAX package's term-revealed
    weights."""
    wb, gs, wt = setting[:3]
    out = []
    for name in jmlp.LAYER_NAMES:
        w = jnp.asarray(params[name]["w"])
        sf = jqat._st_scale(w, wb)
        q = np.rint(np.asarray(j_term_reveal(w, sf, wb, gs, wt, axis=0))
                    / np.asarray(sf))
        out.append(_chip_smoke().code_fingerprint(q))
    return out


def port_qat_recipe(params, xtr, ytr, setting, steps: int,
                    order_seed: int = 1):
    """``train_qat``'s loop: Adam(1e-3) over ``trainable`` and
    ``qat_step``.  Returns the loss tensors."""
    opt = torch.optim.Adam(ttrain.trainable(params), lr=1e-3)
    device = params["fc1"]["w"].device
    return [tqat.qat_step(params, opt,
                          torch.as_tensor(xtr[idx], device=device),
                          torch.as_tensor(ytr[idx], device=device), *setting)
            for idx in _batches(len(ytr), steps, order_seed)]


def _assert_params_close(tparams, jparams, rtol=1e-5, atol=1e-7):
    for name in tmlp.LAYER_NAMES:
        for k in ("w", "b"):
            np.testing.assert_allclose(tparams[name][k].detach().numpy(),
                                       np.asarray(jparams[name][k]),
                                       rtol=rtol, atol=atol)


# ------------------------------------------------------ term_reveal_st


@pytest.mark.parametrize("group_size,axis", [(1, 0), (1, 1), (8, 0), (8, 1)])
@pytest.mark.parametrize("bits,terms", [(4, 2), (6, 3)])
def test_term_reveal_st_forward_bit_equal(group_size, axis, bits, terms):
    """Forward bit for bit with the JAX term_reveal_st; axis 1 holds 50
    columns, a partial trailing group of 2 at g = 8."""
    x = np.random.default_rng(bits).normal(size=(40, 50)).astype(np.float32)
    want = j_st(jnp.asarray(x), jnp.float32(0.05), bits, group_size, terms,
                axis)
    got = t_st(torch.as_tensor(x), torch.tensor(0.05), bits, group_size,
               terms, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group_size", [1, 8])
def test_term_reveal_st_gradient_matches_jax(group_size):
    """d/dx sum(q(x)^2) is 2 q(x) under the straight-through gradient, in
    both packages alike (tests/test_qat.py's check), and sf's gradient is
    zero in both."""
    x = np.random.default_rng(0).normal(size=(32,)).astype(np.float32)

    def f(x, sf):
        return jnp.sum(j_st(x, sf, 6, group_size, 3, 0) ** 2)

    jg, jg_sf = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.float32(0.05))
    tx = torch.tensor(x, requires_grad=True)
    tsf = torch.tensor(0.05, requires_grad=True)
    (t_st(tx, tsf, 6, group_size, 3, 0) ** 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    q = j_term_reveal(jnp.asarray(x), jnp.float32(0.05), 6, group_size, 3,
                      axis=0)
    np.testing.assert_array_equal(tx.grad.numpy(), 2 * np.asarray(q))
    assert float(tsf.grad) == float(jg_sf) == 0.0


def test_term_reveal_st_backward_passes_the_gradient_itself():
    """The backward returns the upstream gradient unchanged, and no sf
    gradient where sf takes none."""
    x = torch.randn(16, 8, requires_grad=True)
    g = torch.randn(16, 8)
    (gx,) = torch.autograd.grad(t_st(x, torch.tensor(0.1), 4, 8, 6, 0), x, g)
    assert torch.equal(gx, g)


def test_qat_regression_trains_through_the_quantizer(rng):
    """tests/test_qat.py's regression problem trained through weight term
    revealing in the port: the loss falls 20-fold and the deployed
    weights are multiples of sf."""
    w_true = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 4))
                        * 0.5)
    x = torch.as_tensor(rng.normal(size=(128, 16)), dtype=torch.float32)
    y = x @ torch.as_tensor(w_true)
    w = torch.zeros(16, 4, requires_grad=True)
    opt = torch.optim.Adam([w], lr=5e-2)
    sf = torch.tensor(0.02)
    losses = []
    for _ in range(150):
        opt.zero_grad()
        loss = torch.mean((x @ t_st(w, sf, 8, 8, 12, 0) - y) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < 0.05 * losses[0]
    ratio = (t_st(w.detach(), sf, 8, 8, 12, 0) / 0.02).numpy()
    np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-4)


# ------------------------------------------------------------- dropout


def test_dropout_keep_rate_and_scale():
    x = torch.ones(1000, 1000)
    gen = torch.Generator().manual_seed(0)
    out = dropout(x, 0.2, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    assert torch.equal(out[kept], torch.full_like(out[kept],
                                                  np.float32(1.0) / 0.8))
    # Rate 0 draws nothing and returns x itself.
    state = gen.get_state()
    assert dropout(x, 0.0, gen) is x
    assert torch.equal(gen.get_state(), state)
    # The same seed, the same mask.
    again = dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert torch.equal(again, out)


def test_mlp_train_mode_drops_hidden_units(init_np, data):
    params = params_from_jax(init_np, "cpu")
    x = torch.as_tensor(data[0][:8])
    eval_logp = tmlp.apply(params, x)
    np.testing.assert_allclose(eval_logp.numpy(),
                               np.asarray(jmlp.apply(init_np, data[0][:8])),
                               rtol=1e-5, atol=1e-6)
    a = tmlp.apply(params, x, train=True,
                   generator=torch.Generator().manual_seed(1))
    b = tmlp.apply(params, x, train=True,
                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, eval_logp)


# ---------------------------------------------------- optimizer parity


def test_step_lr_equals_optax_staircase():
    """StepLR stepped once an epoch of S steps gives optax's staircase
    exponential_decay at steps S-1, S and 2S."""
    S = 7
    opt = torch.optim.Adadelta([torch.zeros(1, requires_grad=True)], lr=1.0)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.7)
    schedule = optax.exponential_decay(1.0, transition_steps=S,
                                       decay_rate=0.7, staircase=True)
    lrs = []
    for step in range(2 * S + 1):
        lrs.append(opt.param_groups[0]["lr"])
        if (step + 1) % S == 0:
            sched.step()
    for step in (S - 1, S, 2 * S):
        np.testing.assert_allclose(lrs[step], float(schedule(step)),
                                   rtol=1e-6)


def test_mlp_train_steps_match_jax(init_np, data):
    """Three Adadelta steps at dropout 0 across an epoch boundary (two
    steps an epoch): losses and parameters against the JAX recipe within
    rtol 1e-5."""
    xtr, ytr = data
    jl, jp = jax_mlp_recipe(init_np, xtr, ytr, 3, steps_per_epoch=2)
    params = params_from_jax(init_np, "cpu")
    tl = port_mlp_recipe(params, xtr, ytr, 3, steps_per_epoch=2)
    np.testing.assert_allclose([float(v) for v in tl], jl, rtol=1e-5)
    _assert_params_close(params, jp)


# ----------------------------------------------------------------- QAT


@pytest.mark.parametrize("setting", [(1, 1, 1, 6, 6), (4, 8, 6, 6, 6)],
                         ids=["wb1_g1", "wb4_g8"])
@pytest.mark.parametrize("act_quant", [False, True])
def test_qat_apply_logp_and_grads_match_jax(init_np, data, setting,
                                            act_quant):
    x = data[0][:8]
    y = data[1][:8]

    def jloss(p):
        return j_nll(jqat.qat_apply(p, x, *setting, act_quant=act_quant), y)

    jlogp = jqat.qat_apply(init_np, x, *setting, act_quant=act_quant)
    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, init_np))
    params = params_from_jax(init_np, "cpu")
    ttrain.trainable(params)
    logp = tqat.qat_apply(params, torch.as_tensor(x), *setting,
                          act_quant=act_quant)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp),
                               rtol=1e-5, atol=1e-6)
    ttrain.nll_loss(logp, torch.as_tensor(y)).backward()
    for name in tmlp.LAYER_NAMES:
        for k in ("w", "b"):
            want = np.asarray(jgrads[name][k])
            np.testing.assert_allclose(params[name][k].grad.numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("setting", [(1, 1, 1, 6, 6), (4, 8, 6, 6, 6)],
                         ids=["wb1_g1", "wb4_g8"])
def test_qat_step_matches_jax(init_np, data, setting):
    """One step of train_qat's recipe from the same parameters and batch:
    the loss within rtol 1e-5 of the JAX recipe's, the updated (clipped)
    parameters within rtol 1e-5 wherever the gradient is at least 1e-6.
    Below that Adam's first step lr * g / (|g| + 1e-8) turns float32
    sum-order noise in g (cancelling sums, ~1% of 1e-8) into up to 2 * lr:
    there the parameters are held within 2 * lr."""
    xtr, ytr = data
    idx = _batches(len(ytr), 1)[0]
    jgrads = jax.grad(lambda p: j_nll(jqat.qat_apply(p, xtr[idx], *setting),
                                      ytr[idx]))(
        jax.tree.map(jnp.asarray, init_np))
    jl, jp, _ = jax_qat_recipe(init_np, xtr, ytr, setting, 1)
    params = params_from_jax(init_np, "cpu")
    tl = port_qat_recipe(params, xtr, ytr, setting, 1)
    np.testing.assert_allclose(float(tl[0]), jl[0], rtol=1e-5)
    for name in tmlp.LAYER_NAMES:
        for k in ("w", "b"):
            got = params[name][k].detach().numpy()
            want = np.asarray(jp[name][k])
            live = np.abs(np.asarray(jgrads[name][k])) >= 1e-6
            np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                       atol=1e-7)
            assert np.abs(got[~live] - want[~live]).max(initial=0) <= 2e-3


def test_adam_and_clip_match_optax_given_the_same_gradients(init_np):
    """train_qat's optimizer (torch Adam at 1e-3, then the clip to [-1,
    1]) against optax.adam on the same gradients (1e-9 to 1), three
    steps: every element within rtol 1e-5 plus 1e-5 * lr a step.  optax
    forms the bias correction 1 - 0.999**t in float32 (1.3e-5 off at
    t = 1), so its steps are up to 6.4e-6 * lr shorter than torch's."""
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 10.0 **
                                     rng.integers(-9, 0, a.shape))
                          .astype(np.float32), init_np) for _ in range(3)]
    params = params_from_jax(init_np, "cpu")
    leaves = {id(t): (n, k) for n in params for k, t in params[n].items()}
    opt = torch.optim.Adam(ttrain.trainable(params), lr=1e-3)
    jparams = jax.tree.map(jnp.asarray, init_np)
    jopt = optax.adam(1e-3)
    state = jopt.init(jparams)
    for g in grads:
        for p in opt.param_groups[0]["params"]:
            n, k = leaves[id(p)]
            p.grad = torch.as_tensor(g[n][k])
        opt.step()
        with torch.no_grad():
            for p in opt.param_groups[0]["params"]:
                p.clamp_(-1.0, 1.0)
        up, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = jax.tree.map(lambda l: jnp.clip(l, -1.0, 1.0),
                               optax.apply_updates(jparams, up))
    _assert_params_close(params, jparams, atol=3 * 1e-5 * 1e-3)


def test_train_qat_clips_latent_weights(monkeypatch):
    """train_qat on the CPU through its own loop (one epoch of 4 steps):
    finite latent parameters within [-1, 1]."""
    small = synthetic_mnist(num_train=4 * BATCH, num_test=8)
    monkeypatch.setattr(tqat, "load_mnist",
                        lambda data_dir=None: (*small, "synthetic"))
    params = tqat.train_qat(2, 1, 2, 6, 6, epochs=1, verbose=False,
                            device="cpu")
    for name in tmlp.LAYER_NAMES:
        w = params[name]["w"]
        assert not w.requires_grad
        assert torch.isfinite(w).all() and float(w.abs().max()) <= 1.0


# ------------------------------------------------------ the entry points


def test_train_dry_run_checkpoint_loads_and_sweeps_in_jax(tmp_path):
    """The port's trainer (one batch) writes an npz the JAX package loads
    and evaluates; its forward equals the port's."""
    path = tmp_path / "mlp.npz"
    params, acc = ttrain.train(dry_run=True, save_path=str(path),
                               verbose=False, device="cpu")
    assert 0.0 <= acc <= 100.0
    jp = jckpt.load_params(path)
    (_, _), (xte, yte) = synthetic_mnist(num_train=8, num_test=256)
    np.testing.assert_allclose(
        tmlp.apply(params, torch.as_tensor(xte)).numpy(),
        np.asarray(jmlp.apply(jp, xte)), rtol=1e-5, atol=1e-5)
    jacc, tmacs, bits = jeval.evaluate_setting(jp, 2, 2, 6, 6, 1, xte, yte)
    assert 0.0 <= jacc <= 100.0 and tmacs > 0 and bits > 0


def test_jax_checkpoint_sweeps_in_the_port(tmp_path, init_np):
    """A JAX-package MLP checkpoint through the port's sweep."""
    from tq_tpu_torch.evals.mlp import run_sweep

    path = tmp_path / "jax_mlp.npz"
    jckpt.save_params(path, init_np)
    res = run_sweep([2], [2], [6], [6], [1], str(tmp_path / "s.json"),
                    checkpoint=str(path), verbose=False, device="cpu")
    assert len(res["accs"]) == 1 and res["tmacs"][0] > 0


def test_entry_points_default_to_cuda():
    """Without a card the trainers raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(dry_run=True, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqat.train_qat(1, 1, 1, 6, 6, epochs=1, verbose=False)


def test_qat_cli_runs_on_the_cpu(monkeypatch, capsys):
    """The QAT demo's CLI end to end on the CPU, on small data (two steps
    an epoch, 64 test samples)."""
    small = synthetic_mnist(num_train=2 * BATCH, num_test=64)
    import tq_tpu_torch.evals.train_mlp as tm

    for mod in (tqat, tm):
        monkeypatch.setattr(mod, "load_mnist",
                            lambda data_dir=None: (*small, "synthetic"))
    tqat.main(["--epochs", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["setting"] == dict(wb=1, wt=1, db=6, dt=6, gs=1)
    assert all(0.0 <= out[k] <= 100.0
               for k in ("fp32_acc", "ptq_acc", "qat_acc"))


# --------------------------------------------- chip_smoke's constants


def test_expected_train_form_and_first_losses():
    """chip_smoke.EXPECTED_TRAIN holds TRAIN_STEPS losses per MLP/QAT run;
    its first loss is the port's (CPU) on mlp_checkpoint's weights and the
    first batch of the synthetic training set, within rtol 1e-5."""
    cs = _chip_smoke()
    exp = cs.EXPECTED_TRAIN
    assert set(exp) >= {"mlp", *cs.QAT_SETTINGS}
    (xtr, ytr), _ = synthetic_mnist()
    idx = _batches(len(ytr), 1, cs.TRAIN_ORDER_SEED)[0]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mlp.npz"
        cs.mlp_checkpoint(path)
        params = params_from_jax(jckpt.load_params(path), "cpu")
    x, y = torch.as_tensor(xtr[idx]), torch.as_tensor(ytr[idx])
    with torch.no_grad():
        first = {"mlp": ttrain.nll_loss(tmlp.apply(params, x), y)}
        for name, setting in cs.QAT_SETTINGS.items():
            first[name] = ttrain.nll_loss(
                tqat.qat_apply(params, x, *setting), y)
    for name, loss in first.items():
        assert len(exp[name]["losses"]) == cs.TRAIN_STEPS
        np.testing.assert_allclose(float(loss), exp[name]["losses"][0],
                                   rtol=1e-5)
    for name, setting in cs.QAT_SETTINGS.items():
        assert len(exp[name]["codes"]) == cs.TRAIN_STEPS
        assert cs.qat_fingerprints(torch, params, setting) == \
            exp[name]["codes"][0]


@pytest.mark.parametrize("setting", [(1, 1, 1, 6, 6), (4, 8, 6, 6, 6)],
                         ids=["wb1_g1", "wb4_g8"])
def test_qat_fingerprints_agree_and_see_one_flip(init_np, setting):
    """chip_smoke's fingerprint of the port's codes equals the JAX
    package's on the same weights, and one code moved by one step changes
    it, anywhere in the array."""
    cs = _chip_smoke()
    params = params_from_jax(init_np, "cpu")
    fp = cs.qat_fingerprints(torch, params, setting)
    assert fp == jax_qat_fingerprints(init_np, setting)
    q = np.random.default_rng(0).integers(-8, 9, 512 * 784)
    base = cs.code_fingerprint(q)
    for i in (0, 1, 12345, q.size - 1):
        q[i] += 1
        assert cs.code_fingerprint(q) != base
        q[i] -= 1


def jax_expected_train() -> dict:
    """The JAX package's first TRAIN_STEPS losses of the MLP recipe and
    of each QAT setting (with the fingerprints of the weight codes each
    step multiplies), from chip_smoke.mlp_checkpoint's weights, on the
    synthetic training set in train()'s batch order."""
    cs = _chip_smoke()
    (xtr, ytr), _ = synthetic_mnist()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mlp.npz"
        cs.mlp_checkpoint(path)
        init = jckpt.load_params(path)
    out = {"mlp": {"losses": jax_mlp_recipe(
        init, xtr, ytr, cs.TRAIN_STEPS, len(ytr) // BATCH,
        cs.TRAIN_ORDER_SEED)[0]}}
    for name, setting in cs.QAT_SETTINGS.items():
        losses, _, codes = jax_qat_recipe(init, xtr, ytr, setting,
                                          cs.TRAIN_STEPS,
                                          cs.TRAIN_ORDER_SEED)
        out[name] = {"losses": losses, "codes": codes}
    return out


if __name__ == "__main__" and "--expected" in sys.argv:
    print(json.dumps(jax_expected_train()))
