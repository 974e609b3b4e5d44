"""The LSTM LM's quantized step and the DeepSeek-V3 decode step through
their CUDA graphs (``utils/graphs.py``).

On the CPU the steps stay eager and the tests hold the gate, the counter
and the keys.  The tests marked ``cuda`` need a card and skip without
one; they import neither JAX nor the JAX package, so on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphs.py
"""

import copy

import pytest
import torch

from tq_tpu_torch.evals.generate import sample_quantized
from tq_tpu_torch.models import lstm_lm
from tq_tpu_torch.utils import graphs
from tq_tpu_torch.utils.graphs import STEP_GRAPHS, StepGraphs

VOCAB, NHID = 300, 32
TR = (8, 8, 24, 8, 8)


def _model(kind: str, device="cpu", seed: int = 0, vocab: int = VOCAB,
           nhid: int = NHID):
    """A seeded LSTM LM converted at TR: term-revealed float32 weights
    ('converted'), packed to int8/int16 ('int') or 9 bits ('u8s'), with
    scales set by hand."""
    gen = torch.Generator().manual_seed(seed)
    params = lstm_lm.init(gen, vocab=vocab, emsize=nhid, nhid=nhid)
    params = {k: ([{n: t.to(device) for n, t in layer.items()}
                   for layer in v] if k == "rnn"
                  else {n: t.to(device) for n, t in v.items()})
              for k, v in params.items()}
    qp, qc, qs = lstm_lm.convert(params, *TR)
    qs = {name: {**q, "sf": torch.tensor(0.02, device=device)}
          for name, q in qs.items()}
    if kind != "converted":
        qp = lstm_lm.pack(qp, qc, fmt=kind)
    return qp, qc, qs


def _inputs(batch: int, device="cpu", nhid: int = NHID):
    tok = torch.arange(batch, device=device).reshape(1, batch) % VOCAB
    return tok, lstm_lm.init_hidden(batch, nhid=nhid, device=device)


def _counts():
    c = STEP_GRAPHS.counts
    return {**c, "eager": dict(c["eager"])}


def _step_counts(step: str) -> dict:
    """``STEP_GRAPHS.counts["steps"][step]``, copied (zeros before the
    step's first call)."""
    c = STEP_GRAPHS.counts["steps"].get(step) or graphs._zero_counts()
    return {**c, "eager": dict(c["eager"])}


@pytest.mark.parametrize("kind", ["converted", "int", "u8s"])
def test_cpu_step_stays_eager_and_equals_the_eager_step(kind):
    """On the CPU the forward runs eagerly, counted under 'cpu', and
    gives what the eager step gives, bit for bit, three steps chained."""
    qp, qc, qs = _model(kind)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    tok, hidden = _inputs(3)
    want_hidden = hidden
    before = _counts()
    for _ in range(3):
        logp, hidden, new_qs = fwd(qp, qs, tok, hidden)
        want, want_hidden, want_qs = lstm_lm.quantized_step(
            qp, qc, qs, tok, want_hidden, False)
        assert torch.equal(logp, want)
        for a, b in zip(hidden, want_hidden):
            assert torch.equal(a, b)
        assert new_qs["rnn"] is qs["rnn"] and new_qs["decoder"] is qs[
            "decoder"]
        assert new_qs == want_qs
        tok = logp.argmax(-1).reshape(1, -1)
    after = _counts()
    assert after["eager"]["cpu"] - before["eager"]["cpu"] == 3
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]


def test_each_step_is_counted_under_its_own_name():
    """The LSTM step counts under ``lstm.step``, the DeepSeek-V3 decode
    step under ``dsv3.decode``, each beside the totals: on the CPU both
    eager for 'cpu', a tracking decode step for 'track'."""
    from test_torch_port_deepseek_v3 import TINY, _served, _tokens
    from tq_tpu_torch.models import deepseek_v3 as dsv3

    qp, qc, qs = _model("u8s")
    tok, hidden = _inputs(2)
    before = _counts()
    lstm0, dsv0 = _step_counts("lstm.step"), _step_counts("dsv3.decode")
    lstm_lm.make_quantized_apply(qc, track=False)(qp, qs, tok, hidden)
    dp, dc, ds = _served("packed")
    cache = dsv3.init_cache(TINY, 2, 4)
    tokens = _tokens(2, 1)[:, 0]
    dsv3.decode_step(dp, TINY, tokens, 0, cache, dc, ds)
    dsv3.decode_step(dp, TINY, tokens, 1, cache,
                     ctx=dsv3.Context(dc, ds, track=True))
    lstm1, dsv1 = _step_counts("lstm.step"), _step_counts("dsv3.decode")
    assert lstm1["eager"]["cpu"] - lstm0["eager"]["cpu"] == 1
    assert dsv1["eager"]["cpu"] - dsv0["eager"]["cpu"] == 1
    assert dsv1["eager"]["track"] - dsv0["eager"]["track"] == 1
    after = _counts()
    assert after["eager"]["cpu"] - before["eager"]["cpu"] == 2
    assert after["eager"]["track"] - before["eager"]["track"] == 1
    for c in (lstm1, dsv1):
        assert c["captures"] == c["replays"] == 0


def test_gate_keeps_tracking_grad_and_tracing_eager():
    """A tracking forward counts under 'track' and updates the
    histograms; an input that requires grad under 'grad'; a forward
    under ``torch.export`` under 'tracing'."""
    qp, qc, qs = _model("u8s")
    tok, hidden = _inputs(2)
    before = _counts()
    _, _, tracked = lstm_lm.make_quantized_apply(qc, track=True)(
        qp, qs, tok, hidden)
    assert float(tracked["rnn"]["hist"].sum()) > 0
    assert _counts()["eager"]["track"] == before["eager"]["track"] + 1

    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    h = hidden[0].clone().requires_grad_()
    fwd(qp, qs, tok, (h, hidden[1]))
    assert _counts()["eager"]["grad"] == before["eager"]["grad"] + 1

    from tq_tpu_torch.utils.export import export_lm_step

    export_lm_step(qp, qc, qs, batch=2)
    assert _counts()["eager"]["tracing"] > before["eager"]["tracing"]
    assert _counts()["captures"] == before["captures"]


def test_keys_differ_by_conversion_and_shape():
    """Two conversions of one model take two keys, one conversion one,
    whatever dicts hold it; two token shapes take two keys."""
    qp, qc, qs = _model("u8s")
    qp2, _, qs2 = _model("u8s")
    static = (qc["rnn"], qc["decoder"], "LSTM")
    a = graphs._Held((qp, qs), static)
    assert a == graphs._Held(({**qp}, {**qs}), static)
    assert hash(a) == hash(graphs._Held(({**qp}, {**qs}), static))
    assert a != graphs._Held((qp2, qs2), static)
    assert a != graphs._Held((qp, qs), (qc["decoder"], qc["rnn"], "LSTM"))
    keys = {graphs._args_key(_inputs(b))[0] for b in (1, 1, 64)}
    assert len(keys) == 2
    sg = StepGraphs()
    assert sg.key(_inputs(1), (qp, qs), static)[:2] == ("cpu", None)
    held = [sg._held(({"w": torch.zeros(i + 1)},), static)
            for i in range(graphs.MAX_GRAPHS + 2)]
    assert len(sg._consts) == graphs.MAX_GRAPHS and held[0].reason == "cpu"


def test_trees_rebuilt_and_cloned_in_kind():
    """The helper's tree functions keep dicts, lists, tuples and named
    tuples, and clone every tensor."""
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8

    t = [torch.ones(2) * i for i in range(4)]
    tree = {"a": [t[0], (t[1], PackedWeight8(t[2], t[3], t[0]))], "b": 3}
    leaves = graphs._leaves(tree)
    assert [id(x) for x in leaves] == [id(x) for x in (t[0], t[1], t[2],
                                                       t[3], t[0])]
    out = graphs._clone(tree)
    assert isinstance(out["a"][1][1], PackedWeight8) and out["b"] == 3
    for x, y in zip(graphs._leaves(out), leaves):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run on the card only")
    return torch.device("cuda")


def _launches() -> dict:
    return {f"{i}.{k}": n for i, c in enumerate(graphs._launch_counters())
            for k, n in c.items()}


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
def test_replay_equals_eager_on_the_card(cuda, batch):
    """At the serving widths (650 wide, 33,278 words, u8s-packed), 20
    chained replayed steps equal the eager step on the card bit for bit
    (log-probs, h, c); one capture, then replays; what a call returned
    stays as it was after the next call; each replay adds the launches of
    one eager step."""
    STEP_GRAPHS.clear()
    qp, qc, qs = _model("u8s", cuda, vocab=lstm_lm.VOCAB, nhid=650)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    tok, hidden = _inputs(batch, cuda, nhid=650)
    want_tok, want_hidden = tok, hidden
    before = _counts()
    prev = None
    for _ in range(20):
        logp, hidden, _ = fwd(qp, qs, tok, hidden)
        want, want_hidden, _ = lstm_lm.quantized_step(
            qp, qc, qs, want_tok, want_hidden, False)
        assert torch.equal(logp, want)
        for a, b in zip(hidden, want_hidden):
            assert torch.equal(a, b)
        if prev is not None:
            assert all(torch.equal(a, b) for a, b in zip(*prev))
        prev = ((logp, *hidden), tuple(t.clone() for t in (logp, *hidden)))
        tok = want_tok = logp.argmax(-1).reshape(1, -1)
    after = _counts()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 19
    l0 = _launches()
    lstm_lm.quantized_step(qp, qc, qs, tok, hidden, False)
    l1 = _launches()
    for _ in range(3):
        fwd(qp, qs, tok, hidden)
    assert _delta(_launches(), l1) == {
        k: 3 * n for k, n in _delta(l1, l0).items()}


@pytest.mark.cuda
def test_requests_and_conversions_share_graphs_by_key(cuda):
    """Two sampled requests on one model capture once and replay 99 + 100
    times; a second conversion of the same weights captures anew and
    never replays the first's graph, and gives the same tokens."""
    STEP_GRAPHS.clear()
    qp, qc, qs = _model("u8s", cuda, vocab=lstm_lm.VOCAB, nhid=650)
    before = _counts()
    first = sample_quantized(qp, qc, qs, lstm_lm.VOCAB, 100, seed=5)
    sample_quantized(qp, qc, qs, lstm_lm.VOCAB, 100, seed=6)
    after = _counts()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 199
    qp2, qc2, qs2 = _model("u8s", cuda, vocab=lstm_lm.VOCAB, nhid=650)
    again = sample_quantized(qp2, qc2, qs2, lstm_lm.VOCAB, 100, seed=5)
    last = _counts()
    assert last["captures"] - after["captures"] == 1
    assert last["replays"] - after["replays"] == 99
    assert again == first


# ------------------------------------------------ the DeepSeek-V3 decode step


class _Kept:
    """A recording context's store: each record point's (name, a copy of
    the value, rows), in the order the step calls ``record``."""

    def __init__(self):
        self.records = []

    def context(self, qcfg, qstate):
        from tq_tpu_torch.models import deepseek_v3 as dsv3

        kept = self.records

        class Recording(dsv3.Context):
            def record(self, name, value, rows):
                kept.append((name, value.clone(), rows))

        return Recording(qcfg, qstate)


def _dsv3_model(device):
    """The tiny DeepSeek-V3 of the model's tests, converted and 9-bit
    packed on ``device``: its expert layers take the grouped path on the
    card."""
    from test_torch_port_deepseek_v3 import SETTING, TINY, _model
    from tq_tpu_torch.models import deepseek_v3 as dsv3

    params = {n: {k: t.to(device) for k, t in p.items()}
              for n, p in _model().items()}
    return dsv3.convert(params, TINY, SETTING, pack_fmt="u8s")


@pytest.mark.cuda
def test_decode_replays_equal_the_eager_step_over_a_turn(cuda):
    """Two turns of 8 steps from one prefill, each step at its host
    position: the replayed step (one capture, then replays, no eager call
    under ``dsv3.decode``) equals the eager step (``_step`` on a second
    cache) bit for bit, in log-probabilities, in the records a recording
    context is handed (a replay's taken from the graph's own tensors) and
    in every cache entry it writes; the expert layers' counts of the
    replays equal the eager steps'."""
    from test_torch_port_deepseek_v3 import TINY, _tokens
    from tq_tpu_torch.layers import moe
    from tq_tpu_torch.models import deepseek_v3 as dsv3

    STEP_GRAPHS.clear()
    qp, qc, qs = _dsv3_model(cuda)
    B, T0, steps = 4, 6, 8
    tokens = _tokens(B, T0 + steps, seed=5).to(cuda)
    cache = dsv3.init_cache(TINY, B, T0 + steps, cuda)
    dsv3.prefill(qp, TINY, tokens[:, :T0], cache, qc, qs)
    eager_cache = cache.clone()
    kept, want_kept = _Kept(), _Kept()
    ctx = kept.context(qc, qs)
    before = _step_counts("dsv3.decode")
    counts = {}
    for turn in range(2):
        toks = tokens if not turn else torch.cat(
            [tokens[:, :T0], tokens[:, T0:].flip(1)], 1)
        for pos in range(T0, T0 + steps):
            if turn:
                moe.moe_apply.counts.clear()
            kept.records.clear()
            got = dsv3.decode_step(qp, TINY, toks[:, pos], pos, cache,
                                   ctx=ctx)
            got_counts = {k: dict(v) for k, v in
                          moe.moe_apply.counts.items()} if turn else None
            with torch.inference_mode():
                if turn:
                    moe.moe_apply.counts.clear()
                want, records = dsv3._step(
                    qp, TINY, toks[:, pos], dsv3._at(pos, eager_cache),
                    eager_cache, ctx)
            if turn:
                counts[pos] = (got_counts, {
                    k: dict(v) for k, v in moe.moe_apply.counts.items()})
            assert torch.equal(got, want), pos
            assert torch.equal(cache, eager_cache), pos
            assert [(n, r) for n, _, r in kept.records] == [
                (n, r) for n, _, r in records]
            for (_, a, _), (_, b, _) in zip(kept.records, records):
                assert torch.equal(a, b), pos
    after = _step_counts("dsv3.decode")
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 2 * steps - 1
    assert after["eager"] == before["eager"]
    for got_counts, want_counts in counts.values():
        assert got_counts == want_counts
        assert set(got_counts) == {"layers.1.mlp", "layers.2.mlp"}
        assert all(c["grouped"] == c["calls"] == 1
                   for c in got_counts.values())
    assert len(kept.records) == 3 * 3 + 2 + 1  # input, latent, output;
    # the experts selected in layers 1 and 2; the final hidden


@pytest.mark.cuda
def test_the_kimi_linear_step_stays_eager_on_the_card(cuda):
    """Kimi-Linear's decode step (its NoPE MLA layers through the shared
    absorbed attention) runs eagerly on the card: no step graph captures
    or replays, and no step counts a call."""
    from test_torch_port_deepseek_v3 import SETTING, _tokens
    from test_torch_port_kimi_linear import TINY as KIMI
    from test_torch_port_kimi_linear import _model as kimi_model
    from tq_tpu_torch.models import kimi_linear as kimi

    params = {n: {k: t.to(cuda) for k, t in p.items()}
              for n, p in kimi_model().items()}
    qp, qc, qs = kimi.convert(params, KIMI, SETTING, pack_fmt="u8s")
    tokens = _tokens(2, 5).to(cuda)
    cache = kimi.init_cache(KIMI, 2, 6, cuda)
    kimi.prefill(qp, KIMI, tokens[:, :4], cache, qc, qs)
    before = copy.deepcopy(STEP_GRAPHS.counts)
    out = kimi.decode_step(qp, KIMI, tokens[:, 4], 4, cache, qc, qs)
    assert torch.isfinite(out).all()
    assert STEP_GRAPHS.counts == before
