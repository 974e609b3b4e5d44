"""The port's DeepSeek-V3 model (``models/deepseek_v3.py``) and expert
layer (``layers/moe.py``) against the plain float32 reference
(``tests/reference_deepseek_v3.py``) on the CPU, at a tiny instance of
the same code: hidden 64, 4 heads (nope 16, rope 8, v 16), latent 32,
8 experts of width 32 with top 3 and 1 shared, 3 layers with the first
dense (width 96), vocabulary 211.

Tolerances: the port computes what the reference computes in another
order (the TR products scale after the sum, decode absorbs ``kv_b_proj``
and sums ``q·c + q_pe·k_pe`` in one product, the experts' outputs are
summed by ``index_add_``), float32 throughout: log-probabilities agree
to about 1e-6 here, and 2e-5 leaves room for the three layers.  Routing
is compared exactly: the same selections and weights to float32's
rounding.
"""

import pytest
import torch

import reference_deepseek_v3 as ref
from tq_tpu_torch.kernels.term_matmul import (PackedWeight8,
                                              unpack_weight_u8s)
from tq_tpu_torch.layers import moe
from tq_tpu_torch.models import deepseek_v3 as dsv3

TINY = {
    "hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
    "q_lora_rank": None, "intermediate_size": 96,
    "moe_intermediate_size": 32, "n_routed_experts": 8,
    "n_shared_experts": 1, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "num_hidden_layers": 3, "vocab_size": 211, "rms_norm_eps": 1e-5,
    "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": True, "initializer_range": 0.02,
}
# The catalog's Moonlight-16B-A3B (moonshotai/Moonlight-16B-A3B's
# config.json).
MOONLIGHT = {
    **TINY, "hidden_size": 2048, "num_attention_heads": 16,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "kv_lora_rank": 512, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "n_shared_experts": 2, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "vocab_size": 163840,
}
SETTING = (8, 8, 24, 8, 8)  # lstm650-tr's serving setting
ATOL = 2e-5


def _model(seed=0):
    params = dsv3.init(TINY, torch.Generator().manual_seed(seed))
    # A correction bias that moves selections (the published init leaves
    # it to the checkpoint).
    for name, p in params.items():
        if "bias" in p:
            p["bias"] = (torch.rand(p["bias"].shape,
                                    generator=torch.Generator().manual_seed(
                                        seed + 1)) - 0.5) * 0.02
    return params


def _weights(qparams, cfg=TINY):
    """The reference's flat weights from the port's (converted, packed or
    float) parameters: a packed linear decoded."""
    out = {}
    shapes = dsv3.param_shapes(cfg)
    for name, p in qparams.items():
        if name not in shapes:  # the grouped path's tables of the experts
            continue
        if "scale" in p:
            out[name] = p["scale"]
        elif "bias" in p:
            out[name], out[f"{name}.bias"] = p["w"], p["bias"]
        elif isinstance(p["w"], PackedWeight8):
            k = shapes[name]["w"][0]
            out[name] = unpack_weight_u8s(p["w"], k=k)
        else:
            out[name] = p["w"]
    return out


def _tokens(B, T, seed=3):
    return torch.randint(0, TINY["vocab_size"], (B, T),
                         generator=torch.Generator().manual_seed(seed))


def _served(kind):
    params = _model()
    if kind == "float":
        return params, None, None
    qp, qcfg, qstate = dsv3.convert(params, TINY, SETTING,
                                    pack_fmt="u8s" if kind == "packed"
                                    else None)
    return qp, qcfg, qstate


@pytest.mark.parametrize("kind", ["float", "converted", "packed"])
def test_prefill_logits_match_the_reference(kind):
    qp, qcfg, qstate = _served(kind)
    tokens = _tokens(3, 9)
    want = ref.forward(_weights(qp), TINY, tokens)
    if kind == "float":
        got = dsv3.apply(qp, TINY, tokens)
    else:
        got = dsv3.make_quantized_apply(TINY, qcfg)(qp, qstate, tokens)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    cache = dsv3.init_cache(TINY, 3, 12)
    last = dsv3.prefill(qp, TINY, tokens, cache, qcfg, qstate, chunk_rows=18)
    torch.testing.assert_close(last, want[:, -1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,turns", [("float", 1), ("packed", 1),
                                        ("packed", 2)],
                         ids=["float", "packed", "packed-second_turn"])
def test_decode_through_the_latent_cache_matches_the_full_forward(kind,
                                                                  turns):
    """Each turn's steps (positions 6 .. 10, each a device position that
    the attention reads the whole cache up to) equal the reference's and
    ``apply``'s rows.  A second turn goes back to position 6 with other
    tokens: its steps attend over the entries the first turn left after
    their position, masked."""
    qp, qcfg, qstate = _served(kind)
    tokens = _tokens(4, 11, seed=5)
    T0 = 6
    cache = dsv3.init_cache(TINY, 4, 16)
    first = dsv3.prefill(qp, TINY, tokens[:, :T0], cache, qcfg, qstate,
                         chunk_rows=T0)
    for turn in range(turns):
        if turn:
            tokens = torch.cat([tokens[:, :T0],
                                _tokens(4, 5, seed=5 + turn)], 1)
        want = ref.forward(_weights(qp), TINY, tokens)
        got = [first]
        for pos in range(T0, tokens.shape[1]):
            got.append(dsv3.decode_step(qp, TINY, tokens[:, pos], pos,
                                        cache, qcfg, qstate))
        got = torch.stack(got, 1)
        torch.testing.assert_close(got, want[:, T0 - 1:], atol=ATOL, rtol=0)
        rows = (dsv3.apply(qp, TINY, tokens) if kind == "float"
                else dsv3.make_quantized_apply(TINY, qcfg)(qp, qstate,
                                                           tokens))
        torch.testing.assert_close(got, rows[:, T0 - 1:], rtol=1e-5, atol=0)
    # The cache holds [c, k_pe] (32 + 8 floats a token a layer), written
    # in place; positions past the last step stay empty.
    assert cache.shape == (3, 4, 16, 40)
    assert not cache[:, :, tokens.shape[1]:].any()


@pytest.mark.parametrize("pos", [0, 9, 15])
def test_masked_attention_over_the_whole_cache_equals_the_first_entries(
        pos):
    """A layer at position ``pos`` reads all 16 entries of its cache, the
    ones after ``pos`` stale (a random earlier turn's), and gives what it
    gives over a cache cut to its first ``pos + 1`` entries; both write
    the same entry at ``pos``."""
    qp, qcfg, qstate = _served("packed")
    ctx = dsv3.Context(qcfg, qstate)
    gen = torch.Generator().manual_seed(17)
    stale = torch.randn(4, 16, 40, generator=gen)
    full, cut = stale.clone(), stale[:, :pos + 1].clone()
    x = torch.randn(4, 64, generator=gen)
    at = dsv3._at(pos, full[None])
    assert at.shape == () and int(at) == pos
    cos, sin = dsv3._rope_tables(TINY, at.reshape(1))
    out = [dsv3._layer_absorbed(qp, TINY, 1, x, dsv3._at(pos, c[None]), c,
                                cos[0], sin[0], ctx) for c in (full, cut)]
    torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=1e-7)
    assert torch.equal(full[:, :pos + 1], cut)
    assert not torch.equal(full[:, pos], stale[:, pos])
    assert torch.equal(full[:, pos + 1:], stale[:, pos + 1:])


def test_routing_matches_the_reference_and_the_bias_moves_only_selection():
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(40, 64, generator=gen)
    router = {"w": torch.randn(8, 64, generator=gen) * 0.1,
              "bias": torch.zeros(8)}
    scores = torch.sigmoid(x @ router["w"].T)
    # The bias lifts the lowest-scored expert of row 0 into its selection.
    low = int(scores[0].argmin())
    router["bias"][low] = 1.0
    idx, w = moe.route(x, router, 3, 2.446)
    w_ref = {"r.gate": router["w"], "r.gate.bias": router["bias"]}
    idx_ref, wt_ref = ref.gate(w_ref, {"num_experts_per_tok": 3,
                                       "routed_scaling_factor": 2.446}, "r",
                               x)
    order, order_ref = idx.sort(1), idx_ref.sort(1)
    assert torch.equal(order.values, order_ref.values)
    torch.testing.assert_close(w.gather(1, order.indices),
                               wt_ref.gather(1, order_ref.indices),
                               rtol=1e-6, atol=0)
    assert low in idx[0].tolist()
    # Its weight is its score, not its score plus the bias.
    chosen = scores[0, idx[0]]
    want = scores[0, low] / (chosen.sum() + 1e-20) * 2.446
    torch.testing.assert_close(w[0, idx[0].tolist().index(low)], want)


def test_an_expert_with_no_rows_and_the_shares_of_held_experts():
    params = _model(seed=7)
    pre = "layers.1.mlp"
    params[f"{pre}.gate"]["bias"][2] = -10.0  # expert 2 is never selected
    x = torch.randn(30, 64, generator=torch.Generator().manual_seed(8))
    ctx = dsv3.Context(None, None)

    def expert(e, rows):
        return dsv3._swiglu(ctx, params, f"{pre}.experts.{e}", rows)

    w = _weights(params)
    moe.moe_apply.counts.clear()
    y, idx = moe.moe_apply(x, params[f"{pre}.gate"], expert, 3, 2.446,
                           layer="probe")
    shared = ref.mlp(w, f"{pre}.shared_experts", x)
    torch.testing.assert_close(y + shared, ref.moe(w, TINY, pre, x),
                               atol=1e-6, rtol=0)
    assert 2 not in idx.unique().tolist()
    counts = moe.moe_apply.counts["probe"]
    loads = torch.bincount(idx.reshape(-1), minlength=8)
    assert counts["tokens"] == 90 and counts["calls"] == 1
    assert counts["max_load"] == int(loads.max())
    assert counts["stream"] + counts["mma"] == int((loads > 0).sum())
    assert counts["stream"] == int(((loads > 0) & (loads <= 8)).sum())
    # Two expert-parallel shares, the shared expert counted once, add up
    # to the whole layer.
    halves = [moe.moe_apply(x, params[f"{pre}.gate"], expert, 3, 2.446,
                            held=h)[0] for h in ([5, 0, 3, 1], [7, 2, 6, 4])]
    torch.testing.assert_close(halves[0] + halves[1] + shared,
                               ref.moe(w, TINY, pre, x), atol=1e-6, rtol=0)
    # Every expert held, listed out of order: the same sum.
    every = moe.moe_apply(x, params[f"{pre}.gate"], expert, 3, 2.446,
                          held=list(range(7, -1, -1)))[0]
    torch.testing.assert_close(every, y, atol=1e-6, rtol=0)


def test_every_linear_is_converted_and_packed_the_rest_stays_float32():
    params = _model()
    qp, qcfg, qstate = dsv3.convert(params, TINY, SETTING, pack_fmt="u8s")
    names = set(dsv3.linears(TINY))
    # 3 layers x 4 attention projections, 3 dense, 2 x (8 + 1) x 3 expert
    # products, lm_head.
    assert len(names) == 3 * 4 + 3 + 2 * 9 * 3 + 1
    assert set(qcfg) == names == set(qstate)
    grouped = {f"layers.{i}.mlp.experts" for i in (1, 2)}
    for name, p in qp.items():
        if name in names:
            assert isinstance(p["w"], PackedWeight8), name
            assert all(t.quantize_input is False for t in qcfg.values())
        elif name in grouped:
            # The grouped path's tables hold the experts' own packs.
            held = [*p.gate_up.packs, *p.down.packs]
            assert [len(ps) for ps in held] == [8, 8, 8]
            assert all(w is qp[f"{name}.{e}.{proj}_proj"]["w"]
                       for ps, proj in zip(held, ("gate", "up", "down"))
                       for e, w in enumerate(ps))
            assert p.gate_up.ptrs[1, 3, 0] == qp[
                f"{name}.3.up_proj"]["w"].lo.data_ptr()
        else:
            for key, t in p.items():
                assert t.dtype == torch.float32 and t is params[name][key]
    unconv, ucfg, _ = dsv3.convert(params, TINY, SETTING)
    packed = dsv3.pack(unconv, ucfg, TINY)
    assert grouped <= set(packed) and not grouped & set(unconv)
    for name in names:  # packing after conversion packs the same bytes
        assert all(torch.equal(a, b) for a, b in zip(packed[name]["w"],
                                                     qp[name]["w"]))
    kv_b = "layers.0.self_attn.kv_b_proj"
    assert torch.equal(unpack_weight_u8s(qp[kv_b]["w"], k=32),
                       unconv[kv_b]["w"])
    wk, wv = dsv3._absorbed({"w": unconv[kv_b]["w"]}, TINY)
    assert torch.equal(qp[kv_b]["wk"], wk) and torch.equal(qp[kv_b]["wv"],
                                                           wv)
    assert wk.shape == (4, 16, 32) and wv.shape == (4, 32, 16)


def test_the_published_configuration_has_15_96_billion_parameters():
    params = dsv3.init(MOONLIGHT, device="meta")
    total = sum(t.numel() for p in params.values() for t in p.values())
    assert round(total / 1e9, 2) == 15.96
    linear = sum(params[n]["w"].numel() for n in dsv3.linears(MOONLIGHT))
    experts = sum(params[n]["w"].numel() for n in dsv3.linears(MOONLIGHT)
                  if ".experts." in n)
    assert round(experts / 1e9, 1) == 14.4 and linear < total
    assert dsv3.cache_width(MOONLIGHT) * 4 == 2304
