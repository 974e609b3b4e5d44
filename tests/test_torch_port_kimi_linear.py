"""The port's Kimi-Linear model (``models/kimi_linear.py``, ``layers/
kda.py``) against the plain float32 reference
(``tests/reference_kimi_linear.py``) on the CPU, at a tiny instance of
the same code: 8 layers in the published pattern (KDA at 1-3 and 5-7,
NoPE MLA at 4 and 8, 1-indexed; the first dense), hidden 64, KDA 4 heads
of 16 with a kernel-4 convolution, MLA 4 heads (nope 16, rope 8, v 16,
latent 32), a router of 16 experts of width 32 with top 4 of which this
rank holds 4, 1 shared, vocabulary 211.

Tolerances: the port computes what the reference computes in another
order (KDA's chunked form against the token-by-token recurrence, its
decode step reading ``Sᵀ(exp(g)⊙k)`` where the reference decays S
first, the TR products scaling after the sum, MLA's absorbed decode),
float32 throughout.  The chunked form's state and outputs agree with the
recurrence to a few 1e-7 at unit-norm keys here (2e-6 leaves room for
the strongest decays' cancellations); log-probabilities agree to ~1e-6
over eight layers (2e-5 as the DeepSeek-V3 tests).  Restoring a snapshot
is a copy: decoding after it is compared bit for bit.
"""

import math

import pytest
import torch
import torch.nn.functional as F

import reference_kimi_linear as ref
from tq_tpu_torch.kernels.term_matmul import PackedWeight8, unpack_weight_u8s
from tq_tpu_torch.layers import kda, moe
from tq_tpu_torch.models import deepseek_v3 as dsv3
from tq_tpu_torch.models import kimi_linear as kimi
from tq_tpu_torch.utils import trace as ttrace

TINY = {
    "hidden_size": 64, "num_hidden_layers": 8, "vocab_size": 211,
    "rms_norm_eps": 1e-5, "initializer_range": 0.02,
    "linear_attn_config": {"full_attn_layers": [4, 8], "head_dim": 16,
                           "kda_layers": [1, 2, 3, 5, 6, 7],
                           "num_heads": 4, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
    "q_lora_rank": None, "rope_scaling": None, "rope_theta": 10000,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_experts": 4, "router_experts": 16, "num_experts_per_token": 4,
    "num_shared_experts": 1, "num_expert_group": 1, "topk_group": 1,
    "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
    "routed_scaling_factor": 2.446,
}
UNCUT = {**TINY, "num_experts": 16}
SETTING = (8, 8, 24, 8, 8)  # lstm650-tr's serving setting
ATOL = 2e-5
STATE_ATOL = 2e-6


def _model(cfg=TINY, seed=0):
    params = kimi.init(cfg, torch.Generator().manual_seed(seed))
    for name, p in params.items():
        if "bias" in p:  # a correction bias that moves selections
            p["bias"] = (torch.rand(p["bias"].shape,
                                    generator=torch.Generator().manual_seed(
                                        seed + 1)) - 0.5) * 0.02
    return params


def _weights(qparams, cfg=TINY):
    """The reference's flat weights from the port's parameters, a packed
    linear decoded."""
    out = {}
    shapes = kimi.param_shapes(cfg)
    for name, p in qparams.items():
        if name not in shapes:  # the grouped tables
            continue
        if "scale" in p:
            out[name] = p["scale"]
        elif "bias" in p:
            out[name], out[f"{name}.bias"] = p["w"], p["bias"]
        elif isinstance(p["w"], PackedWeight8):
            out[name] = unpack_weight_u8s(p["w"], k=shapes[name]["w"][0])
        else:
            out[name] = p["w"]
    return out


def _tokens(B, T, seed=3):
    return torch.randint(0, TINY["vocab_size"], (B, T),
                         generator=torch.Generator().manual_seed(seed))


def _served(kind, cfg=TINY):
    params = _model(cfg)
    if kind == "float":
        return params, None, None
    return kimi.convert(params, cfg, SETTING, pack_fmt="u8s")


def _sequences(T, strong, seed=0):
    gen = torch.Generator().manual_seed(seed)
    B, H, D = 2, 3, 16

    def rand(*s):
        return torch.randn(*s, generator=gen)

    q = F.normalize(rand(B, T, H, D), dim=-1) * D ** -0.5
    k = F.normalize(rand(B, T, H, D), dim=-1)
    # The strongest decays: A = exp(log 16) and softplus far past 1, so a
    # chunk of 64 sums g to ~-10^4 (exp(-G) overflows float32 long before).
    scale = 16 * F.softplus(3 * rand(B, T, H, D)) if strong else (
        0.05 * torch.rand(B, T, H, D, generator=gen))
    return q, k, rand(B, T, H, D), -scale, torch.rand(B, T, H, generator=gen)


@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strongest"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_prefill_equals_the_recurrence(chunk, strong):
    T = 100  # not a multiple of either chunk
    q, k, v, g, beta = _sequences(T, strong)
    want_o, want_s = ref.recurrence(q, k, v, g, beta)
    o, s = kda.chunked(q, k, v, g, beta, chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    torch.testing.assert_close(o, want_o, atol=STATE_ATOL, rtol=0)
    torch.testing.assert_close(s, want_s, atol=STATE_ATOL, rtol=0)
    # The decode step, token by token, from the same empty state.
    state = torch.zeros_like(want_s)
    steps = torch.stack([kda.recur_step(q[:, t], k[:, t], v[:, t], g[:, t],
                                        beta[:, t], state)
                         for t in range(T)], 1)
    torch.testing.assert_close(steps, want_o, atol=STATE_ATOL, rtol=0)
    torch.testing.assert_close(state, want_s, atol=STATE_ATOL, rtol=0)


def test_a_kda_layer_prefill_matches_the_reference_layer():
    params = _model()
    w = _weights(params)
    x = torch.randn(3, 21, 64, generator=torch.Generator().manual_seed(4))
    pre = "layers.1.self_attn"
    ctx = kimi.Context(None, None)
    want, want_state = ref.kda(w, TINY, pre, x)
    got, state, tail = kda.kda_prefill(ctx.dense, params, pre, x, 4, 1e-5)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(state, want_state, atol=STATE_ATOL, rtol=0)
    # The tail holds the last 3 projected inputs of q, k and v, by channel.
    qkv = torch.cat([x[:, -3:] @ w[f"{pre}.{n}_proj"] for n in "qkv"], -1)
    torch.testing.assert_close(tail, qkv.transpose(1, 2), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_then_decode_through_the_hybrid_cache_match_the_full_forward(
        kind):
    qp, qcfg, qstate = _served(kind)
    tokens = _tokens(4, 23, seed=5)
    states = {}
    want = ref.forward(_weights(qp), TINY, tokens[:, :17], states)
    want = torch.cat([want, ref.forward(_weights(qp), TINY,
                                        tokens)[:, 17:]], 1)
    T0 = 17  # prefill in KDA chunks of 16: one whole and one partial
    cache = kimi.init_cache(TINY, 4, 24)
    got = [kimi.prefill(qp, TINY, tokens[:, :T0], cache, qcfg, qstate,
                        chunk_rows=2 * T0)]
    assert cache.counts["prefill_chunks"] == 2
    for i, st in states.items():  # the prefill's KDA state, layer by layer
        torch.testing.assert_close(cache.state[cache.slots[i]], st,
                                   atol=STATE_ATOL, rtol=0)
    for pos in range(T0, tokens.shape[1]):
        got.append(kimi.decode_step(qp, TINY, tokens[:, pos], pos, cache,
                                    qcfg, qstate))
    torch.testing.assert_close(torch.stack(got, 1), want[:, T0 - 1:],
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(kimi.apply(qp, TINY, tokens, qcfg, qstate),
                               want, atol=ATOL, rtol=0)
    # Two MLA layers' latent (32 + 8 floats a token), six KDA layers'
    # state (4 heads of 16 x 16) and tails (3 x 64 channels, 3 inputs).
    assert cache.latent.shape == (2, 4, 24, 40)
    assert cache.state.shape == (6, 4, 4, 16, 16)
    assert cache.conv.shape == (6, 4, 192, 3)
    assert not cache.latent[:, :, tokens.shape[1]:].any()


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_the_four_shares_sum_to_the_uncut_expert_layer(kind):
    """Four expert-parallel ranks of 4 of the 16 experts: their layers'
    outputs, the shared expert counted once, add up to the uncut
    reference layer."""
    params = _model(UNCUT, seed=9)
    if kind == "packed":
        params, qcfg, qstate = kimi.convert(params, UNCUT, SETTING,
                                            pack_fmt="u8s")
    else:
        qcfg = qstate = None
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(10))
    i, pre = 2, "layers.2.mlp"
    w = _weights(params, UNCUT)
    want = ref.ffn(w, UNCUT, i, x)
    shared = ref.mlp(w, f"{pre}.shared_experts", x)
    total = -3 * shared
    for rank in range(4):
        cfg = {**TINY, "ep_rank": rank}
        names = set(kimi.param_shapes(cfg))
        assert sum(n.endswith(".gate_proj") and ".experts." in n
                   and n.startswith(pre) for n in names) == 4
        share = {n: p for n, p in params.items() if n in names}
        ctx = kimi.Context(qcfg, qstate)
        total = total + dsv3._ffn(share, kimi.shared_cfg(cfg), i, x, ctx,
                                  slice(None), (40,))
    torch.testing.assert_close(total, want, atol=1e-5, rtol=0)


def test_restore_then_decode_equals_decoding_straight_after_the_prefill():
    qp, qcfg, qstate = _served("packed")
    tokens = _tokens(3, 12, seed=6)
    cache = kimi.init_cache(TINY, 3, 16)
    kimi.prefill(qp, TINY, tokens, cache, qcfg, qstate)
    snap = kimi.snapshot(cache)

    def turn(first):
        tok, out = first, []
        for pos in range(12, 15):
            logp = kimi.decode_step(qp, TINY, tok, pos, cache, qcfg, qstate)
            out.append(logp)
            tok = logp.argmax(-1)
        return torch.stack(out)

    first = _tokens(3, 1, seed=8)[:, 0]
    straight = turn(first)
    moved = cache.state.clone()
    turn(_tokens(3, 1, seed=9)[:, 0])  # another turn from the same point
    kimi.restore(cache, snap)
    assert torch.equal(cache.state, snap.state)
    assert torch.equal(cache.conv, snap.conv)
    assert not torch.equal(moved, snap.state)
    assert torch.equal(turn(first), straight)
    nbytes = 4 * (snap.state.numel() + snap.conv.numel())
    assert cache.counts == {"snapshots": 1, "restores": 1,
                            "bytes_restored": nbytes, "prefill_chunks": 1}


def test_spans_record_prefill_step_recurrence_and_restore():
    from torch.profiler import ProfilerActivity, profile

    params = _model()
    cache = kimi.init_cache(TINY, 2, 8)
    tokens = _tokens(2, 5)
    ttrace.clear()
    moe.moe_apply.counts.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        kimi.prefill(params, TINY, tokens, cache, chunk_rows=5)
        snap = kimi.snapshot(cache)
        kimi.decode_step(params, TINY, tokens[:, 0], 5, cache)
        kimi.restore(cache, snap)
    names = [r.name for r in ttrace.records()]
    ttrace.clear()
    # Two prefill chunks of one sequence and one step: 6 KDA and 2 MLA
    # layers each, 7 expert layers.
    assert names.count("tq.kimi.prefill") == names.count("tq.kimi.step") == 1
    assert names.count("tq.kda.recur") == 3 * 6
    assert names.count("tq.mla.attend") == 3 * 2
    assert names.count("tq.moe.experts") == 3 * 7
    assert names.count("tq.kimi.restore") == 1
    assert moe.moe_apply.counts["layers.1.mlp"]["calls"] == 3


def test_every_linear_is_converted_the_grouped_table_covers_every_id():
    params = _model()
    qp, qcfg, _ = kimi.convert(params, TINY, SETTING, pack_fmt="u8s")
    names = set(kimi.linears(TINY))
    # 6 KDA layers x 9 products, 2 MLA x 4, 3 dense, 7 expert layers x
    # (4 held + 1 shared) x 3, lm_head.
    assert len(names) == 6 * 9 + 2 * 4 + 3 + 7 * 5 * 3 + 1
    assert names == set(qcfg)
    assert all(isinstance(qp[n]["w"], PackedWeight8) for n in names)
    for kept in ("A_log", "dt_bias", "q_conv1d", "o_norm"):
        p = qp[f"layers.0.self_attn.{kept}"]
        assert all(t is params[f"layers.0.self_attn.{kept}"][k]
                   for k, t in p.items())
    table = qp["layers.3.mlp.experts"]
    assert [p is not None for p in table.gate_up.packs[0]] == [
        e < 4 for e in range(16)]
    assert table.gate_up.stored == table.down.stored == tuple(range(4))
    assert not table.down.ptrs[0, 4:].any()


def test_the_published_configuration():
    """Kimi-Linear-48B-A3B (moonshotai/Kimi-Linear-48B-A3B-Instruct's
    config.json): 49.1 B parameters, 47.1 B of them in the routed
    experts; rank 0 of 4 holds 64 of the 256, 13.4 B in its linears."""
    cfg = {**TINY, "hidden_size": 2304, "num_hidden_layers": 27,
           "vocab_size": 163840, "intermediate_size": 9216,
           "moe_intermediate_size": 1024, "num_attention_heads": 32,
           "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
           "v_head_dim": 128, "kv_lora_rank": 512,
           "num_experts": 256, "router_experts": 256,
           "num_experts_per_token": 8,
           "linear_attn_config": {
               "full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
               "head_dim": 128, "num_heads": 32, "short_conv_kernel_size": 4,
               "kda_layers": [i for i in range(1, 27) if i % 4]}}
    assert kimi.kinds(cfg).count("kda") == 20
    assert [i for i, k in enumerate(kimi.kinds(cfg)) if k == "mla"] == [
        3, 7, 11, 15, 19, 23, 26]
    def count(cfg):
        return sum(math.prod(shape) for keys in kimi.param_shapes(cfg).values()
                   for shape in keys.values())

    total = count(cfg)
    routed = 26 * 256 * 3 * 2304 * 1024
    assert round(total / 1e9, 1) == 49.1 and round(routed / 1e9, 1) == 47.1
    rank0 = {**cfg, "num_experts": 64}
    assert count(rank0) == total - routed * 3 // 4
    shapes = kimi.param_shapes(rank0)
    packed = sum(math.prod(shapes[n]["w"]) for n in kimi.linears(rank0))
    assert round(packed / 1e9, 1) == 13.4  # TR-packed on the card
