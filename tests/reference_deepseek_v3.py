"""DeepSeek-V3's forward (``DeepseekV3ForCausalLM`` of the published
``modeling_deepseek.py``) in plain float32 PyTorch, from given weights, for
the CPU tests of ``tq_tpu_torch.models.deepseek_v3``.

Imports nothing of ``tq_tpu`` or ``tq_tpu_torch``.  Weights are a flat
dict keyed by the published module names without ``model.``, linears
stored (in, out) (``x @ w`` is the published ``F.linear(x, w.T)``).  No
kernel, cache or batching trick: every position of every sequence is
computed from the whole prefix, keys and values expanded.

Departures from the published code: the expert layer loops over experts,
each taking the rows that selected it (the published inference path sorts
the rows by expert: the same sum, in another order); ``noaux_tc``'s group
step is left out, which with ``n_group = topk_group`` (one group here)
keeps every expert; no dropout, no q-LoRA, no RoPE scaling.  The output
is the log-softmax of the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return scale * (x * torch.rsqrt(variance + eps))


def rotary(cfg, seq_len, device=None):
    """``DeepseekV3RotaryEmbedding``: cos, sin (seq_len, rope)."""
    dim = cfg["qk_rope_head_dim"]
    inv_freq = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, dim, 2, device=device).float() / dim))
    t = torch.arange(seq_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x):
    x1 = x[..., :x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x, cos, sin):
    """``apply_rotary_pos_emb`` on (b, h, s, d): the interleaved pairs
    regrouped as halves, then rotated."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return (x * cos) + (rotate_half(x) * sin)


def attention(w, cfg, pre, x):
    """``DeepseekV3Attention`` (no q-LoRA), causal, on (B, T, d)."""
    B, T, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v_dim, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ w[f"{pre}.q_proj"]).view(B, T, H, nope + rope).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    compressed = x @ w[f"{pre}.kv_a_proj_with_mqa"]
    compressed, k_pe = torch.split(compressed, [rank, rope], dim=-1)
    k_pe = k_pe.view(B, T, 1, rope).transpose(1, 2)
    kv = (rms_norm(compressed, w[f"{pre}.kv_a_layernorm"],
                   cfg["rms_norm_eps"]) @ w[f"{pre}.kv_b_proj"])
    kv = kv.view(B, T, H, nope + v_dim).transpose(1, 2)
    k_nope, value = torch.split(kv, [nope, v_dim], dim=-1)
    cos, sin = rotary(cfg, T, x.device)
    q_pe = apply_rotary(q_pe, cos, sin)
    k_pe = apply_rotary(k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(B, H, T, rope)], dim=-1)
    scores = query @ key.transpose(2, 3) * (nope + rope) ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ value
    return out.transpose(1, 2).reshape(B, T, H * v_dim) @ w[f"{pre}.o_proj"]


def mlp(w, pre, x):
    """``DeepseekV3MLP``: down(silu(gate(x)) * up(x))."""
    return (F.silu(x @ w[f"{pre}.gate_proj"])
            * (x @ w[f"{pre}.up_proj"])) @ w[f"{pre}.down_proj"]


def gate(w, cfg, pre, x):
    """``MoEGate`` (sigmoid, ``noaux_tc``): (selected (N, k), weights (N,
    k)) of the rows ``x`` (N, d)."""
    scores = torch.sigmoid(x @ w[f"{pre}.gate"].T)
    choice = scores + w[f"{pre}.gate.bias"]
    idx = torch.topk(choice, k=cfg["num_experts_per_tok"], dim=-1,
                     sorted=False)[1]
    weight = scores.gather(1, idx)
    if cfg.get("norm_topk_prob", True):
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, weight * cfg["routed_scaling_factor"]


def moe(w, cfg, pre, x):
    """``DeepseekV3MoE`` on (N, d): the selected experts' weighted sum
    plus the shared experts."""
    idx, weight = gate(w, cfg, pre, x)
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y[rows] += weight[rows, slot, None] * mlp(
                w, f"{pre}.experts.{e}", x[rows])
    return y + mlp(w, f"{pre}.shared_experts", x)


def is_moe(cfg, i):
    return (cfg["n_routed_experts"] > 0 and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def forward(w, cfg, tokens):
    """(B, T) tokens -> (B, T, vocab) log-probabilities.  ``w``: name ->
    tensor (a linear's (in, out) weight, a norm's scale, the router's
    (E, d) weight; the correction bias under ``<router>.bias``)."""
    B, T = tokens.shape
    eps = cfg["rms_norm_eps"]
    h = w["embed_tokens"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}"
        h = h + attention(w, cfg, f"{pre}.self_attn",
                          rms_norm(h, w[f"{pre}.input_layernorm"], eps))
        x = rms_norm(h, w[f"{pre}.post_attention_layernorm"], eps)
        if is_moe(cfg, i):
            f = moe(w, cfg, f"{pre}.mlp", x.reshape(B * T, -1))
        else:
            f = mlp(w, f"{pre}.mlp", x.reshape(B * T, -1))
        h = h + f.reshape(B, T, -1)
    logits = rms_norm(h, w["norm"], eps) @ w["lm_head"]
    return torch.log_softmax(logits, dim=-1)
