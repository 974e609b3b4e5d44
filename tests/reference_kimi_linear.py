"""Kimi-Linear's forward (``KimiLinearForCausalLM``, ``model_type:
kimi_linear``) in plain float32 PyTorch, from given weights, for the CPU
tests of ``tq_tpu_torch.models.kimi_linear``.

Imports nothing of ``tq_tpu`` or ``tq_tpu_torch``; it takes DeepSeek-V3's
``rms_norm`` and ``mlp`` from ``reference_deepseek_v3``.  Weights are a
flat dict keyed by module names without ``model.`` (the port's names),
linears stored (in, out), the convolutions (P, K), ``A_log`` (H,),
``dt_bias`` (P,).  No kernel, cache or batching trick: KDA runs its
recurrence token by token, MLA attends with keys and values expanded.

KDA, per token: ``q, k, v = SiLU(conv(x W_q)), ...`` (a causal depthwise
convolution of kernel K, zeros before the first token); per head ``q ←
l2norm(q)·D^-0.5``, ``k ← l2norm(k)``; ``g = −exp(A_log)·softplus(f_b(f_a
x) + dt_bias)``; ``β = sigmoid(b x)``; ``S' = Diag(exp g) S``, ``S = S' +
β k (v − S'ᵀk)ᵀ``, ``o = Sᵀq``; ``o ← RMSNorm(o)·w·sigmoid(g_b(g_a x))``;
``o_proj``.  MLA with ``mla_use_nope``: DeepSeek-V3's latent attention
with ``q_pe`` and ``k_pe`` left unturned.

Departures from the published code: float32 throughout, where the
published kernels (``fla``'s ``chunk_kda``, ``fused_kda_gate``,
``FusedRMSNormGated``) compute in bfloat16 with float32 state; the KDA
recurrence one token at a time where the published prefill is chunked;
the expert layer loops over the experts given (an expert-parallel
rank's share when ``w`` holds only some), each on the rows that
selected it; ``noaux_tc``'s group step left out (one group keeps every
expert); no dropout.  The output is the log-softmax of the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference_deepseek_v3 import mlp, rms_norm


def _dims(cfg):
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]


def conv(x, w):
    """Causal depthwise convolution of (B, T, C) with (C, K), zeros
    before the first input."""
    T, K = x.shape[1], w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, j:j + T] * w[:, j] for j in range(K))


def l2norm(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def recurrence(q, k, v, g, beta, state=None):
    """The delta rule with per-channel decay, token by token: q, k, g (B,
    T, H, D), v (B, T, H, Dv), beta (B, T, H); ``state`` (B, H, D, Dv) or
    zeros.  (o (B, T, H, Dv), the final state)."""
    B, T, H, D = k.shape
    S = (torch.zeros(B, H, D, v.shape[-1], device=k.device)
         if state is None else state)
    out = []
    for t in range(T):
        S = torch.exp(g[:, t])[..., None] * S
        u = torch.einsum("bhkv,bhk->bhv", S, k[:, t])
        S = S + beta[:, t, :, None, None] * (
            k[:, t, :, :, None] * (v[:, t] - u)[:, :, None, :])
        out.append(torch.einsum("bhkv,bhk->bhv", S, q[:, t]))
    return torch.stack(out, 1), S


def kda(w, cfg, pre, x):
    """``KimiDeltaAttention`` on (B, T, d) from an empty state:
    (output, final state)."""
    B, T, _ = x.shape
    H, D, _ = _dims(cfg)

    def heads(t):
        return t.view(B, T, H, -1)

    q = heads(F.silu(conv(x @ w[f"{pre}.q_proj"], w[f"{pre}.q_conv1d"])))
    k = heads(F.silu(conv(x @ w[f"{pre}.k_proj"], w[f"{pre}.k_conv1d"])))
    v = heads(F.silu(conv(x @ w[f"{pre}.v_proj"], w[f"{pre}.v_conv1d"])))
    q, k = l2norm(q) * D ** -0.5, l2norm(k)
    f = x @ w[f"{pre}.f_a_proj"] @ w[f"{pre}.f_b_proj"]
    g = -torch.exp(w[f"{pre}.A_log"])[:, None] * F.softplus(
        heads(f + w[f"{pre}.dt_bias"]))
    beta = torch.sigmoid(x @ w[f"{pre}.b_proj"])
    o, state = recurrence(q, k, v, g, beta)
    gate = heads(x @ w[f"{pre}.g_a_proj"] @ w[f"{pre}.g_b_proj"])
    o = rms_norm(o, w[f"{pre}.o_norm"], cfg["rms_norm_eps"]) * torch.sigmoid(
        gate)
    return o.reshape(B, T, H * D) @ w[f"{pre}.o_proj"], state


def mla(w, cfg, pre, x):
    """``KimiMLAAttention`` with ``mla_use_nope`` (no q-LoRA), causal, on
    (B, T, d)."""
    B, T, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v_dim, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ w[f"{pre}.q_proj"]).view(B, T, H, nope + rope).transpose(1, 2)
    compressed = x @ w[f"{pre}.kv_a_proj_with_mqa"]
    compressed, k_pe = torch.split(compressed, [rank, rope], dim=-1)
    kv = (rms_norm(compressed, w[f"{pre}.kv_a_layernorm"],
                   cfg["rms_norm_eps"]) @ w[f"{pre}.kv_b_proj"])
    kv = kv.view(B, T, H, nope + v_dim).transpose(1, 2)
    k_nope, value = torch.split(kv, [nope, v_dim], dim=-1)
    key = torch.cat([k_nope, k_pe[:, None].expand(B, H, T, rope)], dim=-1)
    scores = q @ key.transpose(2, 3) * (nope + rope) ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ value
    return out.transpose(1, 2).reshape(B, T, H * v_dim) @ w[f"{pre}.o_proj"]


def moe(w, cfg, pre, x):
    """``KimiSparseMoeBlock`` on (N, d): the selected experts' weighted
    sum over the experts ``w`` holds, plus the shared expert."""
    scores = torch.sigmoid(x @ w[f"{pre}.gate"].T)
    idx = torch.topk(scores + w[f"{pre}.gate.bias"],
                     k=cfg["num_experts_per_token"], dim=-1,
                     sorted=False)[1]
    weight = scores.gather(1, idx)
    weight = (weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
              * cfg["routed_scaling_factor"])
    y = torch.zeros_like(x)
    for e in range(w[f"{pre}.gate"].shape[0]):
        if f"{pre}.experts.{e}.gate_proj" not in w:
            continue
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y[rows] += weight[rows, slot, None] * mlp(
                w, f"{pre}.experts.{e}", x[rows])
    return y + mlp(w, f"{pre}.shared_experts", x)


def is_kda(cfg, i):
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def is_moe(cfg, i):
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def ffn(w, cfg, i, x):
    """Layer ``i``'s FFN on (N, d)."""
    pre = f"layers.{i}.mlp"
    return moe(w, cfg, pre, x) if is_moe(cfg, i) else mlp(w, pre, x)


def forward(w, cfg, tokens, states: dict | None = None):
    """(B, T) tokens -> (B, T, vocab) log-probabilities; ``states``, where
    given, receives each KDA layer's final state by layer."""
    B, T = tokens.shape
    eps = cfg["rms_norm_eps"]
    h = w["embed_tokens"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}"
        a = rms_norm(h, w[f"{pre}.input_layernorm"], eps)
        if is_kda(cfg, i):
            att, state = kda(w, cfg, f"{pre}.self_attn", a)
            if states is not None:
                states[i] = state
        else:
            att = mla(w, cfg, f"{pre}.self_attn", a)
        h = h + att
        x = rms_norm(h, w[f"{pre}.post_attention_layernorm"], eps)
        h = h + ffn(w, cfg, i, x.reshape(B * T, -1)).reshape(B, T, -1)
    logits = rms_norm(h, w["norm"], eps) @ w["lm_head"]
    return torch.log_softmax(logits, dim=-1)
