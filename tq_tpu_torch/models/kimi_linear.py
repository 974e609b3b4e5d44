"""Kimi-Linear language model (``model_type: kimi_linear``;
Kimi-Linear-48B-A3B): Kimi Delta Attention layers beside NoPE latent
attention, a dense SwiGLU first, then routed and shared experts.

Shapes come from the published configuration's keys: ``hidden_size``,
``num_hidden_layers``, ``vocab_size``, ``rms_norm_eps``,
``linear_attn_config`` (``num_heads``, ``head_dim``,
``short_conv_kernel_size``, and the 1-indexed ``kda_layers`` and
``full_attn_layers``), the MLA keys (``num_attention_heads``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``kv_lora_rank``, ``mla_use_nope``) and the expert keys
(``num_experts``, ``num_experts_per_token``, ``num_shared_experts``,
``moe_intermediate_size``, ``intermediate_size``,
``first_k_dense_replace``, ``moe_layer_freq``, ``routed_scaling_factor``,
``moe_renormalize``, ``moe_router_activation_func``,
``num_expert_group``, ``topk_group``).  An expert-parallel rank's share
adds two keys: ``router_experts`` (the router's outputs, where
``num_experts`` counts the experts held here) and ``ep_rank``
(:func:`shared_cfg` maps them, with the rest, to what
``models/deepseek_v3.py`` reads).

A layer is ``h = x + Attn(RMSNorm(x))``, ``x' = h + FFN(RMSNorm(h))``;
the end is RMSNorm, ``lm_head`` and log-softmax.  Attn is KDA
(``layers/kda.py``) in the ``kda_layers`` and DeepSeek-V3's latent
attention without rotation in the ``full_attn_layers``; the FFN is
DeepSeek-V3's: the dense SwiGLU first, then the expert layer
(``layers/moe.py``: sigmoid scores plus the correction bias select the
top ``num_experts_per_token``, renormalised and scaled, over the held
experts, plus the shared expert).  The MLA, the router, the expert
layer, the norm and the head are ``models/deepseek_v3.py``'s own code.
Parameters are keyed as there (``layers.{i}.self_attn.*``,
``layers.{i}.mlp.*``, linears (in, out)); a KDA module's are the
published module's (``q_proj``, ``k_proj``, ``v_proj``, ``q_conv1d``,
``k_conv1d``, ``v_conv1d`` (P, K), ``A_log`` (H,), ``f_a_proj``,
``f_b_proj``, ``dt_bias`` (P,), ``b_proj``, ``g_a_proj``, ``g_b_proj``,
``o_norm``, ``o_proj``).

Two kinds of state live in one :class:`HybridCache`: MLA's latent
entries (``[c, k_pe]`` a position) for the MLA layers, and KDA's
recurrent state (H, D, D) and convolution tail (3P, K - 1) a session for
the KDA layers.  :func:`prefill` writes both (KDA in its chunked form),
:func:`decode_step` moves both on by one token.  A recurrent state
cannot be rewound by resetting a position, so a turn that is retried or
a session that is resumed restores it: :func:`snapshot` copies the KDA
state and tails on the device, :func:`restore` copies them back in
place; the latent needs only the caller's position.  ``cache.counts``
(always on) counts snapshots, restores, bytes restored and prefill
chunks.

TR conversion (:func:`convert`) converts every ``nn.Linear`` of the
published model: KDA's q, k, v, o and its low-rank f, g and b pairs,
MLA's four, every held and shared expert, the dense SwiGLU and
``lm_head``.  The router, the convolution weights, ``A_log``,
``dt_bias``, the norms and the embedding stay float32.

Spans (``utils/trace.py``): ``tq.kimi.prefill``, ``tq.kimi.step``,
``tq.kimi.restore`` (device), KDA's ``tq.kda.recur`` (device), and the
shared code's ``tq.mla.attend``, ``tq.moe.route`` and ``tq.moe.experts``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

from tq_tpu_torch.layers.kda import kda_prefill, kda_step
from tq_tpu_torch.models import deepseek_v3 as dsv3
from tq_tpu_torch.models.deepseek_v3 import (_at, _ffn, _head,
                                             _layer_absorbed,
                                             _layer_expanded, _rms_norm)
from tq_tpu_torch.utils.trace import span

__all__ = ["Context", "HybridCache", "Snapshot", "shared_cfg", "kinds",
           "param_shapes", "linears", "init", "convert", "pack", "apply",
           "init_cache", "prefill", "decode_step", "snapshot", "restore"]


# DeepSeek-V3's context: ``record(name, value, rows)`` sees
# ``layers.{i}.input`` and ``.output``, an MLA layer's ``layers.{i}.latent``
# (the entries it wrote), an expert layer's ``layers.{i}.mlp.gate`` and
# ``norm``; a KDA layer's state and tail are the cache's (read them there).
Context = dsv3.Context


def shared_cfg(cfg) -> dict:
    """The configuration as ``models/deepseek_v3.py`` reads it: Kimi's
    expert keys under DeepSeek-V3's names, the router's outputs
    (``router_experts``, else ``num_experts``) and this rank's share."""
    if not cfg.get("moe_renormalize", True):
        raise NotImplementedError("only renormalised expert weights")
    if cfg.get("moe_router_activation_func", "sigmoid") != "sigmoid":
        raise NotImplementedError("only sigmoid router scores")
    return {**cfg,
            "n_routed_experts": cfg.get("router_experts", cfg["num_experts"]),
            "n_held_experts": cfg["num_experts"],
            "ep_rank": cfg.get("ep_rank", 0),
            "num_experts_per_tok": cfg["num_experts_per_token"],
            "n_shared_experts": cfg["num_shared_experts"],
            "n_group": cfg.get("num_expert_group", 1),
            "scoring_func": "sigmoid"}


def kinds(cfg) -> list[str]:
    """Each layer's attention, ``"kda"`` or ``"mla"``, from the
    1-indexed lists of ``linear_attn_config``."""
    lin = cfg["linear_attn_config"]
    kda, mla = set(lin["kda_layers"]), set(lin["full_attn_layers"])
    out = []
    for i in range(1, cfg["num_hidden_layers"] + 1):
        if (i in kda) == (i in mla):
            where = "both" if i in kda else "neither"
            raise ValueError(f"layer {i} is in {where} of kda_layers and "
                             "full_attn_layers")
        out.append("kda" if i in kda else "mla")
    return out


def _kda_dims(cfg):
    """(H, D, P = H·D, K) of the KDA layers."""
    lin = cfg["linear_attn_config"]
    H, D = lin["num_heads"], lin["head_dim"]
    return H, D, H * D, lin["short_conv_kernel_size"]


def _kda_shapes(cfg, pre: str) -> dict:
    d = cfg["hidden_size"]
    H, D, P, K = _kda_dims(cfg)
    return {f"{pre}.q_proj": {"w": (d, P)}, f"{pre}.k_proj": {"w": (d, P)},
            f"{pre}.v_proj": {"w": (d, P)},
            f"{pre}.q_conv1d": {"w": (P, K)},
            f"{pre}.k_conv1d": {"w": (P, K)},
            f"{pre}.v_conv1d": {"w": (P, K)},
            f"{pre}.A_log": {"w": (H,)},
            f"{pre}.f_a_proj": {"w": (d, D)},
            f"{pre}.f_b_proj": {"w": (D, P)},
            f"{pre}.dt_bias": {"w": (P,)},
            f"{pre}.b_proj": {"w": (d, H)},
            f"{pre}.g_a_proj": {"w": (d, D)},
            f"{pre}.g_b_proj": {"w": (D, P)},
            f"{pre}.o_norm": {"scale": (D,)},
            f"{pre}.o_proj": {"w": (P, d)}}


def param_shapes(cfg) -> dict:
    """name -> {key: shape} of every parameter, in the forward's order."""
    scfg = shared_cfg(cfg)
    d = cfg["hidden_size"]
    out = {"embed_tokens": {"w": (cfg["vocab_size"], d)}}
    for i, kind in enumerate(kinds(cfg)):
        pre = f"layers.{i}"
        out[f"{pre}.input_layernorm"] = {"scale": (d,)}
        out.update(_kda_shapes(cfg, f"{pre}.self_attn") if kind == "kda"
                   else dsv3.attention_shapes(scfg, f"{pre}.self_attn"))
        out[f"{pre}.post_attention_layernorm"] = {"scale": (d,)}
        out.update(dsv3.ffn_shapes(scfg, i))
    out["norm"] = {"scale": (d,)}
    out["lm_head"] = {"w": (d, cfg["vocab_size"])}
    return out


def linears(cfg) -> list[str]:
    """The names of every ``nn.Linear`` of the published model (the held
    experts')."""
    return dsv3.linears(shared_cfg(cfg), param_shapes(cfg))


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Weights, the router, the convolutions and the embedding N(0,
    ``initializer_range``) (0.02 where the configuration omits it),
    ``A_log`` = log U(1, 16), ``dt_bias`` = softplus⁻¹ of U(0.001, 0.1),
    norms at 1, the correction bias 0."""
    std = cfg.get("initializer_range", 0.02)
    params = {}
    for name, keys in param_shapes(cfg).items():
        p = {}
        for key, shape in keys.items():
            if key == "scale":
                p[key] = torch.ones(shape, device=device)
            elif key == "bias":
                p[key] = torch.zeros(shape, device=device)
            elif name.endswith(".A_log"):
                p[key] = torch.log(1 + 15 * torch.rand(
                    shape, generator=generator, device=device))
            elif name.endswith(".dt_bias"):
                u = 0.001 + 0.099 * torch.rand(shape, generator=generator,
                                               device=device)
                p[key] = u + torch.log(-torch.expm1(-u))
            else:
                p[key] = torch.randn(shape, generator=generator,
                                     device=device) * std
        params[name] = p
    return params


def convert(params: Mapping, cfg, setting, quantize_input: bool = False,
            pack_fmt: str | None = None):
    """TR-convert every ``nn.Linear`` (:func:`linears`) at ``setting``,
    reading ``params`` one name at a time
    (:func:`~tq_tpu_torch.models.deepseek_v3.convert`): (qparams, qcfg,
    qstate)."""
    return dsv3.convert(params, shared_cfg(cfg), setting, quantize_input,
                        pack_fmt, shapes=param_shapes(cfg))


def pack(qparams, qcfg, cfg, fmt: str = "u8s") -> dict:
    """Serving transform (:func:`~tq_tpu_torch.models.deepseek_v3.pack`):
    every converted linear packed, ``kv_b_proj``'s heads decoded, the
    expert layers' grouped tables."""
    return dsv3.pack(qparams, qcfg, shared_cfg(cfg), fmt)


# ------------------------------------------------------------------ cache


@dataclasses.dataclass
class HybridCache:
    """Both kinds of a batch's state: ``latent`` (MLA layers, B, L, rank +
    rope), ``state`` (KDA layers, B, H, D, D) and ``conv`` (KDA layers, B,
    3P, K - 1), float32; ``slots[i]``: layer i's index in ``latent`` or in
    ``state`` and ``conv``; ``counts``: snapshots, restores,
    bytes_restored, prefill_chunks."""

    latent: torch.Tensor
    state: torch.Tensor
    conv: torch.Tensor
    slots: tuple
    counts: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        ("snapshots", "restores", "bytes_restored", "prefill_chunks"), 0))


class Snapshot(NamedTuple):
    """A copy of a :class:`HybridCache`'s KDA state and tails."""

    state: torch.Tensor
    conv: torch.Tensor


def init_cache(cfg, batch: int, length: int, device=None) -> HybridCache:
    """An empty cache of ``batch`` sessions: latent positions 0 ..
    ``length`` - 1 for each MLA layer, zero state and tails for each KDA
    layer."""
    ks = kinds(cfg)
    H, D, P, K = _kda_dims(cfg)
    slots, seen = [], {"kda": 0, "mla": 0}
    for kind in ks:
        slots.append(seen[kind])
        seen[kind] += 1
    return HybridCache(
        torch.zeros(seen["mla"], batch, length, dsv3.cache_width(cfg),
                    device=device),
        torch.zeros(seen["kda"], batch, H, D, D, device=device),
        torch.zeros(seen["kda"], batch, 3 * P, K - 1, device=device),
        tuple(slots))


def snapshot(cache: HybridCache) -> Snapshot:
    """A device copy of every session's KDA state and tails."""
    cache.counts["snapshots"] += 1
    return Snapshot(cache.state.clone(), cache.conv.clone())


def restore(cache: HybridCache, snap: Snapshot) -> None:
    """Copy ``snap``'s KDA state and tails back into ``cache`` in place."""
    with span("tq.kimi.restore", device=cache.state.is_cuda):
        cache.state.copy_(snap.state)
        cache.conv.copy_(snap.conv)
    cache.counts["restores"] += 1
    cache.counts["bytes_restored"] += (
        snap.state.numel() * snap.state.element_size()
        + snap.conv.numel() * snap.conv.element_size())


# --------------------------------------------------------------- layers


def _layer_kda_prefill(params, cfg, i: int, x: torch.Tensor, ctx,
                       rows: slice):
    """KDA layer ``i`` on whole prompts ``x`` (b, T, d) from an empty
    state: (output, state (b, H, D, D), tail (b, 3P, K - 1))."""
    pre = f"layers.{i}"
    b, T, d = x.shape
    eps = cfg["rms_norm_eps"]
    ctx.record(f"{pre}.input", x, rows)
    a = _rms_norm(params[f"{pre}.input_layernorm"], x, eps)
    att, state, tail = kda_prefill(ctx.dense, params, f"{pre}.self_attn", a,
                                   _kda_dims(cfg)[0], eps)
    h = x + att
    f = _rms_norm(params[f"{pre}.post_attention_layernorm"], h, eps)
    out = h + _ffn(params, cfg, i, f.reshape(b * T, d), ctx, rows,
                   (b, T)).reshape(b, T, d)
    ctx.record(f"{pre}.output", out, rows)
    return out, state, tail


def _layer_kda_step(params, cfg, i: int, x: torch.Tensor, state, tail, ctx):
    """KDA layer ``i`` on one token a session ``x`` (B, d), moving
    ``state`` and ``tail`` on in place."""
    pre = f"layers.{i}"
    eps = cfg["rms_norm_eps"]
    every = slice(None)
    ctx.record(f"{pre}.input", x, every)
    a = _rms_norm(params[f"{pre}.input_layernorm"], x, eps)
    h = x + kda_step(ctx.dense, params, f"{pre}.self_attn", a,
                     _kda_dims(cfg)[0], eps, state, tail)
    f = _rms_norm(params[f"{pre}.post_attention_layernorm"], h, eps)
    out = h + _ffn(params, cfg, i, f, ctx, every, (x.shape[0],))
    ctx.record(f"{pre}.output", out, every)
    return out


def _ctx(ctx, qcfg, qstate):
    return ctx if ctx is not None else Context(qcfg, qstate)


def _prompts(params, cfg, scfg, tokens, ctx, rows, cache=None):
    """Every layer on the prompts ``tokens`` (b, T) (``rows`` of the
    batch), writing ``cache``'s entries for those rows where given: the
    last layer's output (b, T, d)."""
    T = tokens.shape[1]
    x = params["embed_tokens"]["w"][tokens]
    for i, kind in enumerate(kinds(cfg)):
        if kind == "mla":
            x, latent = _layer_expanded(params, scfg, i, x, None, None, ctx,
                                        rows)
            if cache is not None:
                cache.latent[cache.slots[i], rows, :T] = latent
        else:
            x, state, tail = _layer_kda_prefill(params, scfg, i, x, ctx,
                                                rows)
            if cache is not None:
                cache.state[cache.slots[i], rows] = state
                cache.conv[cache.slots[i], rows] = tail
    return x


# -------------------------------------------------------------- forwards


def apply(params, cfg, tokens: torch.Tensor, qcfg=None, qstate=None,
          ctx: Context | None = None) -> torch.Tensor:
    """(B, T) tokens -> (B, T, vocab) log-probabilities, every position,
    no cache (KDA chunked, MLA expanded).  ``qcfg``/``qstate``: the
    converted layers (:func:`convert`), or ``ctx`` in their place."""
    ctx = _ctx(ctx, qcfg, qstate)
    scfg = shared_cfg(cfg)
    B, T = tokens.shape
    every = slice(None)
    x = _prompts(params, cfg, scfg, tokens, ctx, every)
    return _head(params, scfg, x.reshape(B * T, -1), ctx,
                 every).reshape(B, T, -1)


@torch.inference_mode()
def prefill(params, cfg, tokens: torch.Tensor, cache: HybridCache,
            qcfg=None, qstate=None, ctx: Context | None = None,
            chunk_rows: int = 8192) -> torch.Tensor:
    """Run the (B, T) prompts from an empty state at positions 0 .. T -
    1, writing the latent's first T positions and every KDA state and
    tail, in chunks of whole sequences of about ``chunk_rows`` tokens
    (KDA in chunks of ``kda.CHUNK`` positions): the (B, vocab)
    log-probabilities of each sequence's next token.  Runs in inference
    mode, as :func:`decode_step` does."""
    ctx = _ctx(ctx, qcfg, qstate)
    scfg = shared_cfg(cfg)
    B, T = tokens.shape
    per = max(1, chunk_rows // T)
    out = []
    with span("tq.kimi.prefill"):
        for s in range(0, B, per):
            rows = slice(s, min(B, s + per))
            x = _prompts(params, cfg, scfg, tokens[rows], ctx, rows, cache)
            out.append(_head(params, scfg, x[:, -1], ctx, rows))
            cache.counts["prefill_chunks"] += 1
    return torch.cat(out)


@torch.inference_mode()
def decode_step(params, cfg, tokens: torch.Tensor, pos: int,
                cache: HybridCache, qcfg=None, qstate=None,
                ctx: Context | None = None) -> torch.Tensor:
    """One token of every sequence, ``tokens`` (B,) at position ``pos``
    (every sequence at the same position): MLA attends over the latent's
    positions 0 .. pos and writes its entries at ``pos``, KDA moves its
    state and tails on, both in place.  The (B, vocab)
    log-probabilities; equals :func:`apply`'s row at ``pos`` over the
    same tokens."""
    ctx = _ctx(ctx, qcfg, qstate)
    scfg = shared_cfg(cfg)
    with span("tq.kimi.step"):
        at = _at(pos, cache.latent)
        x = params["embed_tokens"]["w"][tokens]
        for i, kind in enumerate(kinds(cfg)):
            j = cache.slots[i]
            if kind == "mla":
                x = _layer_absorbed(params, scfg, i, x, at, cache.latent[j],
                                    None, None, ctx)
            else:
                x = _layer_kda_step(params, scfg, i, x, cache.state[j],
                                    cache.conv[j], ctx)
        return _head(params, scfg, x, ctx, slice(None))

