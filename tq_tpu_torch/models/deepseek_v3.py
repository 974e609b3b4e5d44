"""DeepSeek-V3 language model (``model_type: deepseek_v3``; Moonlight-16B-A3B
is this block at 16 B): RMSNorm, latent attention (MLA) with decoupled
RoPE, dense SwiGLU layers first, then routed and shared SwiGLU experts.

Every shape is read from the published configuration's keys
(``hidden_size``, ``num_attention_heads``, ``qk_nope_head_dim``,
``qk_rope_head_dim``, ``v_head_dim``, ``kv_lora_rank``,
``intermediate_size``, ``moe_intermediate_size``, ``n_routed_experts``,
``n_shared_experts``, ``num_experts_per_tok``, ``first_k_dense_replace``,
``moe_layer_freq``, ``num_hidden_layers``, ``vocab_size``,
``rms_norm_eps``, ``rope_theta``, ``routed_scaling_factor``), so a tiny
instance runs the same code.  Parameters are a flat dict keyed by the
published checkpoint's module names without ``model.``
(``layers.{i}.self_attn.q_proj``, ``layers.{i}.mlp.experts.{e}.up_proj``,
...), dense weights stored (in, out), no biases.

A layer is ``h = x + MLA(RMSNorm(x))``, ``x' = h + FFN(RMSNorm(h))``; the
end is RMSNorm, ``lm_head`` and log-softmax.  MLA (no q-LoRA): ``q_proj``
gives each head ``q_nope`` and ``q_pe``; ``kv_a_proj_with_mqa`` gives the
latent ``c`` (normalised by ``kv_a_layernorm``) and one ``k_pe`` shared
by the heads; RoPE (``rope_theta``, no scaling) turns ``q_pe`` and
``k_pe`` in DeepSeek-V3's interleaved layout; ``kv_b_proj(c)`` gives each
head ``k_nope`` and ``v``; causal softmax at ``(nope + rope)**-0.5``;
``o_proj``.  Two forms compute it:

* :func:`apply` and :func:`prefill` expand keys and values through
  ``kv_b_proj`` (prefill in row chunks of whole sequences);
* :func:`decode_step` absorbs ``kv_b_proj`` into the query and the output:
  position t's logit is ``(W_UK_hᵀ q_nope_h)·c_t + q_pe_h·k_pe_t`` and the
  head's output ``W_UV_h (Σ_t a_t c_t)``, over a cache that holds only
  ``[c_t, k_pe_t]`` (``kv_lora_rank + qk_rope_head_dim`` floats a token a
  layer), preallocated and written in place.

The expert layers are :func:`~tq_tpu_torch.layers.moe.moe_apply`: sigmoid
scores, selection by score plus ``e_score_correction_bias`` (``noaux_tc``
with one group), weights normalised and scaled.

TR conversion (:func:`convert`) converts every ``nn.Linear`` of the
published model: the attention's four projections, every expert, the
shared experts, the dense layers' SwiGLU and ``lm_head``.  The router (a
raw Parameter there), the correction bias, the norms and the embedding
stay float32.  Every converted product goes through
:func:`~tq_tpu_torch.layers.linear.tr_dense_apply` on 2-D rows.  Decode's
absorbed form reads ``kv_b_proj`` as its term-revealed float32 values, the
``(H, nope, rank)`` and ``(H, rank, v)`` heads decoded once by
:func:`pack` (exact).

Every product takes a context (:class:`Context`, a
:class:`~tq_tpu_torch.layers.qctx.QuantCtx`): its ``dense`` runs the
converted and float products, and its ``record`` sees each layer's input
and output, the cache entries written, the experts selected and the final
hidden, for a subclass that keeps them (the benchmark's check).

Spans (``utils/trace.py``): ``tq.dsv3.prefill``, ``tq.dsv3.step``,
``tq.mla.attend`` (device), and the expert layer's ``tq.moe.route`` and
``tq.moe.experts`` (device).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from tq_tpu_torch.kernels.term_matmul import (PackedWeight8,
                                              flush_pack_checks,
                                              unpack_weight_u8s)
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.linear import (init_quant_state,
                                        pack_dense_weights,
                                        tr_dense_convert)
from tq_tpu_torch.layers.moe import moe_apply
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.utils.trace import span

__all__ = ["Context", "param_shapes", "linears", "is_moe", "init", "convert",
           "pack", "apply", "make_quantized_apply", "init_cache", "prefill",
           "decode_step", "cache_width"]


class Context(QuantCtx):
    """A :class:`QuantCtx` with the model's record points.  ``record(name,
    value, rows)`` is called with ``layers.{i}.input`` and ``.output``
    (the residual stream into and out of layer i), ``layers.{i}.latent``
    (the cache entries the layer wrote), ``layers.{i}.mlp.gate`` (the
    experts selected, rows by ``num_experts_per_tok``) and ``norm`` (the
    final hidden, before the norm); ``value`` has the batch's sequences
    first, ``rows`` is the slice of the batch they are (a prefill chunk's
    sequences).  Here it keeps nothing."""

    def record(self, name: str, value: torch.Tensor, rows: slice) -> None:
        pass


def _check_cfg(cfg) -> None:
    if cfg.get("q_lora_rank") is not None:
        raise NotImplementedError("q-LoRA (q_lora_rank) is not supported")
    if cfg.get("scoring_func", "sigmoid") != "sigmoid":
        raise NotImplementedError("only sigmoid router scores")
    if cfg.get("topk_method", "noaux_tc") != "noaux_tc":
        raise NotImplementedError("only the noaux_tc selection")
    if cfg.get("n_group", 1) != cfg.get("topk_group", 1):
        raise NotImplementedError("group-limited selection (topk_group < "
                                  "n_group) is not supported")
    if cfg.get("rope_scaling") is not None:
        raise NotImplementedError("RoPE scaling is not supported")


def is_moe(cfg, i: int) -> bool:
    """Whether layer ``i`` is an expert layer."""
    return (cfg["n_routed_experts"] > 0
            and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def cache_width(cfg) -> int:
    """Floats a token a layer in the latent cache: ``[c, k_pe]``."""
    return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]


def _swiglu_shapes(pre: str, d: int, width: int) -> dict:
    return {f"{pre}.gate_proj": {"w": (d, width)},
            f"{pre}.up_proj": {"w": (d, width)},
            f"{pre}.down_proj": {"w": (width, d)}}


def param_shapes(cfg) -> dict:
    """name -> {key: shape} of every parameter, in the forward's order."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    out = {"embed_tokens": {"w": (cfg["vocab_size"], d)}}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}"
        out[f"{pre}.input_layernorm"] = {"scale": (d,)}
        out[f"{pre}.self_attn.q_proj"] = {"w": (d, H * (nope + rope))}
        out[f"{pre}.self_attn.kv_a_proj_with_mqa"] = {"w": (d, r + rope)}
        out[f"{pre}.self_attn.kv_a_layernorm"] = {"scale": (r,)}
        out[f"{pre}.self_attn.kv_b_proj"] = {"w": (r, H * (nope + v))}
        out[f"{pre}.self_attn.o_proj"] = {"w": (H * v, d)}
        out[f"{pre}.post_attention_layernorm"] = {"scale": (d,)}
        if is_moe(cfg, i):
            E, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            out[f"{pre}.mlp.gate"] = {"w": (E, d), "bias": (E,)}
            for e in range(E):
                out.update(_swiglu_shapes(f"{pre}.mlp.experts.{e}", d, w))
            out.update(_swiglu_shapes(f"{pre}.mlp.shared_experts", d,
                                      w * cfg["n_shared_experts"]))
        else:
            out.update(_swiglu_shapes(f"{pre}.mlp", d,
                                      cfg["intermediate_size"]))
    out["norm"] = {"scale": (d,)}
    out["lm_head"] = {"w": (d, cfg["vocab_size"])}
    return out


def linears(cfg) -> list[str]:
    """The names of every ``nn.Linear`` of the published model."""
    return [n for n in param_shapes(cfg)
            if n.endswith("_proj") or n.endswith("_mqa") or n == "lm_head"]


def init(cfg, generator: torch.Generator | None = None, device=None) -> dict:
    """Weights, the router and the embedding N(0, ``initializer_range``)
    (0.02 where the configuration omits it), norms at 1, the correction
    bias 0; on ``device="meta"`` only the shapes."""
    _check_cfg(cfg)
    std = cfg.get("initializer_range", 0.02)
    params = {}
    for name, keys in param_shapes(cfg).items():
        p = {}
        for key, shape in keys.items():
            if key == "scale":
                p[key] = torch.ones(shape, device=device)
            elif key == "bias":
                p[key] = torch.zeros(shape, device=device)
            else:
                p[key] = torch.randn(shape, generator=generator,
                                     device=device) * std
        params[name] = p
    return params


def _absorbed(p: dict, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """``kv_b_proj``'s heads as decode absorbs them: ``W_UKᵀ`` (H, nope,
    rank) and ``W_UV`` (H, rank, v), float32."""
    if "wk" in p:
        return p["wk"], p["wv"]
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    r = cfg["kv_lora_rank"]
    w = p["w"]
    if isinstance(w, PackedWeight8):
        w = unpack_weight_u8s(w, k=r)
    elif not w.dtype.is_floating_point:
        w = w.to(torch.float32) * p["w_sf"]
    w = w.to(torch.float32).reshape(r, H, -1)
    return (w[:, :, :nope].permute(1, 2, 0).contiguous(),
            w[:, :, nope:].permute(1, 0, 2).contiguous())


def _pack_one(name: str, q: dict, tr: TRParams, fmt: str, cfg,
              checks: list) -> dict:
    out = pack_dense_weights(q, tr, fmt=fmt, checks=checks)
    if name.endswith(".kv_b_proj"):
        out["wk"], out["wv"] = _absorbed(q, cfg)
    return out


def convert(params: Mapping, cfg, setting, quantize_input: bool = False,
            pack_fmt: str | None = None):
    """TR-convert every ``nn.Linear`` (:func:`linears`) at ``setting`` =
    (weight_bits, group_size, weight_terms, data_bits, data_terms):
    (qparams, qcfg, qstate), qcfg and qstate keyed by the linears' names.

    ``params`` is read one name at a time, in :func:`param_shapes`'
    order, and each linear is converted (and, with ``pack_fmt``, packed as
    :func:`pack` packs it) before the next is read: a mapping that makes
    each weight when it is read never holds more than one float32 linear.
    """
    _check_cfg(cfg)
    tr = TRParams(*setting, quantize_input=quantize_input)
    convert_names = set(linears(cfg))
    qparams, qcfg, qstate, checks = {}, {}, {}, []
    for name in param_shapes(cfg):
        p = params[name]
        if name not in convert_names:
            qparams[name] = p
            continue
        q = tr_dense_convert(p, tr)
        if pack_fmt is not None:
            q = _pack_one(name, q, tr, pack_fmt, cfg, checks)
        qparams[name] = q
        qcfg[name] = tr
        qstate[name] = init_quant_state(device=p["w"].device)
    flush_pack_checks(checks)
    return qparams, qcfg, qstate


def pack(qparams, qcfg, cfg, fmt: str = "u8s") -> dict:
    """Serving transform: every converted linear's weights packed
    (:func:`~tq_tpu_torch.layers.linear.pack_dense_weights`: ``'u8s'``, the
    9-bit pack of 8-bit grids, or ``'int'``), ``kv_b_proj``'s absorbed
    heads decoded beside them; every overflow check fetched in one
    copy."""
    out, checks = dict(qparams), []
    for name, tr in qcfg.items():
        out[name] = _pack_one(name, qparams[name], tr, fmt, cfg, checks)
    flush_pack_checks(checks)
    return out


# ------------------------------------------------------------------ pieces


def _rms_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return p["scale"] * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                         + eps))


def _rope_tables(cfg, positions: torch.Tensor):
    """cos, sin (P, rope) of the float32 ``positions``."""
    dim = cfg["qk_rope_head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, dim, 2, device=positions.device).float() / dim))
    freqs = positions.to(torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """DeepSeek-V3's interleaved RoPE: pairs (2i, 2i+1) regrouped as
    halves, then rotate-half."""
    *lead, dim = x.shape
    x = x.reshape(*lead, dim // 2, 2).transpose(-1, -2).reshape(*lead, dim)
    rot = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], dim=-1)
    return x * cos + rot * sin


def _swiglu(ctx, params, pre: str, x: torch.Tensor) -> torch.Tensor:
    gate = ctx.dense(f"{pre}.gate_proj", params[f"{pre}.gate_proj"], x)
    up = ctx.dense(f"{pre}.up_proj", params[f"{pre}.up_proj"], x)
    return ctx.dense(f"{pre}.down_proj", params[f"{pre}.down_proj"],
                     F.silu(gate) * up)


def _ffn(params, cfg, i: int, x: torch.Tensor, ctx, rows: slice,
         shape) -> torch.Tensor:
    """The layer's FFN on rows ``x`` (N, d); ``shape``: the batch's
    leading shape of the N rows, for the record."""
    pre = f"layers.{i}.mlp"
    if not is_moe(cfg, i):
        return _swiglu(ctx, params, pre, x)

    def expert(e, rows_e):
        return _swiglu(ctx, params, f"{pre}.experts.{e}", rows_e)

    y, selected = moe_apply(x, params[f"{pre}.gate"], expert,
                            cfg["num_experts_per_tok"],
                            cfg["routed_scaling_factor"], layer=pre)
    ctx.record(f"{pre}.gate", selected.reshape(*shape, -1), rows)
    return y + _swiglu(ctx, params, f"{pre}.shared_experts", x)


def _projections(params, cfg, pre: str, a: torch.Tensor, ctx):
    """q_nope, q_pe (N, H, ·), the normalised latent c (N, rank) and the
    unturned k_pe (N, rope) of the rows ``a`` (N, d)."""
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    r = cfg["kv_lora_rank"]
    q = ctx.dense(f"{pre}.q_proj", params[f"{pre}.q_proj"], a)
    q = q.reshape(a.shape[0], H, -1)
    kva = ctx.dense(f"{pre}.kv_a_proj_with_mqa",
                    params[f"{pre}.kv_a_proj_with_mqa"], a)
    c = _rms_norm(params[f"{pre}.kv_a_layernorm"], kva[:, :r],
                  cfg["rms_norm_eps"])
    return q[..., :nope], q[..., nope:], c, kva[:, r:]


def _scale(cfg) -> float:
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5


def _layer_expanded(params, cfg, i: int, x: torch.Tensor, cos, sin, ctx,
                    rows: slice):
    """Layer ``i`` on whole sequences ``x`` (b, T, d) at positions 0 ..
    T - 1, keys and values expanded: (output, cache entries (b, T,
    rank + rope))."""
    pre = f"layers.{i}"
    b, T, d = x.shape
    H, nope, v = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                  cfg["v_head_dim"])
    eps = cfg["rms_norm_eps"]
    ctx.record(f"{pre}.input", x, rows)
    a = _rms_norm(params[f"{pre}.input_layernorm"], x, eps).reshape(b * T, d)
    q_nope, q_pe, c, k_pe = _projections(params, cfg, f"{pre}.self_attn", a,
                                         ctx)
    q_pe = _rope(q_pe, cos.repeat(b, 1)[:, None], sin.repeat(b, 1)[:, None])
    k_pe = _rope(k_pe, cos.repeat(b, 1), sin.repeat(b, 1))
    latent = torch.cat([c, k_pe], dim=-1).reshape(b, T, -1)
    ctx.record(f"{pre}.latent", latent, rows)
    kv = ctx.dense(f"{pre}.self_attn.kv_b_proj",
                   params[f"{pre}.self_attn.kv_b_proj"], c)
    kv = kv.reshape(b, T, H, nope + v)
    with span("tq.mla.attend", device=x.is_cuda):
        qh = torch.cat([q_nope, q_pe], dim=-1).reshape(b, T, H, -1)
        kh = torch.cat([kv[..., :nope],
                        k_pe.reshape(b, T, 1, -1).expand(b, T, H, -1)],
                       dim=-1)
        scores = torch.einsum("bthd,bshd->bhts", qh, kh) * _scale(cfg)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), -1)
        o = torch.einsum("bhts,bshd->bthd", probs, kv[..., nope:])
    h = x + ctx.dense(f"{pre}.self_attn.o_proj",
                      params[f"{pre}.self_attn.o_proj"],
                      o.reshape(b * T, H * v)).reshape(b, T, d)
    f = _rms_norm(params[f"{pre}.post_attention_layernorm"], h, eps)
    out = h + _ffn(params, cfg, i, f.reshape(b * T, d), ctx, rows,
                   (b, T)).reshape(b, T, d)
    ctx.record(f"{pre}.output", out, rows)
    return out, latent


def _layer_absorbed(params, cfg, i: int, x: torch.Tensor, pos: int,
                    cache_i: torch.Tensor, cos, sin, ctx):
    """Layer ``i`` on one token a sequence ``x`` (B, d) at position
    ``pos``, attending over ``cache_i`` (B, L, rank + rope), into which it
    writes its entry at ``pos``."""
    pre = f"layers.{i}"
    B, d = x.shape
    H, r, v = cfg["num_attention_heads"], cfg["kv_lora_rank"], \
        cfg["v_head_dim"]
    eps = cfg["rms_norm_eps"]
    every = slice(None)
    ctx.record(f"{pre}.input", x, every)
    a = _rms_norm(params[f"{pre}.input_layernorm"], x, eps)
    q_nope, q_pe, c, k_pe = _projections(params, cfg, f"{pre}.self_attn", a,
                                         ctx)
    entry = torch.cat([c, _rope(k_pe, cos, sin)], dim=-1)
    ctx.record(f"{pre}.latent", entry, every)
    wk, wv = _absorbed(params[f"{pre}.self_attn.kv_b_proj"], cfg)
    with span("tq.mla.attend", device=x.is_cuda):
        cache_i[:, pos] = entry
        q_lat = torch.bmm(q_nope.transpose(0, 1), wk).transpose(0, 1)
        qf = torch.cat([q_lat, _rope(q_pe, cos, sin)], dim=-1)  # (B, H, ·)
        kv = cache_i[:, :pos + 1]  # (B, P, rank + rope)
        probs = torch.softmax(torch.bmm(qf, kv.transpose(1, 2))
                              * _scale(cfg), dim=-1)
        o_lat = torch.bmm(probs, kv[..., :r])  # (B, H, rank)
        o = torch.bmm(o_lat.transpose(0, 1), wv).transpose(0, 1)
    h = x + ctx.dense(f"{pre}.self_attn.o_proj",
                      params[f"{pre}.self_attn.o_proj"],
                      o.reshape(B, H * v))
    f = _rms_norm(params[f"{pre}.post_attention_layernorm"], h, eps)
    out = h + _ffn(params, cfg, i, f, ctx, every, (B,))
    ctx.record(f"{pre}.output", out, every)
    return out


def _head(params, cfg, h: torch.Tensor, ctx, rows: slice) -> torch.Tensor:
    """Final norm, ``lm_head`` and log-softmax of rows ``h`` (N, d)."""
    ctx.record("norm", h, rows)
    h = _rms_norm(params["norm"], h, cfg["rms_norm_eps"])
    return torch.log_softmax(ctx.dense("lm_head", params["lm_head"], h), -1)


def _ctx(ctx, qcfg, qstate):
    return ctx if ctx is not None else Context(qcfg, qstate)


# -------------------------------------------------------------- forwards


def apply(params, cfg, tokens: torch.Tensor, qcfg=None, qstate=None,
          ctx: Context | None = None) -> torch.Tensor:
    """(B, T) tokens -> (B, T, vocab) log-probabilities, every position,
    keys and values expanded, no cache.  ``qcfg``/``qstate``: the
    converted layers (:func:`convert`), or ``ctx`` in their place."""
    ctx = _ctx(ctx, qcfg, qstate)
    B, T = tokens.shape
    x = params["embed_tokens"]["w"][tokens]
    cos, sin = _rope_tables(cfg, torch.arange(T, device=x.device))
    every = slice(None)
    for i in range(cfg["num_hidden_layers"]):
        x, _ = _layer_expanded(params, cfg, i, x, cos, sin, ctx, every)
    return _head(params, cfg, x.reshape(B * T, -1), ctx,
                 every).reshape(B, T, -1)


def make_quantized_apply(cfg, qcfg):
    """f(qparams, qstate, tokens) -> (B, T, vocab) log-probabilities."""

    def forward(qparams, qstate, tokens):
        return apply(qparams, cfg, tokens, qcfg=qcfg, qstate=qstate)

    return forward


def init_cache(cfg, batch: int, length: int, device=None) -> torch.Tensor:
    """The latent cache: (layers, batch, length, rank + rope) float32."""
    return torch.zeros(cfg["num_hidden_layers"], batch, length,
                       cache_width(cfg), device=device)


@torch.inference_mode()
def prefill(params, cfg, tokens: torch.Tensor, cache: torch.Tensor,
            qcfg=None, qstate=None, ctx: Context | None = None,
            chunk_rows: int = 8192) -> torch.Tensor:
    """Run the (B, T) prompts at positions 0 .. T - 1, writing the cache's
    first T positions, in chunks of whole sequences of about
    ``chunk_rows`` tokens: the (B, vocab) log-probabilities of each
    sequence's next token.  Prefill and decode run in inference mode:
    no autograd bookkeeping on their thousands of small operations, and
    what they return is an inference tensor."""
    ctx = _ctx(ctx, qcfg, qstate)
    B, T = tokens.shape
    per = max(1, chunk_rows // T)
    out = []
    with span("tq.dsv3.prefill"):
        cos, sin = _rope_tables(cfg,
                                torch.arange(T, device=cache.device))
        for s in range(0, B, per):
            rows = slice(s, min(B, s + per))
            x = params["embed_tokens"]["w"][tokens[rows]]
            for i in range(cfg["num_hidden_layers"]):
                x, latent = _layer_expanded(params, cfg, i, x, cos, sin,
                                            ctx, rows)
                cache[i, rows, :T] = latent
            out.append(_head(params, cfg, x[:, -1], ctx, rows))
    return torch.cat(out)


@torch.inference_mode()
def decode_step(params, cfg, tokens: torch.Tensor, pos: int,
                cache: torch.Tensor, qcfg=None, qstate=None,
                ctx: Context | None = None) -> torch.Tensor:
    """One token of every sequence, ``tokens`` (B,) at position ``pos``
    (a host int: every sequence at the same position), attending over the
    cache's positions 0 .. pos and writing its entries at ``pos`` in
    place: the (B, vocab) log-probabilities.  Equals :func:`apply`'s row
    at ``pos`` over the same tokens."""
    ctx = _ctx(ctx, qcfg, qstate)
    with span("tq.dsv3.step"):
        x = params["embed_tokens"]["w"][tokens]
        cos, sin = _rope_tables(
            cfg, torch.full((1,), pos, device=cache.device))
        for i in range(cfg["num_hidden_layers"]):
            x = _layer_absorbed(params, cfg, i, x, pos, cache[i], cos[0],
                                sin[0], ctx)
        return _head(params, cfg, x, ctx, slice(None))
