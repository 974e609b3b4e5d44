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
instance runs the same code.  Two keys the published configuration lacks
serve the models that share this code (``models/kimi_linear.py``):
``mla_use_nope`` (no rotation of ``q_pe`` and ``k_pe``: they enter the
scores as projected) and ``n_held_experts`` with ``ep_rank`` (an
expert-parallel rank's share: the router keeps its ``n_routed_experts``
outputs, this rank holds experts ``ep_rank * n_held_experts`` onwards,
:func:`held_experts`).  Parameters are a flat dict keyed by the
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
  layer), preallocated and written in place.  The position is a tensor on
  the cache's device and the attention reads the cache's whole length,
  the entries after the position masked, so that one CUDA graph serves
  every position: on the card the step replays one graph a model and
  batch shape (``utils/graphs.py::STEP_GRAPHS``, step ``dsv3.decode``).

The expert layers are :func:`~tq_tpu_torch.layers.moe.moe_apply`: sigmoid
scores, selection by score plus ``e_score_correction_bias`` (``noaux_tc``
with one group), weights normalised and scaled.  Where a layer's experts
are raw-input 9-bit packs, :func:`convert` (with ``pack_fmt``) and
:func:`pack` add ``layers.{i}.mlp.experts``: a
:class:`~tq_tpu_torch.layers.moe.Grouped` table of those same packs
(nothing copied), which a serving context hands ``moe_apply`` for its
grouped path (one launch a product over every expert, in a decode step
on the card).

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
hidden, for a subclass that keeps them (the benchmark's check).  A decode
step calls ``record`` once it has run, in the order of the step's record
points.

Spans (``utils/trace.py``): ``tq.dsv3.prefill``, ``tq.dsv3.step``,
``tq.mla.attend`` (device), and the expert layer's ``tq.moe.route`` and
``tq.moe.experts`` (device); a replayed decode step opens
``tq.dsv3.step`` alone (a replay runs none of the step's Python).
"""

from __future__ import annotations

import copy
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from tq_tpu_torch.kernels.term_matmul import (PackedWeight8,
                                              flush_pack_checks,
                                              unpack_weight_u8s)
from tq_tpu_torch.kernels.term_matmul_grouped import (group_weights,
                                                      layout_error)
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.linear import (init_quant_state,
                                        pack_dense_weights,
                                        tr_dense_convert)
from tq_tpu_torch.layers.moe import Grouped, moe_apply
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.utils.graphs import STEP_GRAPHS
from tq_tpu_torch.utils.trace import span

__all__ = ["Context", "param_shapes", "linears", "is_moe", "init", "convert",
           "pack", "apply", "make_quantized_apply", "init_cache", "prefill",
           "decode_step", "cache_width", "held_experts"]


class Context(QuantCtx):
    """A :class:`QuantCtx` with the model's record points.  ``record(name,
    value, rows)`` is called with ``layers.{i}.input`` and ``.output``
    (the residual stream into and out of layer i), ``layers.{i}.latent``
    (the cache entries the layer wrote), ``layers.{i}.mlp.gate`` (the
    experts selected, rows by ``num_experts_per_tok``) and ``norm`` (the
    final hidden, before the norm); ``value`` has the batch's sequences
    first, ``rows`` is the slice of the batch they are (a prefill chunk's
    sequences).  A decode step's values may be its CUDA graph's own
    tensors, overwritten by its next replay: copy what is kept.  Here it
    keeps nothing."""

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


def held_experts(cfg) -> range | None:
    """The routed experts this rank holds (``n_held_experts`` from
    ``ep_rank * n_held_experts``), or None where it holds every one."""
    E = cfg["n_routed_experts"]
    n = cfg.get("n_held_experts", E)
    if n == E:
        return None
    first = cfg.get("ep_rank", 0) * n
    if not (0 < n and first + n <= E):
        raise ValueError(f"rank {cfg.get('ep_rank', 0)} of {n} experts does "
                         f"not fit {E}")
    return range(first, first + n)


def _held_ids(cfg) -> range:
    held = held_experts(cfg)
    return range(cfg["n_routed_experts"]) if held is None else held


def cache_width(cfg) -> int:
    """Floats a token a layer in the latent cache: ``[c, k_pe]``."""
    return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]


def _swiglu_shapes(pre: str, d: int, width: int) -> dict:
    return {f"{pre}.gate_proj": {"w": (d, width)},
            f"{pre}.up_proj": {"w": (d, width)},
            f"{pre}.down_proj": {"w": (width, d)}}


def attention_shapes(cfg, pre: str) -> dict:
    """The MLA parameters of the attention module ``pre``."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    return {f"{pre}.q_proj": {"w": (d, H * (nope + rope))},
            f"{pre}.kv_a_proj_with_mqa": {"w": (d, r + rope)},
            f"{pre}.kv_a_layernorm": {"scale": (r,)},
            f"{pre}.kv_b_proj": {"w": (r, H * (nope + v))},
            f"{pre}.o_proj": {"w": (H * v, d)}}


def ffn_shapes(cfg, i: int) -> dict:
    """Layer ``i``'s FFN parameters: the dense SwiGLU, or the router (all
    its outputs), the held experts and the shared experts."""
    d, pre = cfg["hidden_size"], f"layers.{i}.mlp"
    if not is_moe(cfg, i):
        return _swiglu_shapes(pre, d, cfg["intermediate_size"])
    E, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out = {f"{pre}.gate": {"w": (E, d), "bias": (E,)}}
    for e in _held_ids(cfg):
        out.update(_swiglu_shapes(f"{pre}.experts.{e}", d, w))
    out.update(_swiglu_shapes(f"{pre}.shared_experts", d,
                              w * cfg["n_shared_experts"]))
    return out


def param_shapes(cfg) -> dict:
    """name -> {key: shape} of every parameter, in the forward's order."""
    d = cfg["hidden_size"]
    out = {"embed_tokens": {"w": (cfg["vocab_size"], d)}}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}"
        out[f"{pre}.input_layernorm"] = {"scale": (d,)}
        out.update(attention_shapes(cfg, f"{pre}.self_attn"))
        out[f"{pre}.post_attention_layernorm"] = {"scale": (d,)}
        out.update(ffn_shapes(cfg, i))
    out["norm"] = {"scale": (d,)}
    out["lm_head"] = {"w": (d, cfg["vocab_size"])}
    return out


def linears(cfg, shapes: dict | None = None) -> list[str]:
    """The names of every ``nn.Linear`` of the published model (of
    ``shapes``, :func:`param_shapes` where None)."""
    return [n for n in (param_shapes(cfg) if shapes is None else shapes)
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
            pack_fmt: str | None = None, shapes: dict | None = None):
    """TR-convert every ``nn.Linear`` (:func:`linears`) at ``setting`` =
    (weight_bits, group_size, weight_terms, data_bits, data_terms):
    (qparams, qcfg, qstate), qcfg and qstate keyed by the linears' names.

    ``params`` is read one name at a time, in the order of ``shapes``
    (:func:`param_shapes` where None; a model that shares this code
    passes its own), and each linear is converted (and, with
    ``pack_fmt``, packed as :func:`pack` packs it) before the next is
    read: a mapping that makes each weight when it is read never holds
    more than one float32 linear.
    """
    _check_cfg(cfg)
    tr = TRParams(*setting, quantize_input=quantize_input)
    shapes = param_shapes(cfg) if shapes is None else shapes
    convert_names = set(linears(cfg, shapes))
    qparams, qcfg, qstate, checks = {}, {}, {}, []
    for name in shapes:
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
    if pack_fmt is not None:
        _group_experts(qparams, qcfg, cfg)
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
    _group_experts(out, qcfg, cfg)
    return out


def _group_experts(qparams: dict, qcfg, cfg) -> None:
    """Add ``layers.{i}.mlp.experts``, the grouped path's
    :class:`~tq_tpu_torch.layers.moe.Grouped` table, for each expert
    layer whose held experts all serve raw input (``quantize_input``
    False), without bias, from 9-bit packs that the grouped kernel takes;
    the table covers the router's every id, an expert held elsewhere
    without a pack."""
    d, width = cfg["hidden_size"], cfg["moe_intermediate_size"]
    held = set(_held_ids(cfg))
    ids = range(cfg["n_routed_experts"])
    for i in range(cfg["num_hidden_layers"]):
        if not is_moe(cfg, i):
            continue
        pre = f"layers.{i}.mlp.experts"
        names = {p: [f"{pre}.{e}.{p}_proj" if e in held else None
                     for e in ids]
                 for p in ("gate", "up", "down")}
        every = [n for ns in names.values() for n in ns if n is not None]
        if any(n not in qcfg or qcfg[n].quantize_input
               or qparams[n].get("b") is not None for n in every):
            continue
        w = {p: [None if n is None else qparams[n]["w"] for n in ns]
             for p, ns in names.items()}
        if (layout_error([w["gate"], w["up"]], d) is None
                and layout_error([w["down"]], width) is None):
            qparams[pre] = Grouped(group_weights([w["gate"], w["up"]], d),
                                   group_weights([w["down"]], width))


# ------------------------------------------------------------------ pieces


def _rms_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return p["scale"] * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                         + eps))


@functools.cache  # kept for the process: a captured step reads it
def _positions(length: int, device) -> torch.Tensor:
    """0 .. ``length`` - 1, int64 on ``device``."""
    return torch.arange(length, device=device)


def _at(pos: int, cache: torch.Tensor) -> torch.Tensor:
    """The host position ``pos`` as a 0-d int64 tensor on the device of
    ``cache`` (layers, batch, length, ·): a view into a table of its
    positions, so that nothing is copied to the device."""
    return _positions(cache.shape[2], cache.device)[pos]


def _rope_tables(cfg, positions: torch.Tensor):
    """cos, sin (P, rope) of the float32 ``positions``; (None, None)
    where ``mla_use_nope`` leaves ``q_pe`` and ``k_pe`` unturned."""
    if cfg.get("mla_use_nope", False):
        return None, None
    dim = cfg["qk_rope_head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, dim, 2, device=positions.device).float() / dim))
    freqs = positions.to(torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor | None,
          sin: torch.Tensor | None):
    """DeepSeek-V3's interleaved RoPE: pairs (2i, 2i+1) regrouped as
    halves, then rotate-half; ``x`` itself where ``cos`` is None
    (NoPE)."""
    if cos is None:
        return x
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
                            cfg["routed_scaling_factor"],
                            held=held_experts(cfg), layer=pre,
                            grouped=_grouped(params, cfg, ctx, pre))
    ctx.record(f"{pre}.gate", selected.reshape(*shape, -1), rows)
    return y + _swiglu(ctx, params, f"{pre}.shared_experts", x)


def _grouped(params, cfg, ctx, pre: str) -> Grouped | None:
    """The expert layer ``pre``'s grouped table where ``ctx`` serves its
    experts as :func:`_group_experts` built it for (converted, raw input,
    not tracking), else None."""
    grouped = params.get(f"{pre}.experts")
    if grouped is None or ctx.track or ctx.cfg is None:
        return None
    tr = ctx.cfg.get(f"{pre}.experts.{_held_ids(cfg)[0]}.gate_proj")
    return grouped if tr is not None and not tr.quantize_input else None


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
    if cos is not None:
        q_pe = _rope(q_pe, cos.repeat(b, 1)[:, None],
                     sin.repeat(b, 1)[:, None])
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


def _layer_absorbed(params, cfg, i: int, x: torch.Tensor, at: torch.Tensor,
                    cache_i: torch.Tensor, cos, sin, ctx):
    """Layer ``i`` on one token a sequence ``x`` (B, d) at the position
    ``at`` (a 0-d int64 tensor on ``x``'s device), attending over
    ``cache_i`` (B, L, rank + rope), into which it writes its entry at
    ``at``.  The attention reads all L entries, the scores of those after
    ``at`` set to -inf: their probabilities are exactly 0."""
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
        cache_i.index_copy_(1, at.reshape(1), entry[:, None])
        q_lat = torch.bmm(q_nope.transpose(0, 1), wk).transpose(0, 1)
        qf = torch.cat([q_lat, _rope(q_pe, cos, sin)], dim=-1)  # (B, H, ·)
        scores = torch.bmm(qf, cache_i.transpose(1, 2)) * _scale(cfg)
        after = _positions(cache_i.shape[1], x.device) > at  # (L,)
        probs = torch.softmax(scores.masked_fill_(after, -torch.inf), -1)
        o_lat = torch.bmm(probs, cache_i[..., :r])  # (B, H, rank)
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


def _step(params, cfg, tokens: torch.Tensor, at: torch.Tensor,
          cache: torch.Tensor, ctx) -> tuple:
    """One decode step at the device position ``at``: (the (B, vocab)
    log-probabilities, the step's record points as (name, value, rows)
    in order), ``ctx.record`` left uncalled; every value is held until
    the step ends, so none of them shares memory with a later tensor of
    the step."""
    kept = []
    ctx = copy.copy(ctx)
    ctx.record = lambda name, value, rows: kept.append((name, value, rows))
    x = params["embed_tokens"]["w"][tokens]
    cos, sin = _rope_tables(cfg, at.reshape(1))
    if cos is not None:
        cos, sin = cos[0], sin[0]
    for i in range(cfg["num_hidden_layers"]):
        x = _layer_absorbed(params, cfg, i, x, at, cache[i], cos, sin, ctx)
    return _head(params, cfg, x, ctx, slice(None)), tuple(kept)


@torch.inference_mode()
def decode_step(params, cfg, tokens: torch.Tensor, pos: int,
                cache: torch.Tensor, qcfg=None, qstate=None,
                ctx: Context | None = None) -> torch.Tensor:
    """One token of every sequence, ``tokens`` (B,) at position ``pos``
    (a host int: every sequence at the same position), attending over the
    cache's positions 0 .. pos and writing its entries at ``pos`` in
    place: the (B, vocab) log-probabilities.  Equals :func:`apply`'s row
    at ``pos`` over the same tokens.

    The step runs through one CUDA graph a model, cache and batch shape
    (``STEP_GRAPHS``, step ``dsv3.decode``): ``pos`` enters it as a device
    tensor, the cache and the weights are read in place.  It runs eagerly
    where no graph engages (a tensor off the card, a tracking context, a
    capture or a tracer running), counted there by reason.  Either way
    ``ctx.record`` is called once the step has run, with the record
    points in the step's order."""
    ctx = _ctx(ctx, qcfg, qstate)
    with span("tq.dsv3.step"):
        at = _at(pos, cache)

        def step(tok, at):
            return _step(params, cfg, tok, at, cache, ctx)

        if ctx.track:
            logp, kept = STEP_GRAPHS.eager("track", step, tokens, at,
                                           step="dsv3.decode")
        else:
            logp, kept = STEP_GRAPHS.call(
                step, (tokens, at), (params, cfg, ctx.cfg, ctx.state, cache),
                (type(ctx).dense, ctx.compute_dtype, ctx.count_reduce),
                step="dsv3.decode", shared=True)
        if type(ctx).record is not Context.record:
            for name, value, rows in kept:
                ctx.record(name, value, rows)
        return logp
