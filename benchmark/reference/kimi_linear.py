"""Kimi-Linear (``model_type: kimi_linear``, Kimi-Linear-48B-A3B),
term-revealed, in plain float32 PyTorch, a layer at a time.

A layer is ``h = x + Attn(RMSNorm(x))``, ``x' = h + FFN(RMSNorm(h))``; the
end is RMSNorm, ``lm_head`` and log-softmax.  Attn is KDA in the 1-indexed
``linear_attn_config.kda_layers`` and MLA without rotation
(``mla_use_nope``) in its ``full_attn_layers``.

KDA, one token at a time: ``q, k, v = SiLU(conv(x W_q)), ...``, a causal
depthwise convolution of kernel K over the inputs before it (the
session's tail); per head ``q ← l2norm(q)·D^-0.5`` and ``k ← l2norm(k)``
(``x / sqrt(Σx² + 1e-6)``); ``g = −exp(A_log)·softplus(f_b(f_a x) +
dt_bias)``; ``β = sigmoid(b x)``; ``S' = Diag(exp g) S``, ``S = S' + β k
(v − S'ᵀk)ᵀ``, ``o = Sᵀq``; ``o ← RMSNorm(o)·w_o·sigmoid(g_b(g_a x))``
per head; ``o_proj``.  MLA: DeepSeek-V3's latent attention (no q-LoRA),
``q_pe`` and ``k_pe`` unturned, causal softmax at ``(nope + rope)**-0.5``.
FFN: the dense SwiGLU in the first ``first_k_dense_replace`` layers,
then the expert layer: ``sigmoid(x W_gᵀ)`` scores, the
``num_experts_per_token`` of highest score plus the correction bias
over all ``router_experts``, weights renormalised and times
``routed_scaling_factor``, summed over the experts this rank holds
(``num_experts`` of them from ``ep_rank * num_experts``), plus the
shared expert.

Every ``nn.Linear`` is term-revealed along its input axis
(:func:`convert`); the products multiply raw activations.  The router,
the bias, the convolutions, ``A_log``, ``dt_bias``, the norms and the
embedding stay float32.  ``tf32`` rounds every product's operands to
TF32 (the recurrence's too): the control.

Departures from the published code: float32 throughout, where the
published kernels (``fla``'s ``chunk_kda`` and ``fused_recurrent_kda``,
``fused_kda_gate``, ``FusedRMSNormGated``) compute in bfloat16 with a
float32 state; the recurrence one token at a time, also over a prompt;
the expert layer loops over the held experts, each on the rows that
selected it; ``noaux_tc``'s group step left out (one group keeps every
expert); the experts of the other ranks left out, as in the program
(the rank's share of the layer); a layer's keys and values expanded from
the cache entries ``[c, k_pe]``; no dropout.  Parameters are never all
held: :func:`draw` makes any one from the seed alone.  DeepSeek-V3's
plain pieces (norm, SwiGLU, router, head, the 9-bit pack's decoding, the
Zipf ids) are ``benchmark/reference/deepseek_v3.py``'s.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F

from benchmark.harness import generator
from benchmark.reference import term_reveal
from benchmark.reference.compare import gap
from benchmark.reference.deepseek_v3 import (BIAS_BOUND, ROUTE_EPS, _mm,
                                             follow_head, head, mlp,
                                             rms_norm, route_mismatch,
                                             unpack_u8s, zipf_ids)
from benchmark.reference.deepseek_v3 import gate as _gate
from benchmark.reference.precision import operand

__all__ = ["layer_shapes", "shapes", "draw", "Drawn", "is_linear",
           "convert", "is_kda", "is_moe", "held", "kda_layer", "mla_layer",
           "follow_kda", "follow_mla", "follow_head", "head", "zipf_ids",
           "unpack_u8s", "ROUTE_EPS"]


# ------------------------------------------------------------ parameters


def is_kda(cfg, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def is_moe(cfg, i: int) -> bool:
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def held(cfg) -> range:
    """The routed experts this rank holds."""
    n = cfg["num_experts"]
    first = cfg.get("ep_rank", 0) * n
    return range(first, first + n)


def _dims(cfg):
    lin = cfg["linear_attn_config"]
    H, D = lin["num_heads"], lin["head_dim"]
    return H, D, H * D, lin["short_conv_kernel_size"]


def _swiglu(pre: str, d: int, width: int) -> dict:
    return {f"{pre}.gate_proj": {"w": (d, width)},
            f"{pre}.up_proj": {"w": (d, width)},
            f"{pre}.down_proj": {"w": (width, d)}}


def layer_shapes(cfg, i: int) -> dict:
    """name -> {key: shape} of layer ``i``'s parameters (linears (in,
    out), the router (E, d), the convolutions (P, K))."""
    d = cfg["hidden_size"]
    pre = f"layers.{i}"
    att = f"{pre}.self_attn"
    out = {f"{pre}.input_layernorm": {"scale": (d,)}}
    if is_kda(cfg, i):
        H, D, P, K = _dims(cfg)
        out.update({f"{att}.q_proj": {"w": (d, P)},
                    f"{att}.k_proj": {"w": (d, P)},
                    f"{att}.v_proj": {"w": (d, P)},
                    f"{att}.q_conv1d": {"w": (P, K)},
                    f"{att}.k_conv1d": {"w": (P, K)},
                    f"{att}.v_conv1d": {"w": (P, K)},
                    f"{att}.A_log": {"w": (H,)},
                    f"{att}.f_a_proj": {"w": (d, D)},
                    f"{att}.f_b_proj": {"w": (D, P)},
                    f"{att}.dt_bias": {"w": (P,)},
                    f"{att}.b_proj": {"w": (d, H)},
                    f"{att}.g_a_proj": {"w": (d, D)},
                    f"{att}.g_b_proj": {"w": (D, P)},
                    f"{att}.o_norm": {"scale": (D,)},
                    f"{att}.o_proj": {"w": (P, d)}})
    else:
        Hm, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
        rope, v, r = (cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
        out.update({f"{att}.q_proj": {"w": (d, Hm * (nope + rope))},
                    f"{att}.kv_a_proj_with_mqa": {"w": (d, r + rope)},
                    f"{att}.kv_a_layernorm": {"scale": (r,)},
                    f"{att}.kv_b_proj": {"w": (r, Hm * (nope + v))},
                    f"{att}.o_proj": {"w": (Hm * v, d)}})
    out[f"{pre}.post_attention_layernorm"] = {"scale": (d,)}
    mlp_pre = f"{pre}.mlp"
    if is_moe(cfg, i):
        E = cfg.get("router_experts", cfg["num_experts"])
        w = cfg["moe_intermediate_size"]
        out[f"{mlp_pre}.gate"] = {"w": (E, d), "bias": (E,)}
        for e in held(cfg):
            out.update(_swiglu(f"{mlp_pre}.experts.{e}", d, w))
        out.update(_swiglu(f"{mlp_pre}.shared_experts", d,
                           w * cfg["num_shared_experts"]))
    else:
        out.update(_swiglu(mlp_pre, d, cfg["intermediate_size"]))
    return out


def _head_shapes(cfg) -> dict:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed_tokens": {"w": (V, d)}, "norm": {"scale": (d,)},
            "lm_head": {"w": (d, V)}}


def shapes(cfg) -> dict:
    """Every parameter, in the forward's order."""
    top = _head_shapes(cfg)
    out = {"embed_tokens": top["embed_tokens"]}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_shapes(cfg, i))
    out["norm"], out["lm_head"] = top["norm"], top["lm_head"]
    return out


def draw(cfg, seed: int, name: str, device) -> dict:
    """Parameter ``name`` alone, from the run's seed and a sub-seed of
    (layer + 1, or 0 outside the layers; the name's place in its layer;
    the key): weights, the router, the convolutions and the embedding
    N(0, ``initializer_range``), ``A_log`` = log U(1, 16), ``dt_bias`` =
    softplus⁻¹ of U(0.001, 0.1), the correction bias U(-0.01, 0.01),
    norms 1."""
    std = cfg.get("initializer_range", 0.02)
    if name.startswith("layers."):
        layer = int(name.split(".")[1]) + 1
        spec = layer_shapes(cfg, layer - 1)
    else:
        layer, spec = 0, _head_shapes(cfg)
    k = list(spec).index(name)
    out = {}
    for j, (key, shape) in enumerate(spec[name].items()):
        if key == "scale":
            out[key] = torch.ones(shape, device=device)
            continue
        gen = generator(seed, device, 1, layer, k, j)
        if key == "bias":
            out[key] = (torch.rand(shape, generator=gen, device=device)
                        * 2 - 1) * BIAS_BOUND
        elif name.endswith(".A_log"):
            out[key] = torch.log(1 + 15 * torch.rand(
                shape, generator=gen, device=device))
        elif name.endswith(".dt_bias"):
            u = 0.001 + 0.099 * torch.rand(shape, generator=gen,
                                           device=device)
            out[key] = u + torch.log(-torch.expm1(-u))
        else:
            out[key] = torch.randn(shape, generator=gen, device=device) * std
    return out


class Drawn(Mapping):
    """Every parameter of the model, each made by :func:`draw` when it is
    read (and not kept)."""

    def __init__(self, cfg, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self._names = list(shapes(cfg))
        self._known = set(self._names)

    def __getitem__(self, name):
        if name not in self._known:
            raise KeyError(name)
        return draw(self.cfg, self.seed, name, self.device)

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


def is_linear(name: str) -> bool:
    return name.endswith(("_proj", "_mqa")) or name == "lm_head"


def convert(cfg, seed: int, names, device) -> dict:
    """name -> the float32 tensors the reference computes with, for the
    parameters ``names``: each linear's weight term-revealed at the
    configuration's setting, the rest as drawn."""
    tr = cfg["tr"]
    args = (tr["weight_bits"], tr["group_size"], tr["weight_terms"])
    out = {}
    for name in names:
        p = draw(cfg, seed, name, device)
        if is_linear(name):
            p = {"w": term_reveal.reveal_weight(p["w"], *args, axis=0)}
        out[name] = p
    return out


# --------------------------------------------------------------- forward


def _l2norm(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def kda(w, cfg, pre: str, a, state=None, tail=None, tf32: bool = False):
    """KDA of the normed rows ``a`` (S, T, d) after ``state`` (S, H, D, D)
    and ``tail`` (S, 3P, K - 1) (zeros where None), one token at a time:
    (output (S, T, d), state, tail)."""
    S, T, _ = a.shape
    H, D, P, K = _dims(cfg)

    def lin(name, x):
        return _mm(x, w[f"{pre}.{name}"]["w"], tf32)

    qkv = torch.cat([lin("q_proj", a), lin("k_proj", a), lin("v_proj", a)],
                    -1)
    conv_w = torch.cat([w[f"{pre}.{c}_conv1d"]["w"] for c in "qkv"])
    if tail is None:
        tail = a.new_zeros(S, 3 * P, K - 1)
    f = lin("f_b_proj", lin("f_a_proj", a)) + w[f"{pre}.dt_bias"]["w"]
    g = -torch.exp(w[f"{pre}.A_log"]["w"])[:, None] * F.softplus(
        f.view(S, T, H, D))
    beta = torch.sigmoid(lin("b_proj", a))
    gate = torch.sigmoid(lin("g_b_proj", lin("g_a_proj", a))).view(S, T, H, D)
    if state is None:
        state = a.new_zeros(S, H, D, D)
    outs = []
    for t in range(T):
        window = torch.cat([tail, qkv[:, t, :, None]], -1)
        tail = window[..., 1:]
        x = F.silu((window * conv_w).sum(-1)).view(S, 3, H, D)
        q, k, v = _l2norm(x[:, 0]) * D ** -0.5, _l2norm(x[:, 1]), x[:, 2]
        state = torch.exp(g[:, t])[..., None] * state
        u = _mm(k[:, :, None, :], state, tf32)[:, :, 0]
        state = state + beta[:, t, :, None, None] * (
            operand(k, tf32)[..., None] * operand(v - u, tf32)[:, :, None])
        outs.append(_mm(q[:, :, None, :], state, tf32)[:, :, 0])
    o = torch.stack(outs, 1)
    o = rms_norm(o, w[f"{pre}.o_norm"]["scale"], cfg["rms_norm_eps"]) * gate
    return lin("o_proj", o.reshape(S, T, P)), state, tail.contiguous()


def mla(w, cfg, pre: str, a, prev, pos0: int, tf32: bool = False):
    """NoPE MLA of the normed rows ``a`` (S, T, d) at positions pos0 ...
    after the cache entries ``prev`` (S, pos0, rank + rope) or None:
    (output (S, T, d), the rows' own entries)."""
    S, T, _ = a.shape
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, v, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], \
        cfg["kv_lora_rank"]
    kva = _mm(a, w[f"{pre}.kv_a_proj_with_mqa"]["w"], tf32)
    own = torch.cat([rms_norm(kva[..., :r], w[f"{pre}.kv_a_layernorm"][
        "scale"], cfg["rms_norm_eps"]), kva[..., r:]], -1)
    kv_all = own if prev is None else torch.cat([prev, own], dim=1)
    Pn = kv_all.shape[1]
    q = _mm(a, w[f"{pre}.q_proj"]["w"], tf32).view(S, T, H, nope + rope)
    q = q.transpose(1, 2)
    kv = _mm(kv_all[..., :r], w[f"{pre}.kv_b_proj"]["w"], tf32)
    kv = kv.view(S, Pn, H, nope + v).transpose(1, 2)
    key = torch.cat([kv[..., :nope],
                     kv_all[:, None, :, r:].expand(S, H, Pn, rope)], -1)
    scores = _mm(q, key.transpose(2, 3), tf32) * (nope + rope) ** -0.5
    seen = (torch.arange(Pn, device=a.device)[None, :]
            <= torch.arange(pos0, pos0 + T, device=a.device)[:, None])
    scores = scores.masked_fill(~seen, float("-inf"))
    out = _mm(torch.softmax(scores, dim=-1), kv[..., nope:], tf32)
    out = out.transpose(1, 2).reshape(S, T, H * v)
    return _mm(out, w[f"{pre}.o_proj"]["w"], tf32), own


def moe(w, cfg, pre: str, x, tf32: bool = False, select=None):
    """The held share of the expert layer on (N, d): (output, selected
    (N, k), margins (N,)); ``select``: the program's selections, taken by
    rows whose margin is within :data:`ROUTE_EPS`."""
    k = cfg["num_experts_per_token"]
    idx, scores, margin = _gate(w, {"num_experts_per_tok": k}, pre, x, tf32)
    use = idx if select is None else torch.where(
        (margin <= ROUTE_EPS)[:, None], select, idx)
    weight = scores.gather(1, use)
    weight = (weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
              * cfg["routed_scaling_factor"])
    y = torch.zeros_like(x)
    for e in held(cfg):
        rows, slot = (use == e).nonzero(as_tuple=True)
        if rows.numel():
            y[rows] += weight[rows, slot, None] * mlp(
                w, f"{pre}.experts.{e}", x[rows], tf32)
    return y + mlp(w, f"{pre}.shared_experts", x, tf32), idx, margin


def _ffn(w, cfg, i: int, h, tf32: bool, select):
    """The layer's FFN after attention: (output, selected, margins)."""
    pre = f"layers.{i}"
    S, T, d = h.shape
    f = rms_norm(h, w[f"{pre}.post_attention_layernorm"]["scale"],
                 cfg["rms_norm_eps"]).reshape(S * T, d)
    if not is_moe(cfg, i):
        return h + mlp(w, f"{pre}.mlp", f, tf32).view(S, T, d), None, None
    sel = None if select is None else select.reshape(S * T, -1)
    y, idx, margin = moe(w, cfg, f"{pre}.mlp", f, tf32, sel)
    return h + y.view(S, T, d), idx.view(S, T, -1), margin.view(S, T)


def kda_layer(w, cfg, i: int, x, state=None, tail=None, tf32: bool = False,
              select=None):
    """KDA layer ``i`` on ``x`` (S, T, d) after ``state`` and ``tail``:
    (output, state, tail, selected, margins)."""
    pre = f"layers.{i}"
    a = rms_norm(x, w[f"{pre}.input_layernorm"]["scale"], cfg["rms_norm_eps"])
    att, state, tail = kda(w, cfg, f"{pre}.self_attn", a, state, tail, tf32)
    out, idx, margin = _ffn(w, cfg, i, x + att, tf32, select)
    return out, state, tail, idx, margin


def mla_layer(w, cfg, i: int, x, prev=None, pos0: int = 0,
              tf32: bool = False, select=None):
    """MLA layer ``i`` on ``x`` (S, T, d) at positions pos0 ... after the
    entries ``prev``: (output, the rows' entries, selected, margins)."""
    pre = f"layers.{i}"
    a = rms_norm(x, w[f"{pre}.input_layernorm"]["scale"], cfg["rms_norm_eps"])
    att, own = mla(w, cfg, f"{pre}.self_attn", a, prev, pos0, tf32)
    out, idx, margin = _ffn(w, cfg, i, x + att, tf32, select)
    return out, own, idx, margin


# ---------------------------------------------------------------- checks


def _routes(found, select, idx):
    if idx is None:
        return
    if select is None or select.shape != idx[0].shape:
        found["route_mismatch"] += idx[0][..., 0].numel()
    else:
        miss, near = route_mismatch(select, *idx)
        found["route_mismatch"] += miss
        found["route_near"] += near


def _blank() -> dict:
    return {"layer_gap": float("inf"), "state_gap": float("inf"),
            "cache_gap": 0.0, "route_mismatch": 0, "route_near": 0}


def follow_kda(w, cfg, i: int, xs, outs, selects, state, tail,
               end_state=None, end_tail=None, control: bool = False):
    """KDA layer ``i`` stepped over a run of inputs from the program's
    own: ``xs``, ``outs``, ``selects`` lists of the program's inputs (S,
    T, d), outputs and selected experts (None in a dense layer), one a
    call; ``state``, ``tail``: the program's state and tail before the
    first.  The reference carries its own state from call to call.
    ``end_state``, ``end_tail``: the program's after the last, or None.
    With ``control`` the reference at TF32 takes the program's place.
    Returns ``layer_gap``, ``state_gap`` (the widest gap of the state
    and of the tail, each over the reference's largest magnitude),
    ``route_mismatch`` and ``route_near``."""
    found = _blank()
    found["layer_gap"] = found["state_gap"] = 0.0
    if (state is None or tail is None or not xs
            or any(t is None for t in xs + outs)):
        return _blank()
    s_prog, t_prog = state, tail
    for x, out, sel in zip(xs, outs, selects):
        if control:
            out, s_prog, t_prog, idx, _ = kda_layer(w, cfg, i, x, s_prog,
                                                    t_prog, tf32=True)
            sel = idx
        want, state, tail, idx, margin = kda_layer(w, cfg, i, x, state,
                                                   tail, select=sel)
        found["layer_gap"] = max(found["layer_gap"], gap(out, want))
        _routes(found, sel, None if idx is None else (idx, margin))
    if control:
        end_state, end_tail = s_prog, t_prog
    if end_state is not None:
        found["state_gap"] = max(gap(end_state, state), gap(end_tail, tail))
    return found


def follow_mla(w, cfg, i: int, x, out, written, select, prev=None,
               pos0: int = 0, control: bool = False) -> dict:
    """MLA layer ``i`` stepped from the program's own input ``x`` (S, T,
    d) and earlier entries ``prev``: ``layer_gap``, ``cache_gap`` (the
    entries written), ``route_mismatch``, ``route_near``."""
    if x is not None and control:
        out, written, select, _ = mla_layer(w, cfg, i, x, prev, pos0,
                                            tf32=True)
    if x is None or out is None or written is None:
        return {**_blank(), "cache_gap": float("inf")}
    want, own, idx, margin = mla_layer(w, cfg, i, x, prev, pos0,
                                       select=select)
    found = {"layer_gap": gap(out, want), "cache_gap": gap(written, own),
             "state_gap": 0.0, "route_mismatch": 0, "route_near": 0}
    _routes(found, select, None if idx is None else (idx, margin))
    return found
