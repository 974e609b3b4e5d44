"""DeepSeek-V3 (``model_type: deepseek_v3``, the published
``modeling_deepseek.py``; Moonlight-16B-A3B is this block at 16 B),
term-revealed, in plain float32 PyTorch, a layer at a time.

A layer is ``h = x + MLA(RMSNorm(x))``, ``x' = h + FFN(RMSNorm(h))``; the
end is RMSNorm, ``lm_head`` and log-softmax.  MLA (no q-LoRA):
``q_proj`` gives each head ``q_nope`` and ``q_pe``;
``kv_a_proj_with_mqa`` gives the latent ``c``, normalised by
``kv_a_layernorm``, and one ``k_pe`` for all heads; RoPE (``rope_theta``,
no scaling) turns ``q_pe`` and ``k_pe`` in the interleaved layout (pairs
regrouped as halves, then rotate-half); ``kv_b_proj(c)`` gives each
head's ``k_nope`` and ``v``; causal softmax at ``(nope + rope)**-0.5``;
``o_proj``.  FFN: a SwiGLU ``down(silu(gate(x)) * up(x))`` in the first
``first_k_dense_replace`` layers; after them the experts: scores
``sigmoid(x W_gᵀ)``, the ``num_experts_per_tok`` of highest score plus
``e_score_correction_bias`` selected, each weighted by its score over the
selection's sum plus 1e-20, times ``routed_scaling_factor``; plus the
shared experts, one SwiGLU ``n_shared_experts`` times as wide.

Every ``nn.Linear`` is term-revealed (:func:`convert`) along its input
axis; the products multiply raw activations.  The router, the bias, the
norms and the embedding stay float32.  ``tf32`` rounds every product's
operands to TF32: the control.

Departures from the published code: the expert layer loops over the
experts, each on the rows that selected it (the published inference
sorts rows by expert: the same sum in another order); ``noaux_tc``'s
group step is left out, which with one group keeps every expert; a
layer's keys and values are expanded from cache entries ``[c, k_pe]``
(the program's earlier ones, :func:`layer`'s ``prev``), where the
published code caches them expanded; no dropout.  Parameters are never
all held: :func:`draw` makes any one from the seed alone, and
:func:`convert` converts the layers asked for.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F

from benchmark.harness import generator
from benchmark.reference import term_reveal
from benchmark.reference.compare import gap
from benchmark.reference.precision import operand

# A selection is held to the reference's where the reference's last
# selected and first unselected scores (plus bias) lie further apart than
# this: the program's router input differs from the reference's by the
# layer's float32 rounding (a score moves by ~1e-7), and sigmoid scores
# of N(0, 0.02) weights lie ~0.015 apart near the sixth of 64.  Nearer
# ties take the program's selection.
ROUTE_EPS = 1e-4
BIAS_BOUND = 0.01  # e_score_correction_bias ~ U(-0.01, 0.01) (assumed)


# ------------------------------------------------------------ parameters


def is_moe(cfg, i: int) -> bool:
    return (cfg["n_routed_experts"] > 0 and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def _swiglu(pre: str, d: int, width: int) -> dict:
    return {f"{pre}.gate_proj": {"w": (d, width)},
            f"{pre}.up_proj": {"w": (d, width)},
            f"{pre}.down_proj": {"w": (width, d)}}


def layer_shapes(cfg, i: int) -> dict:
    """name -> {key: shape} of layer ``i``'s parameters (linears (in,
    out), the router (E, d))."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pre = f"layers.{i}"
    out = {f"{pre}.input_layernorm": {"scale": (d,)},
           f"{pre}.self_attn.q_proj": {"w": (d, H * (nope + rope))},
           f"{pre}.self_attn.kv_a_proj_with_mqa": {"w": (d, r + rope)},
           f"{pre}.self_attn.kv_a_layernorm": {"scale": (r,)},
           f"{pre}.self_attn.kv_b_proj": {"w": (r, H * (nope + v))},
           f"{pre}.self_attn.o_proj": {"w": (H * v, d)},
           f"{pre}.post_attention_layernorm": {"scale": (d,)}}
    if is_moe(cfg, i):
        E, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out[f"{pre}.mlp.gate"] = {"w": (E, d), "bias": (E,)}
        for e in range(E):
            out.update(_swiglu(f"{pre}.mlp.experts.{e}", d, w))
        out.update(_swiglu(f"{pre}.mlp.shared_experts", d,
                           w * cfg["n_shared_experts"]))
    else:
        out.update(_swiglu(f"{pre}.mlp", d, cfg["intermediate_size"]))
    return out


def head_shapes(cfg) -> dict:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed_tokens": {"w": (V, d)}, "norm": {"scale": (d,)},
            "lm_head": {"w": (d, V)}}


def shapes(cfg) -> dict:
    """Every parameter, in the forward's order."""
    out = {"embed_tokens": head_shapes(cfg)["embed_tokens"]}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_shapes(cfg, i))
    out["norm"] = head_shapes(cfg)["norm"]
    out["lm_head"] = head_shapes(cfg)["lm_head"]
    return out


def draw(cfg, seed: int, name: str, device) -> dict:
    """Parameter ``name`` alone, from the run's seed and a sub-seed of
    (layer + 1, or 0 outside the layers; the name's place in its layer;
    the key): weights, the router and the embedding
    N(0, ``initializer_range``), the correction bias U(-0.01, 0.01),
    norms 1."""
    std = cfg.get("initializer_range", 0.02)
    if name.startswith("layers."):
        layer = int(name.split(".")[1]) + 1
        spec = layer_shapes(cfg, layer - 1)
    else:
        layer, spec = 0, head_shapes(cfg)
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


def unpack_u8s(lo: torch.Tensor, signs: torch.Tensor, w_sf: torch.Tensor,
               rows: int) -> torch.Tensor:
    """Weights of the 9-bit pack from its definition: ``lo`` (K8, N) int8
    holds ``|q| - 128``, bit i of ``signs[r]`` (K8 / 8, N) int8 the sign
    of row 8r + i (1: negative); the weight is ``±|q| * w_sf``, the first
    ``rows`` rows."""
    mag = lo.to(torch.int32) + 128
    bits = (signs.to(torch.int32)[:, None, :] >> torch.arange(
        8, device=lo.device, dtype=torch.int32)[None, :, None]) & 1
    sign = 1 - 2 * bits.reshape(lo.shape)
    return ((sign * mag).to(torch.float32) * w_sf)[:rows]


# --------------------------------------------------------------- forward


def rms_norm(x, scale, eps):
    return scale * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mm(a, b, tf32):
    return operand(a, tf32) @ operand(b, tf32)


def rotary(cfg, positions: torch.Tensor):
    """cos, sin (P, rope) at ``positions``."""
    dim = cfg["qk_rope_head_dim"]
    inv_freq = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, dim, 2, device=positions.device).float() / dim))
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rotary(x, cos, sin):
    """On (..., s, d) with cos, sin (s, d)."""
    *lead, s, d = x.shape
    x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    half = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * cos + half * sin


def entries(w, cfg, pre: str, a, pos0: int, tf32: bool = False):
    """The cache entries ``[c, k_pe]`` (S, T, rank + rope) of the normed
    rows ``a`` (S, T, d) at positions pos0 ...: c normalised, k_pe
    turned."""
    r = cfg["kv_lora_rank"]
    kva = _mm(a, w[f"{pre}.kv_a_proj_with_mqa"]["w"], tf32)
    c = rms_norm(kva[..., :r], w[f"{pre}.kv_a_layernorm"]["scale"],
                 cfg["rms_norm_eps"])
    cos, sin = rotary(cfg, torch.arange(pos0, pos0 + a.shape[1],
                                        device=a.device))
    return torch.cat([c, apply_rotary(kva[..., r:], cos, sin)], dim=-1)


def attention(w, cfg, pre: str, a, prev, pos0: int, tf32: bool = False):
    """MLA of the normed rows ``a`` (S, T, d) at positions pos0 ...,
    after the cache entries ``prev`` (S, pos0, rank + rope) or None:
    (output (S, T, d), the rows' own entries)."""
    S, T, _ = a.shape
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, v, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], \
        cfg["kv_lora_rank"]
    own = entries(w, cfg, pre, a, pos0, tf32)
    kv_all = own if prev is None else torch.cat([prev, own], dim=1)
    P = kv_all.shape[1]
    q = _mm(a, w[f"{pre}.q_proj"]["w"], tf32).view(S, T, H, nope + rope)
    q = q.transpose(1, 2)  # (S, H, T, ·)
    cos, sin = rotary(cfg, torch.arange(pos0, pos0 + T, device=a.device))
    q = torch.cat([q[..., :nope], apply_rotary(q[..., nope:], cos, sin)],
                  dim=-1)
    kv = _mm(kv_all[..., :r], w[f"{pre}.kv_b_proj"]["w"], tf32)
    kv = kv.view(S, P, H, nope + v).transpose(1, 2)  # (S, H, P, ·)
    k_pe = kv_all[:, None, :, r:].expand(S, H, P, rope)
    key = torch.cat([kv[..., :nope], k_pe], dim=-1)
    scores = _mm(q, key.transpose(2, 3), tf32) * (nope + rope) ** -0.5
    seen = (torch.arange(P, device=a.device)[None, :]
            <= torch.arange(pos0, pos0 + T, device=a.device)[:, None])
    scores = scores.masked_fill(~seen, float("-inf"))
    out = _mm(torch.softmax(scores, dim=-1), kv[..., nope:], tf32)
    out = out.transpose(1, 2).reshape(S, T, H * v)
    return _mm(out, w[f"{pre}.o_proj"]["w"], tf32), own


def mlp(w, pre: str, x, tf32: bool = False):
    return _mm(F.silu(_mm(x, w[f"{pre}.gate_proj"]["w"], tf32))
               * _mm(x, w[f"{pre}.up_proj"]["w"], tf32),
               w[f"{pre}.down_proj"]["w"], tf32)


def gate(w, cfg, pre: str, x, tf32: bool = False):
    """(selected (N, k), weights (N, k), the margin between the k-th and
    the (k+1)-th score plus bias (N,)) of the rows ``x`` (N, d)."""
    k = cfg["num_experts_per_tok"]
    router = w[f"{pre}.gate"]
    scores = torch.sigmoid(_mm(x, router["w"].T, tf32))
    top = torch.topk(scores + router["bias"], k + 1, dim=-1)
    idx = top.indices[:, :k]
    margin = top.values[:, k - 1] - top.values[:, k]
    return idx, scores, margin


def moe(w, cfg, pre: str, x, tf32: bool = False, select=None):
    """The expert layer on (N, d): (output, selected (N, k), margins (N,)).
    ``select`` (N, k): the program's selections, taken by the rows whose
    margin is within :data:`ROUTE_EPS`."""
    idx, scores, margin = gate(w, cfg, pre, x, tf32)
    if select is not None:
        near = margin <= ROUTE_EPS
        use = torch.where(near[:, None], select, idx)
    else:
        use = idx
    weight = scores.gather(1, use)
    weight = (weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
              * cfg["routed_scaling_factor"])
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (use == e).nonzero(as_tuple=True)
        if rows.numel():
            y[rows] += weight[rows, slot, None] * mlp(
                w, f"{pre}.experts.{e}", x[rows], tf32)
    return y + mlp(w, f"{pre}.shared_experts", x, tf32), idx, margin


def layer(w, cfg, i: int, x, prev=None, pos0: int = 0, tf32: bool = False,
          select=None):
    """Layer ``i`` on the rows ``x`` (S, T, d) at positions pos0 ...
    after the cache entries ``prev``: (output, the rows' cache entries,
    selected experts (S, T, k) or None, margins (S, T) or None)."""
    pre = f"layers.{i}"
    eps = cfg["rms_norm_eps"]
    S, T, d = x.shape
    a = rms_norm(x, w[f"{pre}.input_layernorm"]["scale"], eps)
    att, own = attention(w, cfg, f"{pre}.self_attn", a, prev, pos0, tf32)
    h = x + att
    f = rms_norm(h, w[f"{pre}.post_attention_layernorm"]["scale"],
                 eps).reshape(S * T, d)
    if is_moe(cfg, i):
        sel = None if select is None else select.reshape(S * T, -1)
        y, idx, margin = moe(w, cfg, f"{pre}.mlp", f, tf32, sel)
        idx, margin = idx.view(S, T, -1), margin.view(S, T)
    else:
        y, idx, margin = mlp(w, f"{pre}.mlp", f, tf32), None, None
    return h + y.view(S, T, d), own, idx, margin


def head(w, cfg, h, tf32: bool = False):
    """Final norm, ``lm_head`` and log-softmax of the rows ``h`` (N, d)."""
    h = rms_norm(h, w["norm"]["scale"], cfg["rms_norm_eps"])
    return torch.log_softmax(_mm(h, w["lm_head"]["w"], tf32), dim=-1)


def zipf_ids(cfg, gen: torch.Generator, shape, device) -> torch.Tensor:
    """int64 ids of ``shape`` with Zipf (s = 1) frequencies over the
    vocabulary: id k with weight 1 / (k + 1)."""
    V = cfg["vocab_size"]
    wts = 1.0 / torch.arange(1, V + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(wts, 0) / wts.sum()
    n = 1
    for s in shape:
        n *= s
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=V - 1).view(*shape)


def route_mismatch(select, idx, margin) -> tuple[int, int]:
    """(rows whose selected experts differ from the reference's where the
    reference's margin exceeds :data:`ROUTE_EPS`, rows within it)."""
    near = margin <= ROUTE_EPS
    differ = (select.sort(-1).values != idx.sort(-1).values).any(-1)
    return int((differ & ~near).sum()), int(near.sum())



def _widest(a, b) -> float:
    if a is None or a.shape != b.shape:
        return float("inf")
    off = float((a - b).abs().max()) if a.numel() else 0.0
    return off if off == off else float("inf")


def follow(w, cfg, i: int, x, out, written, select, prev=None,
           pos0: int = 0, control: bool = False) -> dict:
    """Layer ``i`` stepped from the program's own input ``x`` (S, T, d)
    and its earlier cache entries ``prev`` (S, pos0, rank + rope) or
    None.  ``out``, ``written``, ``select``: the program's output, the
    entries it wrote for these positions and its selected experts (None
    in a dense layer).  With ``control`` the reference at TF32 takes the
    program's place.  Returns ``layer_gap`` and ``cache_gap`` (the widest
    gap of the output and of the entries, as a share of the reference's
    largest magnitude), ``route_mismatch`` and ``route_near``
    (:func:`route_mismatch`)."""
    if x is not None and control:
        out, written, select, _ = layer(w, cfg, i, x, prev, pos0, tf32=True)
    if x is None or out is None or written is None:
        return {"layer_gap": float("inf"), "cache_gap": float("inf"),
                "route_mismatch": 0, "route_near": 0}
    want, own, idx, margin = layer(w, cfg, i, x, prev, pos0,
                                   select=select)
    found = {"layer_gap": gap(out, want), "cache_gap": gap(written, own),
             "route_mismatch": 0, "route_near": 0}
    if idx is not None:
        if select is None or select.shape != idx.shape:
            found["route_mismatch"] = idx[..., 0].numel()
        else:
            found["route_mismatch"], found["route_near"] = route_mismatch(
                select, idx, margin)
    return found


def follow_head(w, cfg, hidden, logp, control: bool = False) -> float:
    """The widest gap between the program's log-probabilities ``logp``
    (N, vocab) and the reference's from the program's final hidden
    ``hidden`` (N, d), before the norm."""
    if control:
        logp = head(w, cfg, hidden, tf32=True)
    return _widest(logp, head(w, cfg, hidden))
