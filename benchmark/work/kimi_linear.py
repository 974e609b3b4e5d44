"""Kimi-Linear's work at a configuration's shapes: one decode step of
``rows`` sessions, the MLA layers attending over ``positions`` latent
entries, weights in the served format (the 9-bit pack of every linear,
the decoded float32 ``kv_b_proj`` heads of the absorbed attention, the
float32 router, convolutions, norms and embedding), each KDA layer's
float32 state and convolution tail read and written once.

The routed experts count this rank's share: of ``k * rows`` (row, slot)
pairs, the ``held / E`` that fall to the ``held`` experts here (the
router picks among all ``E``), and those experts' weights, all read at
the traffic's rows (8 rows an expert at 256 sessions)."""

from __future__ import annotations

from benchmark.roofline import matmul
from benchmark.work.deepseek_v3 import mean_positions

__all__ = ["step", "kernel", "mean_positions"]

_F32 = 4
_FORMAT_BYTES = {"u8s": 9 / 8, "int8": 1, "int16": 2, "f32": 4}


def _kda(cfg, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def _moe(cfg, i: int) -> bool:
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def _dims(cfg):
    lin = cfg["linear_attn_config"]
    H, D = lin["num_heads"], lin["head_dim"]
    return H, D, H * D, lin["short_conv_kernel_size"]


def _products(cfg, rows: int):
    """(rows, in, out, experts whose weights are read) of every TR
    product of a step."""
    d = cfg["hidden_size"]
    H, D, P, _ = _dims(cfg)
    Hm, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, v, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], \
        cfg["kv_lora_rank"]
    E = cfg.get("router_experts", cfg["num_experts"])
    held, k = cfg["num_experts"], cfg["num_experts_per_token"]
    w, shared = cfg["moe_intermediate_size"], cfg["num_shared_experts"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        if _kda(cfg, i):
            out += [(rows, d, P, 1)] * 3 + [(rows, P, d, 1)]
            out += [(rows, d, D, 1), (rows, D, P, 1)] * 2 + [(rows, d, H, 1)]
        else:
            out += [(rows, d, Hm * (nope + rope), 1), (rows, d, r + rope, 1),
                    (rows, Hm * v, d, 1)]
        if _moe(cfg, i):
            pairs = k * rows * held / E
            out += [(pairs, d, w, min(held, pairs))] * 2
            out += [(pairs, w, d, min(held, pairs))]
            out += [(rows, d, w * shared, 1)] * 2 + [(rows, w * shared, d, 1)]
        else:
            I = cfg["intermediate_size"]
            out += [(rows, d, I, 1), (rows, d, I, 1), (rows, I, d, 1)]
    out.append((rows, d, cfg["vocab_size"], 1))
    return out


def _recurrence(cfg, rows: int) -> tuple[float, float]:
    """The KDA layers' least work between their products: the state (H,
    D, D) and tail (3P, K - 1) a session read and written once; the
    decay, ``S'ᵀk``, the rank-one update and ``Sᵀq`` (7 operations a
    state element), the convolution (2K a channel); q, k, v, g, β and
    the gate in, o out."""
    H, D, P, K = _dims(cfg)
    n = sum(_kda(cfg, i) for i in range(cfg["num_hidden_layers"]))
    state = rows * H * D * D
    tail = rows * 3 * P * (K - 1)
    ops = n * (7.0 * state + 2.0 * K * 3 * P * rows)
    io = rows * (3 * P + P + H + P + P) * _F32
    params = (3 * P * K + H + P + D) * _F32
    return ops, n * (2.0 * (state + tail) * _F32 + io + params)


def step(cfg, rows: int, positions: float) -> tuple[float, float]:
    """Every product of the step, the KDA recurrence and the MLA layers'
    absorbed attention over ``positions`` entries; bytes: the packed
    weights (every held expert's), the decoded ``kv_b_proj`` heads, the
    router, the norms and convolutions, the KDA state and tails, the
    latent read and the entries written, the embedding rows in and the
    log-probabilities out."""
    packed = _FORMAT_BYTES[cfg["serving"]["pack"]]
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    Hm, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    v, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    width = r + cfg["qk_rope_head_dim"]
    L = cfg["num_hidden_layers"]
    E = cfg.get("router_experts", cfg["num_experts"])
    prods = _products(cfg, rows)
    ops = sum(2.0 * m * kk * n for m, kk, n, _ in prods)
    weights = sum(kk * n * held * packed for _, kk, n, held in prods)
    mla = sum(not _kda(cfg, i) for i in range(L))
    ops += mla * 2.0 * rows * Hm * (nope * r + r * v)
    ops += mla * 2.0 * rows * Hm * positions * (width + r)
    weights += mla * Hm * (nope * r + r * v) * _F32
    moe = sum(_moe(cfg, i) for i in range(L))
    ops += moe * 2.0 * rows * d * E
    weights += moe * (E * d + E) * _F32
    weights += (L * 2 * d + mla * r + d) * _F32
    rec_ops, rec_bytes = _recurrence(cfg, rows)
    cache = mla * rows * (positions + 1) * width * _F32
    io = rows * d * _F32 + rows * V * _F32
    return ops + rec_ops, weights + rec_bytes + cache + io


def kernel(cfg, name: str, rows: int) -> tuple[float, float]:
    """``term_matmul``: every TR product of a step, each with its own
    input and output; ``kda``: the KDA layers' least work between their
    products (the recurrence, the convolution and their inputs and
    outputs)."""
    if name == "kda":
        return _recurrence(cfg, rows)
    if name != "term_matmul":
        raise KeyError(name)
    packed = _FORMAT_BYTES[cfg["serving"]["pack"]]
    ops = nbytes = 0.0
    for m, kk, n, held in _products(cfg, rows):
        o, b = matmul(m, kk, n, packed * held)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
