"""DeepSeek-V3's work at a configuration's shapes: one decode step of
``rows`` sequences, each attending over ``positions`` cache entries,
weights in the served format (the 9-bit pack of every linear, the decoded
float32 ``kv_b_proj`` heads of the absorbed attention, the float32
router, norms and embedding)."""

from __future__ import annotations

from benchmark.roofline import matmul

_F32 = 4
_FORMAT_BYTES = {"u8s": 9 / 8, "int8": 1, "int16": 2, "f32": 4}


def _moe(cfg, i: int) -> bool:
    return (cfg["n_routed_experts"] > 0 and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def mean_positions(traffic) -> float:
    """The cache entries a step attends over, on average: positions
    ``context`` .. ``context + steps - 1`` each see themselves and every
    earlier one."""
    return traffic["context"] + (traffic["steps"] + 1) / 2


def _products(cfg, rows: int):
    """(rows, in, out, experts whose weights are read) of every TR
    product of a step: a routed expert's product counts every (row,
    slot) pair routed and ``min(E, k * rows)`` experts' weights."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    w, shared = cfg["moe_intermediate_size"], cfg["n_shared_experts"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        out += [(rows, d, H * (nope + rope), 1), (rows, d, r + rope, 1),
                (rows, H * v, d, 1)]
        if _moe(cfg, i):
            held = min(E, k * rows)
            out += [(k * rows, d, w, held)] * 2 + [(k * rows, w, d, held)]
            out += [(rows, d, w * shared, 1)] * 2
            out += [(rows, w * shared, d, 1)]
        else:
            I = cfg["intermediate_size"]
            out += [(rows, d, I, 1), (rows, d, I, 1), (rows, I, d, 1)]
    out.append((rows, d, cfg["vocab_size"], 1))
    return out


def step(cfg, rows: int, positions: float) -> tuple[float, float]:
    """Every product of the step and its attention over ``positions``
    entries; bytes: the packed weights (``min(E, k * rows)`` experts a
    layer), the decoded ``kv_b_proj`` heads, the router, the norms, the
    cache read and the entries written, the embedding rows in and the
    log-probabilities out."""
    packed = _FORMAT_BYTES[cfg["serving"]["pack"]]
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, v, r = (cfg["qk_nope_head_dim"], cfg["v_head_dim"],
                  cfg["kv_lora_rank"])
    width = r + cfg["qk_rope_head_dim"]
    L, E, V = cfg["num_hidden_layers"], cfg["n_routed_experts"], \
        cfg["vocab_size"]
    prods = _products(cfg, rows)
    ops = sum(2.0 * m * kk * n for m, kk, n, _ in prods)
    weights = sum(kk * n * held * packed for _, kk, n, held in prods)
    # The absorbed attention: W_UKᵀ and W_UV, then the scores over
    # [c, k_pe] and the latent weighted sum.
    ops += L * 2.0 * rows * H * (nope * r + r * v)
    ops += L * 2.0 * rows * H * positions * (width + r)
    weights += L * H * (nope * r + r * v) * _F32
    moe_layers = sum(_moe(cfg, i) for i in range(L))
    ops += moe_layers * 2.0 * rows * d * E
    weights += moe_layers * (E * d + E) * _F32
    weights += (L * (2 * d + r) + d) * _F32
    cache = L * rows * (positions + 1) * width * _F32
    io = rows * d * _F32 + rows * V * _F32
    return ops, weights + cache + io


def kernel(cfg, name: str, rows: int) -> tuple[float, float]:
    """``term_matmul``: every TR product of a step (not the absorbed
    attention's float products), each with its own input and output."""
    if name != "term_matmul":
        raise KeyError(name)
    packed = _FORMAT_BYTES[cfg["serving"]["pack"]]
    ops = nbytes = 0.0
    for m, kk, n, held in _products(cfg, rows):
        o, b = matmul(m, kk, n, packed * held)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
