"""The LSTM language model's work at a configuration's shapes: one
decoding step of ``rows`` sequences, weights in the served formats."""

from __future__ import annotations

from benchmark.roofline import matmul

_F32 = 4
# Bytes a weight of each served format takes.
_FORMAT_BYTES = {"u8s": 9 / 8, "int8": 1, "int16": 2, "f32": 4}


def _products(cfg):
    """(in, out, bytes a weight, is a TR product) of each product."""
    E, H, V = cfg["emsize"], cfg["nhid"], cfg["vocab"]
    packed = _FORMAT_BYTES[cfg["serving"]["pack"]]
    quantized = set(cfg["serving"]["quantize_layers"])
    out = []
    for layer in range(cfg["nlayers"]):
        tr = layer in quantized
        wb = packed if tr else _F32
        out.append((E if layer == 0 else H, 4 * H, wb, tr))
        out.append((H, 4 * H, wb, tr))
    out.append((H, V, packed, True))
    return out


def step(cfg, rows: int) -> tuple[float, float]:
    """Every product of the step; its weights and biases, the embedding
    rows, the hidden state in and out and the log-probabilities."""
    E, H, V, L = cfg["emsize"], cfg["nhid"], cfg["vocab"], cfg["nlayers"]
    prods = _products(cfg)
    ops = sum(2.0 * rows * k * n for k, n, _, _ in prods)
    weights = sum(k * n * wb for k, n, wb, _ in prods)
    biases = (2 * L * 4 * H + V) * _F32
    io = rows * (E + 2 * 2 * L * H + V) * _F32
    return ops, weights + biases + io


def kernel(cfg, name: str, rows: int) -> tuple[float, float]:
    """``term_matmul``: every TR product of a step, each with its own
    input and output."""
    if name != "term_matmul":
        raise KeyError(name)
    parts = [matmul(rows, k, n, wb) for k, n, wb, tr in _products(cfg) if tr]
    return sum(o for o, _ in parts), sum(b for _, b in parts)
