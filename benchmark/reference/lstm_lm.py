"""The word-level LSTM language model (pytorch/examples'
``word_language_model``; Zaremba et al. 2014), term-revealed, in plain
float32 PyTorch.

Embedding (vocab, emsize) -> ``nlayers`` LSTM layers (gates i, f, g, o;
weights (in, 4 hidden)) -> a decoder tied to the embedding -> log-softmax.
The conversion term-reveals the first layer's input and recurrent
weights and the decoder's (the embedding's transpose) in groups along
their input axis.  One activation quantizer, shared, takes the step's
embedding and every layer's incoming h and c: phase 1 adds them to its
histogram (embedding, then h, then c), phase 2 term-reveals them per
element.  The decoder multiplies its raw input.  ``tf32`` rounds every
product's operands to TF32: the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import calibration, term_reveal
from benchmark.reference.compare import gap
from benchmark.reference.precision import operand


def make_params(cfg, generator: torch.Generator, device) -> dict:
    """Seeded weights in one draw: a Uniform(-0.1, 0.1) embedding,
    Uniform(-1/sqrt(H), 1/sqrt(H)) recurrent layers (per layer w_ih,
    w_hh, b_ih, b_hh), a zero decoder bias."""
    V, E, H, L = (cfg["vocab"], cfg["emsize"], cfg["nhid"], cfg["nlayers"])
    shapes = [(E if i == 0 else H, 4 * H) for i in range(L)]
    n_rnn = sum(k * n + H * n + 2 * n for k, n in shapes)
    u = torch.rand(V * E + n_rnn, generator=generator, device=device)
    params = {"encoder": {"w": u[:V * E].view(V, E) * 0.2 - 0.1}}
    at, bound, layers = V * E, 1.0 / math.sqrt(H), []
    for k, n in shapes:
        layer = {}
        for key, shape in (("w_ih", (k, n)), ("w_hh", (H, n)),
                           ("b_ih", (n,)), ("b_hh", (n,))):
            size = math.prod(shape)
            layer[key] = u[at:at + size].view(shape) * (2 * bound) - bound
            at += size
        layers.append(layer)
    params["rnn"] = layers
    params["decoder"] = {"b": torch.zeros(V, device=device)}
    return params


def zipf_stream(cfg, generator: torch.Generator, device) -> torch.Tensor:
    """(chunks * bptt + 1, batch) int64 tokens whose ids have Zipf (s = 1)
    frequencies: id k with weight 1 / (k + 1)."""
    c = cfg["calibration"]
    rows = c["chunks"] * c["bptt"] + 1
    w = 1.0 / torch.arange(1, cfg["vocab"] + 1, dtype=torch.float64,
                           device=device)
    cdf = torch.cumsum(w, 0) / w.sum()
    u = torch.rand(rows * c["batch"], generator=generator, device=device,
                   dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp(max=cfg["vocab"] - 1)
    return ids.view(rows, c["batch"])


def convert(params, cfg) -> dict:
    """Term-revealed weights: the first layer's ``w_ih`` and ``w_hh`` and
    the decoder's (hidden, vocab)."""
    tr = cfg["tr"]
    args = (tr["weight_bits"], tr["group_size"], tr["weight_terms"])
    first = params["rnn"][0]
    return {"w_ih": term_reveal.reveal_weight(first["w_ih"], *args, axis=0),
            "w_hh": term_reveal.reveal_weight(first["w_hh"], *args, axis=0),
            "decoder": term_reveal.reveal_weight(params["encoder"]["w"].T,
                                                 *args, axis=0)}


def _weights(params, conv, layer: int):
    p = params["rnn"][layer]
    if layer == 0:
        return conv["w_ih"], conv["w_hh"], p["b_ih"], p["b_hh"]
    return p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"]


def _cell(x, h, c, w_ih, w_hh, b_ih, b_hh, tf32):
    H = h.shape[-1]
    gates = (operand(x, tf32) @ operand(w_ih, tf32) + b_ih
             + operand(h, tf32) @ operand(w_hh, tf32) + b_hh)
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H:2 * H])
    g = torch.tanh(gates[:, 2 * H:3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _layers(params, conv, x, h, c, tf32):
    """One step through the stack: (top output, new h, new c)."""
    hs, cs = [], []
    for layer in range(len(params["rnn"])):
        x, c_new = _cell(x, h[layer], c[layer], *_weights(params, conv, layer),
                         tf32)
        hs.append(x)
        cs.append(c_new)
    return x, torch.stack(hs), torch.stack(cs)


def calibrate(params, conv, cfg, stream: torch.Tensor,
              tf32: bool = False) -> torch.Tensor:
    """Phase 1 over the stream's bptt chunks, the hidden state carried
    from chunk to chunk, then the scale search: the shared quantizer's
    scale."""
    c_cfg, tr = cfg["calibration"], cfg["tr"]
    H, L = cfg["nhid"], cfg["nlayers"]
    B = stream.shape[1]
    hist = calibration.new_histogram(stream.device)
    h = torch.zeros(L, B, H, device=stream.device)
    c = torch.zeros_like(h)
    for k in range(c_cfg["chunks"]):
        tokens = stream[k * c_cfg["bptt"]:(k + 1) * c_cfg["bptt"]]
        emb = params["encoder"]["w"][tokens]
        for part in (emb, h, c):
            hist = calibration.add_to_histogram(hist, part)
        for t in range(tokens.shape[0]):
            _, h, c = _layers(params, conv, emb[t], h, c, tf32)
    return calibration.search_scale(hist, tr["data_bits"], tr["data_terms"])


def step(params, conv, sf, cfg, tokens: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, tf32: bool = False, table=None):
    """One step of ``tokens`` (R,) from the state ``h``, ``c`` (layers, R,
    hidden): (log-probabilities (R, vocab), new h, new c)."""
    tr = cfg["tr"]
    bits, terms = tr["data_bits"], tr["data_terms"]
    if table is None:
        table = term_reveal.kept_table(bits, terms, tokens.device)
    emb, hq, cq = (term_reveal.reveal_elementwise(v, sf, bits, terms, table)
                   for v in (params["encoder"]["w"][tokens], h, c))
    top, h, c = _layers(params, conv, emb, hq, cq, tf32)
    logits = (operand(top, tf32) @ operand(conv["decoder"], tf32)
              + params["decoder"]["b"])
    return torch.log_softmax(logits, dim=-1), h, c


def zero_state(cfg, rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    h = torch.zeros(cfg["nlayers"], rows, cfg["nhid"], device=device)
    return h, torch.zeros_like(h)


def gumbel(seed: int, steps: int, vocab: int, device) -> torch.Tensor:
    """(steps, vocab) float64 Gumbel noise of a sampled request seeded
    ``seed``: the sampling rule's own draw (a torch generator on
    ``device`` seeded ``seed``, one ``rand(vocab)`` a step, floored at
    float32's ``tiny``), so that the token served at step t is the
    argmax of log-probability / temperature + noise[t]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([torch.rand(vocab, generator=gen, device=device)
                     for _ in range(steps)])
    return -torch.log(-torch.log(u.clamp_(min=tiny))).double()


def _widest(values: torch.Tensor) -> float:
    off = float(values.abs().max()) if values.numel() else 0.0
    return off if off == off else float("inf")


def follow(params, conv, sf, cfg, inputs, served, rows, states,
           noise=None) -> tuple[float, float, float]:
    """Follow generation step by step from the program's own state.

    ``inputs`` (T, R): each step's token; ``served`` (T, R): the token
    each step served; ``rows`` (T, R, vocab): the program's
    log-probabilities; ``states``: the program's (h, c) after each step;
    ``noise`` (T, R, vocab), for sampled tokens: temperature times the
    sampler's Gumbel noise (:func:`gumbel`), which the served token
    maximizes with the log-probabilities.  Step t starts from the zero
    state (t = 0) or the program's state after step t - 1.  Returns (the
    widest gap between the served token's score as the program gave it,
    its best, and as the reference gives it; the widest gap between the
    program's log-probabilities and the reference's, over every column;
    the widest gap of a state from the reference's step, as a share of
    its largest magnitude)."""
    if served.numel() and not (0 <= int(served.min())
                               and int(served.max()) < cfg["vocab"]):
        return float("inf"), float("inf"), float("inf")
    tr = cfg["tr"]
    table = term_reveal.kept_table(tr["data_bits"], tr["data_terms"],
                                   inputs.device)
    h, c = zero_state(cfg, inputs.shape[1], inputs.device)
    logp_gap = row_gap = state_gap = 0.0
    for t in range(inputs.shape[0]):
        logp, h_ref, c_ref = step(params, conv, sf, cfg, inputs[t], h, c,
                                  False, table)
        got, want = rows[t].double(), logp.double()
        if noise is not None:
            got, want = got + noise[t], want + noise[t]
        taken = want.gather(1, served[t][:, None])[:, 0]
        logp_gap = max(logp_gap, _widest(got.max(-1).values - taken))
        row_gap = max(row_gap, _widest(rows[t] - logp))
        h, c = states[t]
        state_gap = max(state_gap, gap(h, h_ref), gap(c, c_ref))
    return logp_gap, row_gap, state_gap
