"""Kimi Delta Attention (KDA): the linear-attention layer of Kimi-Linear.

For one token ``x`` (normed, width d) a layer of H heads of key and value
width D (P = H·D) computes

* ``q = SiLU(conv(q_proj x))``, and k and v alike, each ``conv`` a causal
  depthwise convolution over time (kernel K, no bias) whose last K - 1
  inputs per channel are the session's convolution tail;
* per head ``q ← l2norm(q)·D^-0.5``, ``k ← l2norm(k)`` (``x / sqrt(Σx² +
  1e-6)``);
* the decay ``g = −exp(A_log_h)·softplus(f_b_proj(f_a_proj x) + dt_bias)``
  (H, D), and ``β = sigmoid(b_proj x)`` (H,);
* per head, the state S (D, D): ``S' = Diag(exp g) S``, then ``S ← S' +
  β k (v − S'ᵀk)ᵀ``, and ``o = Sᵀq``;
* ``o ← RMSNorm_h(o)·w_o·sigmoid(g_b_proj(g_a_proj x))`` per head, then
  ``o_proj``.

Two forms compute it:

* :func:`kda_step`, one token of every session, updates the float32 state
  (B, H, D, D) and the convolution tail (B, 3P, K - 1) in place: one
  batched product reads S for both ``S'ᵀk`` and ``S'ᵀq`` (``S'ᵀx =
  Sᵀ(exp(g)⊙x)``), then S is decayed and the rank-one update added, and
  ``o = S'ᵀq + δ (kᵀq)`` with ``δ = β(v − S'ᵀk)``, so S is read three
  times and written twice a token;
* :func:`kda_prefill`, whole prompts, takes the chunked (WY) form: within
  a chunk of C positions, with ``G`` the chunk's running sum of ``g``,
  every decay between two positions is ``exp(G_t − G_s)`` (s ≤ t, never
  above 1: no product ``exp(G_t)·exp(−G_s)``, which overflows at strong
  decays; the difference summed over (s, t] itself, not taken from two
  large running sums), the chunk's deltas solve one unit lower-triangular
  system, and the state passes from chunk to chunk.  It gives the state and the
  outputs that the recurrence gives, to float32's rounding.

The layer's input projections and ``o_proj`` are the caller's products
(``dense(name, params, rows)``, a :class:`~tq_tpu_torch.layers.qctx.
QuantCtx`'s); between them the work runs under the span ``tq.kda.recur``
(device).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tq_tpu_torch.utils.trace import span

__all__ = ["kda_step", "kda_prefill", "recur_step", "chunked", "short_conv",
           "short_conv_step", "decay", "CHUNK"]

# Positions a chunk of the prefill's chunked form: on an H100, 8 sessions
# of 1,024 tokens at 32 heads of 128 take 23.8 ms in chunks of 16, 36.2
# in 32 and 64.3 in 64 (the within-chunk decays grow as C²).
CHUNK = 16
# Elements of the (chunks, C, C, D) decays that one pass of the chunked
# form holds (float32: 1 GiB).
_DECAY_ELEMS = 1 << 28
_L2_EPS = 1e-6

Dense = Callable[[str, dict, torch.Tensor], torch.Tensor]


def decay(f: torch.Tensor, A_log: torch.Tensor, dt_bias: torch.Tensor,
          heads: int) -> torch.Tensor:
    """The log-decay ``−exp(A_log_h)·softplus(f + dt_bias)`` of the rows'
    ``f`` (..., P), as (..., H, D)."""
    f = (f + dt_bias).unflatten(-1, (heads, -1))
    return -torch.exp(A_log)[:, None] * F.softplus(f)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + _L2_EPS)


def short_conv(x: torch.Tensor, w: torch.Tensor,
               tail: torch.Tensor | None = None):
    """The causal depthwise convolution of ``x`` (b, T, C) with ``w`` (C,
    K) after ``tail`` (b, C, K - 1), the K - 1 inputs before ``x`` (zeros
    where None): (y (b, T, C), the new tail (b, C, K - 1))."""
    b, T, C = x.shape
    K = w.shape[1]
    head = (x.new_zeros(b, K - 1, C) if tail is None
            else tail.transpose(1, 2))
    xp = torch.cat([head, x], 1)
    y = xp[:, :T] * w[:, 0]
    for j in range(1, K):
        y = y + xp[:, j:j + T] * w[:, j]
    return y, xp[:, T:].transpose(1, 2).contiguous()


def short_conv_step(x: torch.Tensor, w: torch.Tensor,
                    tail: torch.Tensor) -> torch.Tensor:
    """One step of :func:`short_conv`: ``x`` (B, C) after ``tail`` (B, C,
    K - 1), which it moves on by one input in place."""
    window = torch.cat([tail, x[..., None]], -1)
    tail.copy_(window[..., 1:])
    return (window * w).sum(-1)


def recur_step(q, k, v, g, beta, state: torch.Tensor) -> torch.Tensor:
    """One token of the recurrence: q, k, g (B, H, D), v (B, H, Dv), beta
    (B, H); ``state`` (B, H, D, Dv), contiguous, updated in place.  The
    output (B, H, Dv)."""
    B, H, D = k.shape
    Dv = v.shape[-1]
    a = torch.exp(g)
    s = state.view(B * H, D, Dv)
    r = torch.bmm(torch.stack([a * k, a * q], 2).view(B * H, 2, D), s)
    delta = beta.reshape(B * H, 1) * (v.reshape(B * H, Dv) - r[:, 0])
    s.mul_(a.reshape(B * H, D, 1)).addcmul_(k.reshape(B * H, D, 1),
                                            delta[:, None, :])
    o = r[:, 1] + delta * (k * q).sum(-1).reshape(B * H, 1)
    return o.view(B, H, Dv)


def _blocks(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """(b, T, H, ...) -> (b, H, n, C, ...), T padded with zeros to n·C."""
    b, T, H = x.shape[:3]
    pad = n * chunk - T
    if pad:
        x = torch.cat([x, x.new_zeros(b, pad, *x.shape[2:])], 1)
    return x.reshape(b, n, chunk, H, *x.shape[3:]).movedim(3, 1)


def _within(q, k, g):
    """Of chunks q, k, g (b, H, n, C, D): A (strictly lower) and M
    (lower, diagonal included), (b, H, n, C, C), ``Σ_c x_t,c k_s,c
    exp(G_t,c − G_s,c)`` for s below (A, x = k) or at or below (M, x = q)
    t, and ``exp(G_C − G_s)`` (b, H, n, C, D), the decay from each
    position to the chunk's end.  Each difference ``G_t − G_s`` is the
    sum of g over (s, t] (a running sum of the chunk's g masked to s < r,
    as accurate at any decay as g itself), in passes of at most
    ``_DECAY_ELEMS`` decays."""
    b, H, n, C, D = k.shape
    ts = torch.ones(C, C, dtype=torch.bool, device=k.device)
    above, incl = ts.tril(-1)[:, :, None], ts.tril()[:, :, None]
    A = k.new_empty(b, H, n, C, C)
    M = k.new_empty(b, H, n, C, C)
    to_end = k.new_empty(b, H, n, C, D)
    per = max(1, _DECAY_ELEMS // (b * H * C * C * D))
    for j in range(0, n, per):
        sl = slice(j, min(n, j + per))
        kj = k[:, :, sl]
        # d[t, s] = Σ_{s < r <= t} g_r: g_t where t > s, summed along t.
        d = (g[:, :, sl][..., :, None, :] * above).cumsum(-3).exp_()
        to_end[:, :, sl] = d[..., -1, :, :]
        d.masked_fill_(~incl, 0).mul_(kj[..., None, :, :])   # · k_s
        A[:, :, sl] = torch.matmul(d, kj[..., None]).squeeze(-1)
        M[:, :, sl] = torch.matmul(d, q[:, :, sl][..., None]).squeeze(-1)
    return A.tril_(-1), M, to_end


def chunked(q, k, v, g, beta, state: torch.Tensor | None = None,
            chunk: int = CHUNK):
    """The recurrence over whole sequences in chunks of ``chunk``
    positions: q, k, g (b, T, H, D), v (b, T, H, Dv), beta (b, T, H);
    ``state`` (b, H, D, Dv) before the first position, zeros where None.
    Returns (o (b, T, H, Dv), the state after the last position)."""
    b, T, H, D = k.shape
    Dv = v.shape[-1]
    n = -(-T // chunk)
    q, k, v, g = (_blocks(t, n, chunk) for t in (q, k, v, g))
    beta = _blocks(beta, n, chunk)                      # (b, H, n, C)
    A, M, to_end = _within(q, k, g)
    eG = g.cumsum(-2).exp()
    eye = torch.eye(chunk, device=k.device)
    tri = eye + beta[..., :, None] * A
    rhs = torch.cat([beta[..., None] * k * eG, beta[..., None] * v], -1)
    sol = torch.linalg.solve_triangular(tri, rhs, upper=False,
                                        unitriangular=True)
    W, U0 = sol[..., :D], sol[..., D:]
    Qd = q * eG
    Kd = (k * to_end).transpose(-1, -2)
    last = eG[..., -1, :, None]                         # (b, H, n, D, 1)
    S = (k.new_zeros(b, H, D, Dv) if state is None
         else state.to(torch.float32))
    out = v.new_empty(b, H, n, chunk, Dv)
    for j in range(n):
        U = U0[:, :, j] - W[:, :, j] @ S
        out[:, :, j] = Qd[:, :, j] @ S + M[:, :, j] @ U
        S = last[:, :, j] * S + Kd[:, :, j] @ U
    o = out.movedim(1, 3).reshape(b, n * chunk, H, Dv)[:, :T]
    return o, S


# ----------------------------------------------------------------- layer


def _project(dense: Dense, p: dict, pre: str, a: torch.Tensor):
    """The layer's input products on the rows ``a`` (N, d): q, k, v
    side by side (N, 3P), the decay's and the output gate's low-rank
    pairs (N, P) and β's logits (N, H)."""
    def lin(name, x):
        return dense(f"{pre}.{name}", p[f"{pre}.{name}"], x)

    qkv = torch.cat([lin("q_proj", a), lin("k_proj", a), lin("v_proj", a)],
                    -1)
    return (qkv, lin("f_b_proj", lin("f_a_proj", a)), lin("b_proj", a),
            lin("g_b_proj", lin("g_a_proj", a)))


def _conv_weight(p: dict, pre: str) -> torch.Tensor:
    return torch.cat([p[f"{pre}.{x}_conv1d"]["w"] for x in "qkv"])


def _features(p: dict, pre: str, qkv: torch.Tensor, f: torch.Tensor,
              b: torch.Tensor, heads: int):
    """q, k, v (..., H, D) from the convolved ``qkv``; g (..., H, D),
    β (..., H)."""
    q, k, v = F.silu(qkv).unflatten(-1, (3, heads, -1)).unbind(-3)
    q = _l2norm(q) * q.shape[-1] ** -0.5
    g = decay(f, p[f"{pre}.A_log"]["w"], p[f"{pre}.dt_bias"]["w"], heads)
    return q, _l2norm(k), v, g, torch.sigmoid(b)


def _gated_norm(p: dict, pre: str, o: torch.Tensor, gate: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``RMSNorm_h(o)·w_o·sigmoid(gate)`` of o (..., H, D), flattened to
    (..., P)."""
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps)
    gate = gate.unflatten(-1, o.shape[-2:])
    return (o * p[f"{pre}.o_norm"]["scale"]
            * torch.sigmoid(gate)).flatten(-2)


def kda_step(dense: Dense, p: dict, pre: str, a: torch.Tensor, heads: int,
             eps: float, state: torch.Tensor,
             tail: torch.Tensor) -> torch.Tensor:
    """The attention module ``pre`` on one token a session, the normed
    rows ``a`` (B, d): its output (B, d).  ``state`` (B, H, D, D) and
    ``tail`` (B, 3P, K - 1) move on by the token in place."""
    qkv, f, b, gate = _project(dense, p, pre, a)
    with span("tq.kda.recur", device=a.is_cuda):
        qkv = short_conv_step(qkv, _conv_weight(p, pre), tail)
        q, k, v, g, beta = _features(p, pre, qkv, f, b, heads)
        o = _gated_norm(p, pre, recur_step(q, k, v, g, beta, state), gate,
                        eps)
    return dense(f"{pre}.o_proj", p[f"{pre}.o_proj"], o)


def kda_prefill(dense: Dense, p: dict, pre: str, a: torch.Tensor,
                heads: int, eps: float):
    """The attention module ``pre`` on whole prompts, the normed rows
    ``a`` (b, T, d) from an empty state: (output (b, T, d), the state (b,
    H, D, D) and the convolution tail (b, 3P, K - 1) after position T -
    1)."""
    bsz, T, d = a.shape
    qkv, f, b, gate = _project(dense, p, pre, a.reshape(bsz * T, d))
    with span("tq.kda.recur", device=a.is_cuda):
        qkv, tail = short_conv(qkv.view(bsz, T, -1), _conv_weight(p, pre))
        q, k, v, g, beta = _features(p, pre, qkv, f.view(bsz, T, -1),
                                     b.view(bsz, T, -1), heads)
        o, state = chunked(q, k, v, g, beta)
        o = _gated_norm(p, pre, o, gate.view(bsz, T, -1), eps)
    out = dense(f"{pre}.o_proj", p[f"{pre}.o_proj"], o.reshape(bsz * T, -1))
    return out.view(bsz, T, d), state, tail
