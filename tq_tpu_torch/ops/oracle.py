"""Slow, obviously-correct NumPy oracle for term revealing.

Port of ``tq_tpu.ops.oracle``, kept as the port's own copy (it is NumPy
only).  It re-implements the *behaviour* of the reference CUDA kernel
(``kernels/tr_cuda_kernel.cu:59-125``) as straight-line Python/NumPy: the
MSB-down HESE automaton and the sequential k-way greedy merge for
group-wise top-alpha selection.  It is the golden model of the port's
tests of ``tr_quantize`` and its plain versions, never on a hot path.

Written from the behavioural spec in SURVEY.md §2.1; deliberately structured
differently from the CUDA code (list-based, no fixed-capacity arrays).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["hese_encode_oracle", "term_reveal_oracle"]


def hese_encode_oracle(value: float, sf: float, bits: int) -> List[int]:
    """HESE-encode one scalar; returns signed terms in decreasing |magnitude|.

    Mirrors ``tr_cuda_kernel.cu:15-56``: uniform-quantize
    ``q = min(int(|x|/sf + 0.5), 2**bits - 1)`` (truncating cast, i.e.
    round-half-up on the magnitude), keep the sign separately, then run the
    3-bit sliding-window automaton from the MSB down.
    """
    maxq = 2**bits - 1
    q = min(int(abs(value) / sf + 0.5), maxq)
    sign = -1 if value < 0 else 1

    terms: List[int] = []
    i = q.bit_length()  # scanning above the MSB first emits nothing
    while i >= 0:
        b0 = (q >> (i - 1)) & 1 if i > 0 else 0
        b1 = (q >> i) & 1
        b2 = (q >> (i + 1)) & 1
        if (b2, b1, b0) == (0, 1, 0):
            terms.append(sign * (1 << i))
            i -= 1  # skip the (zero) bit below
        elif (b2, b1, b0) == (0, 1, 1):
            terms.append(sign * (1 << (i + 1)))
        elif (b2, b1, b0) == (1, 1, 0):
            terms.append(-sign * (1 << i))
        i -= 1
    return terms


def term_reveal_oracle(
    x: np.ndarray,
    sf: float,
    bits: int,
    group_size: int,
    num_keep_terms: int,
) -> np.ndarray:
    """Group-wise top-alpha term revealing over the last axis of ``x``.

    Groups are ``group_size`` consecutive elements along the last axis
    (the reference groups along dim 1 of a BCWH tensor at fixed b, w, h —
    ``tr_cuda_kernel.cu:80-90``; callers of this oracle move/flatten the
    grouping axis to the back).  Per group, repeatedly take the term of
    largest magnitude among the group's per-element term lists (ties:
    lowest element index first, matching the strict ``>`` comparison at
    ``tr_cuda_kernel.cu:99``), stopping after ``num_keep_terms`` terms or
    when no terms remain.  Output is the kept terms summed per element and
    multiplied by ``sf``.

    If the trailing axis is not divisible by ``group_size`` the remainder
    forms a short final group (the reference would read out of bounds here;
    we define the behaviour instead — SURVEY.md §2.1 quirk list).
    """
    x = np.asarray(x, dtype=np.float64)
    flat = x.reshape(-1, x.shape[-1])
    out = np.zeros_like(flat)
    n = x.shape[-1]
    for r in range(flat.shape[0]):
        for g0 in range(0, n, group_size):
            idx = range(g0, min(g0 + group_size, n))
            term_lists = [hese_encode_oracle(flat[r, i], sf, bits) for i in idx]
            heads = [0] * len(term_lists)
            for _ in range(num_keep_terms):
                best_j, best_val = -1, 0
                for j, tl in enumerate(term_lists):
                    t = tl[heads[j]] if heads[j] < len(tl) else 0
                    if abs(t) > abs(best_val):
                        best_val, best_j = t, j
                if best_val == 0:
                    break
                out[r, g0 + best_j] += best_val
                heads[best_j] += 1
    return (out * sf).reshape(x.shape).astype(x.dtype)
