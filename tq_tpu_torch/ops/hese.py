"""HESE (hybrid encoding of signed expressions) as bit-plane math on tensors.

Port of ``tq_tpu.ops.hese``.  The reference automaton scans a non-negative
integer ``q`` from the top bit with a 3-bit window and emits signed
power-of-two terms; the digit at magnitude position ``p`` is a pure
function of bits ``(p+1, p, p-1, p-2)`` of ``q``:

    d_p = +1  iff  (~b[p+1] &  b[p] & ~b[p-1])  or  (~b[p] & b[p-1] & b[p-2])
    d_p = -1  iff  ( b[p+1] &  b[p] & ~b[p-1])

(bits below index 0 are zero), so ``q == sum_p d_p * 2**p``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "num_planes",
    "hese_digit_planes",
    "hese_digit_planes_np",
    "binary_digit_planes",
    "hese_terms_count",
    "transition_merge_terms_np",
]


def num_planes(bits: int) -> int:
    """Digit planes needed for values in ``[0, 2**bits - 1]``: ``bits + 1``."""
    return bits + 1


def _bit(q: torch.Tensor, k: int) -> torch.Tensor:
    """Bit ``k`` of int32 ``q`` (0 for negative k)."""
    if k < 0:
        return torch.zeros_like(q)
    return (q >> k) & 1


def hese_digit_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 ``q.shape + (bits + 1,)`` signed digits in {-1, 0, +1};
    plane ``p`` carries magnitude ``2**p``."""
    q = q.to(torch.int32)
    planes = []
    for p in range(num_planes(bits)):
        b_up, b_cur = _bit(q, p + 1), _bit(q, p)
        b_dn1, b_dn2 = _bit(q, p - 1), _bit(q, p - 2)
        pos = ((1 - b_up) & b_cur & (1 - b_dn1)) | ((1 - b_cur) & b_dn1 & b_dn2)
        neg = b_up & b_cur & (1 - b_dn1)
        planes.append(pos - neg)
    return torch.stack(planes, dim=-1).to(torch.int32)


def hese_digit_planes_np(q: np.ndarray, bits: int) -> np.ndarray:
    """NumPy twin of :func:`hese_digit_planes` (for host-side tooling)."""
    q = np.asarray(q, dtype=np.int64)
    T = num_planes(bits)
    out = np.zeros(q.shape + (T,), dtype=np.int32)
    for p in range(T):
        b_up = (q >> (p + 1)) & 1
        b_cur = (q >> p) & 1
        b_dn1 = (q >> (p - 1)) & 1 if p >= 1 else np.zeros_like(q)
        b_dn2 = (q >> (p - 2)) & 1 if p >= 2 else np.zeros_like(q)
        pos = ((1 - b_up) & b_cur & (1 - b_dn1)) | ((1 - b_cur) & b_dn1 & b_dn2)
        neg = b_up & b_cur & (1 - b_dn1)
        out[..., p] = pos - neg
    return out


def binary_digit_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain binary bit planes: plane ``p`` is bit ``p`` of ``q``."""
    q = q.to(torch.int32)
    return torch.stack([_bit(q, p) for p in range(num_planes(bits))],
                       dim=-1).to(torch.int32)


def transition_merge_terms_np(q) -> np.ndarray:
    """Term counts of the reference's root-level ``hese()`` with its
    "merging neighbors hack" -- the counter behind the published
    compressed-HESE ``param_bits``:

        terms(q) = 2 * (#maximal 1-runs of |q|) - (#length-1 runs)

    Returns an int64 array of ``q``'s shape.
    """
    q = np.abs(np.asarray(q, dtype=np.int64))
    starts = q & ~(q << 1)          # bit set, bit below clear: run start
    singles = starts & ~(q >> 1)    # ... and bit above clear: length-1 run
    nbits = int(q.max()).bit_length() if q.size else 0
    runs = np.zeros(q.shape, dtype=np.int64)
    ones = np.zeros(q.shape, dtype=np.int64)
    for p in range(nbits):
        runs += (starts >> p) & 1
        ones += (singles >> p) & 1
    return 2 * runs - ones


def hese_terms_count(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Number of HESE terms per element (Hamming weight of the digit planes)."""
    return hese_digit_planes(q, bits).abs().sum(dim=-1)
