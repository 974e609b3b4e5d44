"""Term reveal from its definition.

A value ``x`` with scale ``sf`` is uniformly quantized to the magnitude
``q = min(floor(|x| / sf + 0.5), 2**bits - 1)``.  ``q`` is written in
HESE signed digits: the digit at plane ``p`` (magnitude ``2**p``) is a
function of bits ``p+1, p, p-1, p-2`` of ``q``,

    +1  iff  (~b[p+1] & b[p] & ~b[p-1])  or  (~b[p] & b[p-1] & b[p-2])
    -1  iff  ( b[p+1] & b[p] & ~b[p-1])

Along one axis, groups of ``group`` consecutive elements (the last one
padded with zeros) keep their ``budget`` largest terms: a term at
(element e, plane p) survives iff the group's terms at planes above p,
plus its terms at plane p in elements before e, number fewer than the
budget.  The result is ``sign(x) * kept * sf`` in float32.
"""

from __future__ import annotations

import torch

# Elements of a weight that one selection pass holds (its digit planes
# and their running counts are several int32 tensors of this size).
_CHUNK_ELEMS = 1 << 23


def quantize(x: torch.Tensor, sf: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 ``min(floor(|x| / sf + 0.5), 2**bits - 1)``."""
    q = torch.floor(x.abs() / sf + 0.5)
    return torch.clamp(q, 0, 2**bits - 1).to(torch.int64)


def digit_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """``q.shape + (bits + 1,)`` HESE digits in {-1, 0, +1}, int32."""

    def bit(k):
        return (q >> k) & 1 if k >= 0 else torch.zeros_like(q)

    planes = []
    for p in range(bits + 1):
        up, cur, dn1, dn2 = bit(p + 1), bit(p), bit(p - 1), bit(p - 2)
        pos = ((1 - up) & cur & (1 - dn1)) | ((1 - cur) & dn1 & dn2)
        neg = up & cur & (1 - dn1)
        planes.append(pos - neg)
    return torch.stack(planes, dim=-1).to(torch.int32)


def keep_largest(planes: torch.Tensor, budget: int) -> torch.Tensor:
    """Integer value of the ``budget`` largest terms of each group of
    ``(..., group, planes)`` digits, per element: ``(..., group)``."""
    present = planes.abs()
    per_plane = present.sum(dim=-2, keepdim=True)
    above = per_plane.flip(-1).cumsum(-1).flip(-1) - per_plane
    before = present.cumsum(-2) - present
    kept = torch.where((above + before < budget) & (present > 0), planes,
                       torch.zeros_like(planes))
    weights = 2 ** torch.arange(planes.shape[-1], device=planes.device,
                                dtype=torch.int64)
    return (kept.to(torch.int64) * weights).sum(dim=-1)


def kept_table(bits: int, budget: int, device=None) -> torch.Tensor:
    """float32 kept value of every magnitude ``0 .. 2**bits - 1`` alone
    (a group of one)."""
    q = torch.arange(2**bits, dtype=torch.int64, device=device)
    return keep_largest(digit_planes(q, bits)[:, None, :],
                        budget)[:, 0].to(torch.float32)


def reveal_elementwise(x: torch.Tensor, sf: torch.Tensor, bits: int,
                       budget: int, table: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Term reveal with groups of one element (the activations')."""
    if table is None:
        table = kept_table(bits, budget, x.device)
    kept = table[quantize(x, sf, bits)]
    sign = torch.where(x < 0, -1.0, 1.0)
    return sign * kept * sf


def reveal_grouped(x: torch.Tensor, sf: torch.Tensor, bits: int,
                   group: int, budget: int, axis: int) -> torch.Tensor:
    """Term reveal in groups of ``group`` along ``axis`` (the weights')."""
    moved = torch.movedim(x, axis, -1)
    n = moved.shape[-1]
    rows = moved.reshape(-1, n)
    pad = -n % group
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    width = rows.shape[1]
    step = max(1, _CHUNK_ELEMS // (width * (bits + 1)))
    kept = torch.cat([
        keep_largest(digit_planes(quantize(block, sf, bits), bits)
                     .reshape(block.shape[0], width // group, group, -1),
                     budget).reshape(block.shape[0], width)
        for block in rows.split(step)])[:, :n]
    sign = torch.where(moved < 0, -1.0, 1.0)
    out = sign * kept.to(torch.float32).reshape(moved.shape) * sf
    return torch.movedim(out, -1, axis)


def weight_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    """A weight's scale: ``max|w| / 2**(bits - 1)``."""
    return w.abs().max() / (2 ** (bits - 1))


def reveal_weight(w: torch.Tensor, bits: int, group: int, budget: int,
                  axis: int) -> torch.Tensor:
    """A weight term-revealed at its own scale along its input axis."""
    sf = weight_scale(w, bits)
    if group == 1:
        return reveal_elementwise(w, sf, bits, budget)
    return reveal_grouped(w, sf, bits, group, budget, axis)
