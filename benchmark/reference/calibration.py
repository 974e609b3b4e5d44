"""Two-phase activation calibration from its definition.

Phase 1 accumulates, for each quantized input, a float32 histogram of
8192 bins over [-50, 50] (values outside ignored, the top edge in the
last bin; the bin of ``x`` is ``floor((x + 50) * (1 / width))`` with the
reciprocal of the width taken in float32).  The scale is then the one of
2048 candidates in [1e-8, 50] whose term reveal of the bins' points has
the least histogram-weighted squared error, each product taken in
float32 and summed in float64.  Points and candidates are float32
``linspace`` values as XLA compiles them (:func:`linspace_f32`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.term_reveal import kept_table, quantize

BINS, LOW, HIGH = 8192, -50.0, 50.0
CANDIDATES, SF_MIN = 2048, 1e-8
_CHUNK = 256  # candidates whose errors one pass holds


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """float32 ``linspace`` as XLA's CPU backend evaluates it:
    ``fma(i, stop / div, start * fma(-i, 1 / div, 1))`` with ``1 / div``
    and ``stop / div`` rounded to float32, each fused multiply-add in
    float64 rounded once to float32, and ``stop`` itself last."""
    f32, f64 = np.float32, np.float64
    div = num - 1
    i = np.arange(div, dtype=f32)
    inv = f32(1.0) / f32(div)
    step = f32(inv * f32(stop))
    one_minus = (-i.astype(f64) * f64(inv) + 1.0).astype(f32)
    base = (f32(start) * one_minus).astype(f32)
    head = (i.astype(f64) * f64(step) + base.astype(f64)).astype(f32)
    return np.concatenate([head, np.asarray([stop], f32)])


def grids(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the bins' points, the scale candidates), float32."""
    return (torch.tensor(linspace_f32(LOW, HIGH, BINS), device=device),
            torch.tensor(linspace_f32(SF_MIN, HIGH, CANDIDATES),
                         device=device))


def new_histogram(device=None) -> torch.Tensor:
    return torch.zeros(BINS, dtype=torch.float32, device=device)


def add_to_histogram(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``hist`` plus the counts of ``x``, counted exactly and added as
    float32."""
    x = x.reshape(-1)
    inv_width = np.float32(1.0) / np.float32((HIGH - LOW) / BINS)
    idx = torch.floor((x - LOW) * float(inv_width)).clamp(0, BINS - 1)
    inside = (x >= LOW) & (x <= HIGH)
    counts = torch.zeros(BINS, dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx.to(torch.int64), inside.to(torch.int64))
    return hist + counts.to(torch.float32)


def search_scale(hist: torch.Tensor, bits: int, terms: int) -> torch.Tensor:
    """The candidate scale of least histogram-weighted error, a float32
    0-d tensor."""
    points, candidates = grids(hist.device)
    table = kept_table(bits, terms, hist.device)
    sign = torch.where(points < 0, -1.0, 1.0)
    errors = []
    for sf in candidates.split(_CHUNK):
        sf = sf[:, None]
        approx = sign * table[quantize(points[None, :], sf, bits)] * sf
        d = points - approx
        errors.append((hist * (d * d)).sum(dim=1, dtype=torch.float64))
    return candidates[torch.argmin(torch.cat(errors))].clone()
