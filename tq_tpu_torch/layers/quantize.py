"""Two-phase activation calibration: histogram tracking + MSE scale search.

Port of ``tq_tpu.layers.quantize``.  Protocol:

  phase 1  a calibration pass runs the model on ~5% of the eval set while
           every activation quantizer accumulates a fixed-range histogram
           (8192 bins over [-50, 50], out-of-range values ignored);
  switch   :func:`mse_search_scale` grid-searches 2048 scale candidates in
           [1e-8, 50] for the one minimizing the histogram-weighted MSE of
           the term-revealed grid points;
  phase 2  activations are fake-quantized per element (group_size=1,
           keeping ``data_terms`` HESE terms) with the chosen scale.

The grid points and the candidates are the float32 values ``jnp.linspace``
gives on the JAX package's CPU backend.  ``torch.linspace`` rounds
differently at most of the grid points, so the default grids
ship as ``.npy`` files beside this module and other configurations use
:func:`_linspace_f32`, the formula XLA compiles ``jnp.linspace`` to.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from tq_tpu_torch.kernels.histogram import histogram
from tq_tpu_torch.kernels.tr_quantize import (_topk_value, max_hese_terms,
                                              tr_quantize)
from tq_tpu_torch.ops.term_reveal import term_reveal_elementwise
from tq_tpu_torch.utils.trace import span

__all__ = [
    "CalibConfig",
    "init_histogram",
    "histogram_update",
    "calibration_grids",
    "mse_search_scale",
    "act_quantize",
]

_GRID_DIR = Path(__file__).resolve().parent / "grids"
_CHUNK = 256  # scale candidates evaluated per batched step


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Calibration hyper-parameters (the reference's values)."""

    num_bins: int = 8192
    minv: float = -50.0
    maxv: float = 50.0
    num_candidates: int = 2048
    sf_min: float = 1e-8


def init_histogram(cfg: CalibConfig = CalibConfig(),
                   device=None) -> torch.Tensor:
    return torch.zeros(cfg.num_bins, dtype=torch.float32, device=device)


def histogram_update(hist: torch.Tensor, x: torch.Tensor,
                     cfg: CalibConfig = CalibConfig(),
                     count_reduce=None) -> torch.Tensor:
    """Accumulate ``x`` into the fixed-range histogram.

    Values outside [minv, maxv] are ignored and the top edge falls in the
    last bin.  The bin is ``floor((x - minv) * (1 / width))`` in float32:
    XLA turns the JAX package's division by the constant bin width into
    that multiplication, and ``torch.histc`` bins edges differently.
    Counts are exact integers: on the card the histogram kernel counts
    them (:func:`~tq_tpu_torch.kernels.histogram.histogram`; float32, up
    to ``MAX_BINS`` bins), on the CPU its plain version, with equal
    counts.  ``count_reduce`` (e.g. a sum over the 'data' ranks
    that split the batch) takes the batch's int64 counts before they are
    cast and added, so the histogram is the one of the whole batch, exact
    past 2^24 a bin.
    """
    with span("tq.calib.histogram", device=x.is_cuda):
        x = x.reshape(-1)
        counts = histogram(x, cfg.num_bins, cfg.minv, cfg.maxv)
        if count_reduce is not None:
            counts = count_reduce(counts)
        return hist + counts.to(hist.dtype)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA:CPU compiles it:
    ``fma(i, stop * (1/div), start * fma(-i, 1/div, 1))``, then ``stop``.
    Each fused multiply-add is taken in float64 (the float32 product is
    exact there) and rounded to float32; the vectorized loop's scalar
    tail can round a few points one ulp away from this."""
    f32, f64 = np.float32, np.float64
    div = num - 1
    if div < 1:
        return np.full(num, start, f32)
    i = np.arange(div, dtype=f32)
    c1 = f32(1.0) / f32(div)
    c2 = f32(c1 * f32(stop))
    one_minus = (-i.astype(f64) * f64(c1) + 1.0).astype(f32)
    a = (f32(start) * one_minus).astype(f32)
    head = (i.astype(f64) * f64(c2) + a.astype(f64)).astype(f32)
    return np.concatenate([head, np.asarray([stop], f32)])


@functools.lru_cache(maxsize=None)
def _grids_np(cfg: CalibConfig) -> tuple[np.ndarray, np.ndarray]:
    if cfg == CalibConfig():
        return (np.load(_GRID_DIR / "x_grid_default.npy"),
                np.load(_GRID_DIR / "sfs_default.npy"))
    return (_linspace_f32(cfg.minv, cfg.maxv, cfg.num_bins),
            _linspace_f32(cfg.sf_min, cfg.maxv, cfg.num_candidates))


def calibration_grids(cfg: CalibConfig = CalibConfig(), device=None):
    """(x_grid, sfs): the histogram's grid points and the scale
    candidates, float32 tensors on ``device``."""
    x_grid, sfs = _grids_np(cfg)
    return (torch.tensor(x_grid, device=device),
            torch.tensor(sfs, device=device))


def _tr_elementwise_vals(x_grid: torch.Tensor, sf: torch.Tensor, bits: int,
                         terms: int) -> torch.Tensor:
    """Term reveal with g=1 of the grid (1, B) at every candidate (C, 1)."""
    maxq = 2**bits - 1
    q = torch.clamp(torch.floor(x_grid.abs() / sf + 0.5), 0, maxq)
    q = q.to(torch.int32)
    sign = torch.where(x_grid < 0, -1.0, 1.0)
    if terms < max_hese_terms(bits):
        # A degenerate budget (every reference UQ row, and the 16-bit
        # exempt setting) drops no term: TR == plain UQ, skip the masks.
        # The kept value depends on q alone: up to 16 bits, reveal every q
        # once and look the grid's up (the same integers, a fraction of
        # the work at the scale search's 2048 x 8192 points).
        if bits <= 16:
            every_q = torch.arange(maxq + 1, dtype=torch.int32,
                                   device=q.device)
            q = _topk_value(every_q, bits, terms)[q.long()]
        else:
            q = _topk_value(q, bits, terms)
    return sign * q.to(torch.float32) * sf


def mse_search_scale(hist: torch.Tensor, bits: int, terms: int,
                     cfg: CalibConfig = CalibConfig()) -> torch.Tensor:
    """The scale candidate minimizing histogram-weighted quantization MSE,
    as a float32 0-d tensor on ``hist``'s device (no host sync).

    The candidates are evaluated as a batched tensor computation, in
    chunks.  Each candidate's error is summed in float64, so the choice
    does not depend on the device's reduction order: the CPU and the card
    pick the same candidate.
    """
    x_grid, sfs = calibration_grids(cfg, hist.device)
    hist = hist.to(torch.float32)
    errs = []
    for chunk in sfs.split(_CHUNK):
        xh = _tr_elementwise_vals(x_grid[None, :], chunk[:, None], bits,
                                  terms)
        d = x_grid - xh
        errs.append((hist * (d * d)).sum(dim=1, dtype=torch.float64))
    # a scale of its own, not a view of the candidates
    return sfs[torch.argmin(torch.cat(errs))].clone()


def act_quantize(x: torch.Tensor, sf, bits: int, terms: int) -> torch.Tensor:
    """Phase-2 activation fake quantization (g=1, per-element top terms):
    the ``tr_quantize`` element-wise kernel on a CUDA tensor, the
    loop-free plain version on a CPU tensor.  While ``torch.export``
    traces, ``tr_quantize`` on either device: the program calls the
    operator ``tq::tr_quantize``, whatever device it is traced on."""
    if x.is_cuda or torch.compiler.is_exporting():
        return tr_quantize(x, sf, bits, 1, terms)
    return term_reveal_elementwise(x, sf, bits, terms)
