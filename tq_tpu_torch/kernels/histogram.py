"""Fixed-range histogram of a float32 tensor: a CUDA kernel and its plain
version.

No TPU kernel is ported here: the JAX package counts with ``.at[idx].add``
(``tq_tpu.layers.quantize.histogram_update``).  :func:`histogram` gives a
batch's int64 counts over ``num_bins`` equal bins of [minv, maxv], values
outside ignored and the top edge in the last bin, the bin ``floor((x -
minv) * (1 / width))`` in float32:

* on a CUDA tensor it launches ``csrc/histogram.cu`` (block-private
  counts in shared memory, one launch; a strided tensor is made
  contiguous first) and raises on what the kernel does not take: another
  dtype, more than :data:`MAX_BINS` bins;
* on a CPU tensor it runs :func:`histogram_ref`, the plain version.

The two give equal counts on every input (they are exact integers).
:func:`plan` sizes the launch: 16-byte vectors from the first aligned
element, the few elements around them one at a time, on about two blocks
an SM.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tq_tpu_torch.kernels import _build

__all__ = ["histogram", "histogram_ref", "inv_width", "plan",
           "HistogramPlan", "MAX_BINS"]

MAX_BINS = 16384  # a block's uint32 counts fit its shared memory (64 KB)
# The kernel's blocks and the 16-byte vectors a thread takes a step
# (csrc/histogram.cu: kThreads, kUnroll).
_THREADS, _UNROLL = 512, 4
_VEC = 4  # float32 elements a 16-byte vector
# Two blocks of 512 threads (32 registers each) and up to 64 KB of shared
# memory always fit an SM: 128 KB of its 227, half its threads.
_BLOCKS_PER_SM = 2


def inv_width(num_bins: int, minv: float, maxv: float) -> np.float32:
    """``1 / width`` in float32, as XLA folds the JAX package's division by
    the constant bin width."""
    return np.float32(1.0) / np.float32((maxv - minv) / num_bins)


def histogram_ref(x: torch.Tensor, num_bins: int, minv: float,
                  maxv: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram`: ``index_add_`` of the
    in-range mask at the clamped bins."""
    x = x.reshape(-1)
    idx = torch.floor((x - minv) * float(inv_width(num_bins, minv, maxv)))
    # A NaN has no bin: any index in range does, its count is 0.
    idx = idx.clamp(0, num_bins - 1).nan_to_num_(0.0).to(torch.int64)
    valid = (x >= minv) & (x <= maxv)
    counts = torch.zeros(num_bins, dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx, valid.to(torch.int64))
    return counts


class HistogramPlan(NamedTuple):
    """How the kernel launches on ``n`` elements (:func:`plan`)."""

    head: int    # elements before the first 16-byte vector, one at a time
    n_vec: int   # 16-byte vectors
    tail: int    # elements after the last vector, one at a time
    blocks: int  # blocks of _THREADS threads


@functools.lru_cache(maxsize=1024)  # pure: computed once per shape
def plan(n: int, x_addr: int, sms: int) -> HistogramPlan:
    """The span and grid of a launch on ``n`` float32 elements at byte
    address ``x_addr`` (modulo 16), on a card of ``sms`` SMs: vectors from
    the first 16-byte aligned element, on ``_BLOCKS_PER_SM`` blocks an SM,
    or fewer where that gives a thread fewer than ``_UNROLL`` vectors
    (every block zeroes and flushes its whole histogram once)."""
    head = min((-x_addr) % 16 // 4, n)
    n_vec = (n - head) // _VEC
    tail = n - head - n_vec * _VEC
    wanted = -(-n_vec // (_THREADS * _UNROLL))
    return HistogramPlan(head, n_vec, tail,
                         max(1, min(wanted, sms * _BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def histogram(x: torch.Tensor, num_bins: int, minv: float,
              maxv: float) -> torch.Tensor:
    """The int64 counts of ``x`` in ``num_bins`` bins over [minv, maxv]:
    the kernel on a float32 CUDA tensor, the plain version on a CPU
    tensor."""
    if not x.is_cuda:
        return histogram_ref(x, num_bins, minv, maxv)
    if x.dtype != torch.float32:
        raise TypeError(f"histogram kernel takes float32, got {x.dtype}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"histogram kernel takes 1 <= num_bins <= "
                         f"{MAX_BINS}, got {num_bins}")
    x = x.contiguous()
    n = x.numel()
    if not n:
        return torch.zeros(num_bins, dtype=torch.int64, device=x.device)
    counts = torch.empty(num_bins, dtype=torch.int64, device=x.device)
    index = x.device.index
    p = plan(n, x.data_ptr() % 16, _sm_count(index))
    # The entry point zeroes the counts, then launches.
    _build.check(_build.load().tq_histogram(
        x.data_ptr(), p.head, p.n_vec, p.tail, counts.data_ptr(), num_bins,
        float(np.float32(minv)), float(np.float32(maxv)),
        float(inv_width(num_bins, minv, maxv)), p.blocks,
        _build.stream(x.device)), "tq_histogram")
    histogram.launches["histogram"] += 1
    return counts


histogram.launches = {"histogram": 0}
