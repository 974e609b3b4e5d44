"""Fused term-reveal fake quantization: CUDA kernels and their plain version.

Port of ``tq_tpu.kernels.tr_quantize``.  :func:`tr_quantize` computes
exactly :func:`tq_tpu_torch.ops.term_reveal.term_reveal`:

* on a CUDA tensor it launches a kernel of ``csrc/tr_quantize.cu`` (the
  element-wise body for ``group_size == 1``, the grouped body otherwise)
  and raises on what the kernel does not take;
* on a CPU tensor it runs :func:`tr_quantize_ref`, the plain version;
* while ``torch.export`` traces it, it calls the operator
  ``tq::tr_quantize`` (:func:`tr_quantize_op`), whose CUDA implementation
  is the kernel and CPU implementation the plain version, so that an
  exported program keeps the kernel.

The element-wise body also takes bfloat16 input (the serving mode's
activations): it quantizes in float32 and returns bfloat16, with the kept
integer and its product with ``sf`` each rounded to bfloat16, as the JAX
package's element-wise term reveal of a bfloat16 tensor followed by the
cast to bfloat16.  :func:`tr_scale_copy` is the element-wise body's grid
with a body that only scales: the copy ceiling it is timed against.
:func:`plan` sizes both launches: 16-byte vectors where ``x`` and the
output can be aligned together, on whole waves of blocks, the rest one
element at a time; a small ``x`` one element a thread.  The grouped body
reads ``x`` in place (:func:`grouped_view`), with no transpose or pad,
and returns a contiguous tensor of x's shape.

The helpers below are the loop-free int32 bit-mask math of the TPU
kernel's element-wise body, as tensor ops; the plain version uses them and
the CUDA kernels repeat them per thread (``csrc/tr_common.cuh``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tq_tpu_torch.kernels import _build
from tq_tpu_torch.ops.term_reveal import as_scale, term_reveal, uniform_quantize

__all__ = ["tr_quantize", "tr_quantize_ref", "tr_quantize_op",
           "tr_quantize_int", "tr_quantize_int_ref", "tr_scale_copy",
           "tr_scale_copy_ref", "max_hese_terms", "MAX_BITS", "plan",
           "ElementwisePlan", "grouped_view"]

_KEEP_MODES = ("largest", "serial")
MAX_BITS = 24  # q and its term masks stay exact in float32 and int32
_MAX_GROUP = 32  # the grouped kernel keeps a group's masks in registers
# More terms than any group holds: a budget past it keeps everything.
_BUDGET_CAP = _MAX_GROUP * (MAX_BITS + 1)
# The element-wise kernels' blocks, and the 16-byte vectors of x a thread
# takes a tile (csrc/tr_quantize.cu: kThreads, kUnroll).
_THREADS, _UNROLL = 256, 2
_VECTOR_BYTES = 16
# Variant bits of the element-wise kernels (csrc/tr_quantize.cu): bfloat16
# input, int32 output, 'serial'; and tr_scale_copy.
_BF16_IN, _INT_OUT, _SERIAL, _SCALE_COPY = 1, 2, 4, 8
# Threads an SM holds on Hopper (sm_90a, the kernels' only target); the
# element-wise kernels without the vector loop run that many an SM.
_SM_THREADS = 2048
# Elements one launch takes at most: its vectors stay below 2**31, which
# the kernels index in 32 bits.  A multiple of 16, so that every chunk
# starts where x does modulo 16 bytes.
_CHUNK = 1 << 32


def max_hese_terms(bits: int) -> int:
    """Maximum automaton terms of a ``bits``-wide magnitude:
    ``floor(2 * (bits + 1) / 3)`` (repeating '110' patterns)."""
    return 2 * (bits + 1) // 3


def _term_masks(q: torch.Tensor):
    """(t, neg): term-position mask and negative-term mask of int32 ``q``."""
    dn1 = q << 1
    a = q & ~dn1
    t = a | (dn1 & (q << 2) & ~q)
    neg = (q >> 1) & a
    return t, neg


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of non-negative int32 values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _top_bit(r: torch.Tensor) -> torch.Tensor:
    """Mask of the highest set bit of non-negative int32 ``r`` (0 for 0),
    by smearing the top bit downwards: exact for every int32, where the
    TPU kernel's float32-exponent trick is exact only below 2**24."""
    s = r
    for k in (1, 2, 4, 8, 16):
        s = s | (s >> k)
    return s - (s >> 1)


def _topk_value(q: torch.Tensor, bits: int, budget: int) -> torch.Tensor:
    """Integer value of ``q``'s ``budget`` largest HESE terms.

    Two equivalent strategies, chosen by which takes fewer steps: peel the
    top bit ``budget`` times, or clear the ``popcount - budget`` lowest
    set bits.
    """
    if budget >= max_hese_terms(bits):
        return q  # every term kept: plain uniform quantization
    t, neg = _term_masks(q)
    n_clear = max_hese_terms(bits) - budget
    if budget * 4 <= n_clear * 4 + 9:
        r = t
        for _ in range(budget):
            r = r - _top_bit(r)
        kept = t ^ r
    else:
        excess = _popcount(t) - budget
        kept = t
        u = t
        for i in range(1, n_clear + 1):
            u = u & (u - 1)
            kept = torch.where(excess >= i, u, kept)
    return kept - ((kept & neg) << 1)


def _bottomk_value(q: torch.Tensor, bits: int, budget: int) -> torch.Tensor:
    """Integer value of ``q``'s ``budget`` lowest-magnitude HESE terms (the
    FPGA truncator's first-seen order)."""
    if budget >= max_hese_terms(bits):
        return q
    t, neg = _term_masks(q)
    r = t
    for _ in range(budget):
        r = r ^ (r & -r)
    kept = t ^ r
    return kept - ((kept & neg) << 1)


def _check_keep_mode(keep_mode: str) -> None:
    if keep_mode not in _KEEP_MODES:
        raise ValueError(f"unknown keep_mode {keep_mode!r}")


def _kept(x: torch.Tensor, sf, bits: int, budget: int, keep_mode: str):
    """(int32 magnitude of the kept terms, sign) per element; a bfloat16
    ``x`` is quantized from its exact float32 widening."""
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    q, sign = uniform_quantize(x, sf, bits)
    select = _topk_value if keep_mode == "largest" else _bottomk_value
    return select(q, bits, budget), sign


def tr_quantize_ref(x: torch.Tensor, sf, bits: int, group_size: int = 1,
                    num_keep_terms: int = 8, axis: int = 1,
                    keep_mode: str = "largest") -> torch.Tensor:
    """Plain PyTorch version of :func:`tr_quantize`; contiguous, as the
    kernels' output, whatever x's layout."""
    _check_keep_mode(keep_mode)
    if group_size > 1:
        return term_reveal(x, sf, bits, group_size, num_keep_terms, axis,
                           keep_mode).contiguous()
    acc, sign = _kept(x, sf, bits, num_keep_terms, keep_mode)
    sf = as_scale(sf, x.device)
    if x.dtype == torch.bfloat16:
        kept = acc.to(torch.bfloat16).to(torch.float32)
        return (sign * kept * sf).to(torch.bfloat16).contiguous()
    return (sign * acc.to(x.dtype) * sf).contiguous()


def _kernel_scale(x: torch.Tensor, sf, bits: int, keep_mode: str,
                  dtypes=(torch.float32,)) -> torch.Tensor:
    """Check what both kernels take; ``sf`` as a float32 scalar on the card."""
    _check_keep_mode(keep_mode)
    if x.dtype not in dtypes:
        raise TypeError(f"tr_quantize kernel takes {dtypes}, got {x.dtype}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"tr_quantize kernel takes 1 <= bits <= {MAX_BITS},"
                         f" got {bits}")
    return as_scale(sf, x.device).contiguous()


class ElementwisePlan(NamedTuple):
    """How the element-wise kernels launch on ``n`` elements (:func:`plan`)."""

    vec: int         # elements in a 16-byte vector of x; 1: no vectors
    per_thread: int  # elements a thread takes a tile
    head: int        # elements before the first vector, one at a time
    n_vec: int       # vectors
    tail: int        # elements after the last vector, one at a time
    blocks: int      # blocks of _THREADS threads


@functools.lru_cache(maxsize=1024)  # pure: computed once per shape
def plan(n: int, x_addr: int, out_addr: int, in_size: int, out_size: int,
         sms: int, per_sm: int) -> ElementwisePlan:
    """The span and grid of an element-wise launch on ``n`` elements of
    ``in_size`` bytes into ``out_size``-byte outputs, ``x`` and the output
    at byte addresses ``x_addr`` and ``out_addr`` (modulo 16), on a card
    of ``sms`` SMs that runs ``per_sm`` blocks of the kernel an SM.

    The vectors start at the first element at which both pointers are
    16-byte aligned (``head`` elements in), on whole waves of blocks: at
    most as many as the card runs at once, in a grid-stride loop.  Where
    no element aligns both pointers, or one wave of threads of one
    element each covers x (``n <= sms * _SM_THREADS``), every element
    goes one at a time (``vec`` 1), a block per ``_THREADS``: there a
    thread's chain, not the bytes, sets the time (PERF.md).
    """
    vec = _VECTOR_BYTES // in_size
    head = next((h for h in range(vec)
                 if (x_addr + h * in_size) % _VECTOR_BYTES == 0
                 and (out_addr + h * out_size) % _VECTOR_BYTES == 0), n)
    head = min(head, n)
    n_vec = (n - head) // vec
    if n_vec == 0 or n <= sms * _SM_THREADS:
        return ElementwisePlan(1, 1, n, 0, 0, min(-(-n // _THREADS),
                                                  2**31 - 1))
    if n_vec >= 2**31:
        raise ValueError(f"the element-wise kernels index vectors in 32 "
                         f"bits: {n} elements is too many")
    tail = n - head - n_vec * vec
    tiles = -(-n_vec // (_UNROLL * _THREADS))
    blocks = max(tiles, -(-(head + tail) // _THREADS))
    return ElementwisePlan(vec, vec * _UNROLL, head, n_vec, tail,
                           min(blocks, max(1, sms * per_sm)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, variant: int) -> int:
    """Blocks of the element-wise kernel ``variant`` an SM of the card
    ``index`` runs at once (the occupancy API)."""
    with torch.cuda.device(index):
        n = _build.load().tq_tr_elementwise_blocks_per_sm(variant)
    if n < 0:
        _build.check(-n, "tq_tr_elementwise_blocks_per_sm")
    return n


def _plan_for(x: torch.Tensor, out: torch.Tensor,
              variant: int) -> ElementwisePlan:
    index = x.device.index
    return plan(x.numel(), x.data_ptr() % _VECTOR_BYTES,
                out.data_ptr() % _VECTOR_BYTES, x.element_size(),
                out.element_size(), _sm_count(index),
                _blocks_per_sm(index, variant))


def _chunks(x: torch.Tensor, out: torch.Tensor):
    """Contiguous ``x`` and ``out`` as pieces of at most ``_CHUNK``
    elements, a launch each (none for no elements)."""
    n = x.numel()
    if n <= _CHUNK:
        return ((x, out),) if n else ()
    xf, of = x.view(-1), out.view(-1)
    return [(xf[s:s + _CHUNK], of[s:s + _CHUNK]) for s in range(0, n, _CHUNK)]


def _launch_elementwise(x, sf, bits, budget, keep_mode, int_out: bool,
                        out=None):
    """The element-wise kernel on CUDA ``x``; ``out`` (a contiguous tensor
    of x's shape and the output type, any alignment) is for the card's
    checks."""
    sf = _kernel_scale(x, sf, bits, keep_mode,
                       (torch.float32, torch.bfloat16))
    in_bf16 = x.dtype == torch.bfloat16
    xc = x.contiguous()
    dtype = torch.int32 if int_out else x.dtype
    if out is None:
        out = torch.empty(x.shape, dtype=dtype, device=x.device)
    elif (out.shape != x.shape or out.dtype != dtype
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape "
                         f"{tuple(x.shape)} on {x.device}")
    variant = ((_BF16_IN if in_bf16 else 0) | (_INT_OUT if int_out else 0)
               | (_SERIAL if keep_mode == "serial" else 0))
    for xs, outs in _chunks(xc, out):
        p = _plan_for(xs, outs, variant)
        _build.check(_build.load().tq_tr_quantize_elementwise(
            xs.data_ptr(), sf.data_ptr(), outs.data_ptr(), p.head, p.n_vec,
            p.tail, p.blocks, bits, min(budget, _BUDGET_CAP), variant,
            _build.stream(x.device)), "tq_tr_quantize_elementwise")
        tr_quantize.launches["elementwise" + ("_bf16" if in_bf16 else "")
                             + ("_int" if int_out else "")] += 1
    return out


def grouped_view(shape: tuple, axis: int) -> tuple[int, int, int]:
    """``(outer, n, inner)``: how the grouped kernel reads a contiguous
    ``x`` of ``shape`` in place, grouped along ``axis`` of length n; outer
    and inner are the products of the dimensions before and after it
    (inner is the row pitch)."""
    axis = axis % len(shape)
    return (math.prod(shape[:axis]), shape[axis],
            math.prod(shape[axis + 1:]))


def _launch_grouped(x, sf, bits, group_size, budget, axis, keep_mode):
    """The grouped kernel on CUDA ``x``, read in place along ``axis``; the
    result is contiguous, of x's shape."""
    sf = _kernel_scale(x, sf, bits, keep_mode)
    if group_size > _MAX_GROUP:
        raise ValueError(f"grouped kernel takes group_size <= {_MAX_GROUP}, "
                         f"got {group_size}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel():
        _build.check(_build.load().tq_tr_quantize_grouped(
            xc.data_ptr(), sf.data_ptr(), out.data_ptr(),
            *grouped_view(tuple(xc.shape), axis), group_size, bits,
            min(budget, _BUDGET_CAP), int(keep_mode == "serial"),
            _build.stream(x.device)), "tq_tr_quantize_grouped")
        tr_quantize.launches["grouped"] += 1
    return out


def tr_quantize(x: torch.Tensor, sf, bits: int, group_size: int = 1,
                num_keep_terms: int = 8, axis: int = 1,
                keep_mode: str = "largest") -> torch.Tensor:
    """Term-reveal fake quantization (equals :func:`term_reveal`).

    ``sf`` is read from device memory by the kernel, so a scale computed
    on the device needs no host sync.  ``keep_mode``: 'largest' keeps the
    largest-magnitude terms, 'serial' the lowest (first-seen) ones.
    """
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    if torch.compiler.is_exporting():
        _check_keep_mode(keep_mode)
        return tr_quantize_op(x, as_scale(sf, x.device), bits, group_size,
                              num_keep_terms, axis, keep_mode)
    if not x.is_cuda:
        return tr_quantize_ref(x, sf, bits, group_size, num_keep_terms, axis,
                               keep_mode)
    return _launch(x, sf, bits, group_size, num_keep_terms, axis, keep_mode)


def _launch(x, sf, bits, group_size, num_keep_terms, axis, keep_mode):
    if group_size == 1:
        return _launch_elementwise(x, sf, bits, num_keep_terms, keep_mode,
                                   int_out=False)
    return _launch_grouped(x, sf, bits, group_size, num_keep_terms, axis,
                           keep_mode)


@torch.library.custom_op("tq::tr_quantize", mutates_args=(),
                         device_types="cpu")
def tr_quantize_op(x: torch.Tensor, sf: torch.Tensor, bits: int,
                   group_size: int, num_keep_terms: int, axis: int,
                   keep_mode: str) -> torch.Tensor:
    """:func:`tr_quantize` as the operator an exported program calls: this
    CPU implementation is the plain version, the CUDA one the kernel."""
    return tr_quantize_ref(x, sf, bits, group_size, num_keep_terms, axis,
                           keep_mode)


@tr_quantize_op.register_kernel("cuda")
def _tr_quantize_op_cuda(x, sf, bits, group_size, num_keep_terms, axis,
                         keep_mode):
    return _launch(x, sf, bits, group_size, num_keep_terms, axis, keep_mode)


@tr_quantize_op.register_fake
def _tr_quantize_op_fake(x, sf, bits, group_size, num_keep_terms, axis,
                         keep_mode):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# Launches by body: element-wise (float32 or bfloat16 input; dequantized
# or, from tr_quantize_int, int32 output) and grouped.
tr_quantize.launches = {"elementwise": 0, "elementwise_bf16": 0,
                        "elementwise_int": 0, "elementwise_bf16_int": 0,
                        "grouped": 0}


def tr_quantize_int_ref(x: torch.Tensor, sf, bits: int, num_keep_terms: int,
                        keep_mode: str = "largest") -> torch.Tensor:
    """Plain PyTorch version of :func:`tr_quantize_int`; in 'largest' mode
    it equals
    :func:`~tq_tpu_torch.ops.term_reveal.term_reveal_elementwise_int`."""
    _check_keep_mode(keep_mode)
    acc, _ = _kept(x, sf, bits, num_keep_terms, keep_mode)
    return torch.where(x < 0, -acc, acc)


def tr_quantize_int(x: torch.Tensor, sf, bits: int, num_keep_terms: int,
                    keep_mode: str = "largest") -> torch.Tensor:
    """Element-wise term reveal without the dequantization: int32
    ``+-q_kept``, the element-wise kernel's integer-output variant."""
    if not x.is_cuda:
        return tr_quantize_int_ref(x, sf, bits, num_keep_terms, keep_mode)
    return _launch_elementwise(x, sf, bits, num_keep_terms, keep_mode,
                               int_out=True)


def tr_scale_copy_ref(x: torch.Tensor, sf) -> torch.Tensor:
    """Plain PyTorch version of :func:`tr_scale_copy`: ``x * sf``."""
    return x * as_scale(sf, x.device)


def tr_scale_copy(x: torch.Tensor, sf) -> torch.Tensor:
    """``x * sf`` through the element-wise kernel's grid and loads: the
    same-run copy ceiling of :func:`tr_quantize`'s element-wise body
    (float32 only)."""
    if not x.is_cuda:
        return tr_scale_copy_ref(x, sf)
    if x.dtype != torch.float32:
        raise TypeError(f"tr_scale_copy kernel takes float32, got {x.dtype}")
    sf = as_scale(sf, x.device).contiguous()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    for xs, outs in _chunks(xc, out):
        p = _plan_for(xs, outs, _SCALE_COPY)
        _build.check(_build.load().tq_tr_scale_copy(
            xs.data_ptr(), sf.data_ptr(), outs.data_ptr(), p.head, p.n_vec,
            p.tail, p.blocks, _build.stream(x.device)), "tq_tr_scale_copy")
        tr_scale_copy.launches["scale_copy"] += 1
    return out


tr_scale_copy.launches = {"scale_copy": 0}
