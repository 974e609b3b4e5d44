"""Fused activation term-reveal + matmul: CUDA kernel, its plain version,
and the narrow weight formats it streams.

Port of ``tq_tpu.kernels.term_matmul``: ``tr_quantize(x, sf, bits, 1, k)
@ w`` with the activation tile term-revealed as it is loaded, so the
quantized activations never reach device memory, in every mode of the TPU
kernel:

* **f32** (default): ``acc(x_q * sf @ w) * w_sf``, float32 throughout;
* **bf16** (``bf16=True``): the signed integer activations and the
  weights rounded to bfloat16, float32 accumulation, ``* (sf * w_sf)``;
* **int8** (``int8=True``): int8 x int8 -> int32, exact, ``* (sf * w_sf)``;
  int8 weights and ``bits <= 7`` only.  A kept value of +128 (one term
  of q >= 96 at 7 bits) saturates to 127, as the JAX package's cast to
  int8 does;
* **raw input** (``quantize_x=False``): ``x`` itself feeds the product and
  ``sf`` is taken as 1.

Weights are float32, bfloat16-stored, int8/int16 with ``w_sf`` (see
:func:`pack_weight_int`) or a :class:`PackedWeight8` (9 bits per weight,
:func:`pack_weight_u8s`), widened or decoded inside the kernel.

* On a CUDA tensor :func:`term_matmul` launches one of three kernels
  (see :func:`plan`), each with a C entry point of its own: the
  weight-streaming kernel (``csrc/term_matmul_stream.cu``) for small M;
  above it, on the tensor cores, the f32 mode in every weight format
  (``csrc/term_matmul_mma.cu``) and the bf16 and int8 modes
  (``csrc/term_matmul_mma_lp.cu``).  It raises on what the kernels do
  not take.
* On a CPU tensor it runs :func:`term_matmul_ref`, the plain version.
* While ``torch.export`` traces it, it calls the operator
  ``tq::term_matmul`` (:func:`term_matmul_op`) instead, whose CUDA
  implementation is the kernel (counted as a launch) and whose CPU
  implementation the plain version, so that an exported program keeps
  the kernel; an eager call never pays the operator's dispatch.

The packing functions are plain tensor code (no kernel) on the weights'
device.  Their overflow checks can be deferred and fetched in one
device-to-host copy per model (:func:`flush_pack_checks`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from tq_tpu_torch.kernels import _build
from tq_tpu_torch.kernels.tr_quantize import (MAX_BITS, _sm_count,
                                              tr_quantize_int_ref,
                                              tr_quantize_ref)
from tq_tpu_torch.ops.term_reveal import as_scale

__all__ = ["term_matmul", "term_matmul_ref", "term_matmul_op", "launch",
           "plan", "Plan", "STREAM_MAX_M", "pack_weight_int",
           "pack_weight_u8s", "unpack_weight_u8s", "flush_pack_checks",
           "PackedWeight8", "VARIANTS", "variant"]

# M up to which term_matmul takes the weight-streaming kernel: its
# crossover with the tensor-core kernels above it (mma in the f32 mode,
# mma_lp in the bf16 and int8 modes) at the LSTM decoder's width, 650 x
# 33278, in chip_smoke.py's crossover table (PERF.md).  At the recurrent
# width, 650 x 2600, the tensor cores win from M = 2.
STREAM_MAX_M = 8

# The tensor-core kernels' output tiles (rows, columns) and their K
# splits' multiple (the f32 kernel's, and the bf16 / int8 kernel's by
# mode: one mma's K), and most blocks in a cluster.
_MMA_TILE, _MMA_K_STEP, _MMA_MAX_SPLITS = (32, 128), 8, 8
_MMA_LP_TILE, _MMA_LP_K_STEP = (64, 128), {"bf16": 16, "int8": 32}
# The streaming kernel's lanes owning columns (of 16 bytes each), K rows
# per step, most rows of x a block and most blocks in a cluster.
_STREAM_LANES, _STREAM_GROUP, _STREAM_MAX_ROWS, _STREAM_MAX_SPLITS = \
    31, 8, 8, 8
# The kernels' codes for the multiply-accumulate mode and weight format.
_MODES = {"f32": 0, "bf16": 1, "int8": 2}
_FORMATS = {"f32": 0, "bf16": 1, "int8": 2, "int16": 3, "packed8": 4}
_FORMAT_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "int16": 2, "packed8": 1}
# The kernels plan() takes, each with an entry point of its own.
_KERNELS = ("stream", "mma", "mma_lp")
_DTYPE_FORMATS = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.int8: "int8", torch.int16: "int16"}


class PackedWeight8(NamedTuple):
    """9-bits-per-weight format for 8-bit grids (see
    :func:`pack_weight_u8s`): biased int8 magnitude (``|q| - 128``, so the
    full 0..255 clamp range of an 8-bit grid fits one byte) plus a sign
    bitplane packing 8 rows per byte."""

    lo: torch.Tensor     # (K8, N) int8: |q| - 128
    signs: torch.Tensor  # (K8//8, N) int8: bit i of row r = sign of row 8r+i
    w_sf: torch.Tensor   # () float32 weight scale


def _safe_scale(w_sf, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_sf == 0, w_sf with 0 replaced by 1), float32 0-d tensors."""
    w_sf = as_scale(w_sf, device)
    zero = w_sf == 0.0
    return zero, torch.where(zero, torch.ones_like(w_sf), w_sf)


def _pack_u8s(w_q: torch.Tensor, w_sf) -> tuple[PackedWeight8, torch.Tensor]:
    """:func:`pack_weight_u8s` without the check: (pack, max |q|)."""
    zero, safe_sf = _safe_scale(w_sf, w_q.device)
    q = torch.where(zero, torch.zeros((), dtype=torch.int32, device=w_q.device),
                    torch.round(w_q / safe_sf).to(torch.int32))
    maxq = q.abs().max()
    K, N = q.shape
    K8 = -(-K // 8) * 8
    q = torch.nn.functional.pad(q, (0, 0, 0, K8 - K))
    lo = (q.abs() - 128).to(torch.int8)  # bias: 0..255 -> -128..127
    sbit = (q < 0).to(torch.int32).reshape(K8 // 8, 8, N)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=q.device))[None, :, None]
    signs = (sbit * weights).sum(dim=1).to(torch.int8)
    return PackedWeight8(lo, signs, safe_sf), maxq


def _overflow_error(v: float, bits: int, what: str) -> ValueError:
    return ValueError(f"max |w/w_sf| = {v} {what} — 'bits' ({bits}) "
                      "understates the quantization grid")


def _grid_check(maxq: torch.Tensor, limit: int, bits: int, what: str,
                checks) -> None:
    """Validate ``maxq <= limit``: now (one host fetch), or, if ``checks``
    is a list, later, when :func:`flush_pack_checks` fetches every pack's
    scalar in one copy."""
    if checks is not None:
        checks.append((maxq, limit, bits, what))
        return
    v = float(maxq)
    if v > limit:
        raise _overflow_error(v, bits, what)


def flush_pack_checks(checks) -> None:
    """Fetch all deferred overflow scalars in one device-to-host copy and
    raise on the first violation; empties ``checks``."""
    if not checks:
        return
    vals = torch.stack([m.reshape(()).to(torch.float64)
                        for m, _, _, _ in checks]).tolist()
    for v, (_, limit, bits, what) in zip(vals, checks):
        if v > limit:
            raise _overflow_error(v, bits, what)
    checks.clear()


def pack_weight_u8s(w_q: torch.Tensor, w_sf, bits: int,
                    checks: list | None = None) -> PackedWeight8:
    """Pack term-revealed weights of an 8-bit grid into 9 bits per weight.

    An 8-bit grid's magnitudes clamp at 255, so a magnitude biased by -128
    fits an int8 and the signs go to a bitplane of 1 bit per weight: 1.125
    bytes per weight, 1.78x less weight traffic than int16.  Rows are
    zero-padded to a multiple of 8 (``term_matmul`` reads only the
    activations' K of them).  Requires ``bits <= 8``.  ``checks``: a shared
    list for deferred overflow validation (:func:`flush_pack_checks`).
    """
    if bits > 8:
        raise ValueError(f"pack_weight_u8s needs bits <= 8, got {bits}")
    wp, maxq = _pack_u8s(w_q, w_sf)
    _grid_check(maxq, 255, bits, "> 255", checks)
    return wp


def _decode_u8s(wp: PackedWeight8) -> torch.Tensor:
    """int32 q of a :class:`PackedWeight8`, (K8, N)."""
    lo, signs, _ = wp
    mag = lo.to(torch.int32) + 128
    K8, N = lo.shape
    shifts = torch.arange(8, dtype=torch.int32, device=lo.device)
    bit = (signs.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1
    return mag * (1 - 2 * bit.reshape(K8, N))


def unpack_weight_u8s(wp: PackedWeight8, k: int | None = None) -> torch.Tensor:
    """Decode a :class:`PackedWeight8` to float32 weights ``q * w_sf``
    outside the kernel (the n-D input path, and the tests' round trip).
    ``k`` trims the 8-row padding."""
    w = _decode_u8s(wp).to(torch.float32) * wp.w_sf
    return w if k is None else w[:k]


def pack_weight_int(w_q: torch.Tensor, w_sf, bits: int,
                    checks: list | None = None):
    """Pack term-revealed float weights into narrow integers.

    ``w_q`` holds exact multiples of ``w_sf``; with the weight scale
    ``max|w| / 2**(bits-1)`` magnitudes reach ``2**(bits-1)``, so int8
    covers grids up to 7 bits and int16 up to 15.  Returns ``(int8 or int16
    tensor, w_sf)``; an all-zero tensor (``w_sf == 0``) packs to zeros with
    scale 1.  Raises on overflow, now or at :func:`flush_pack_checks`.
    """
    dtype, name, limit = ((torch.int8, "int8", 127) if bits <= 7
                          else (torch.int16, "int16", 32767))
    zero, safe_sf = _safe_scale(w_sf, w_q.device)
    q = torch.where(zero, torch.zeros((), device=w_q.device),
                    torch.round(w_q / safe_sf))
    _grid_check(q.abs().max(), limit, bits, f"overflows {name}", checks)
    return q.to(dtype), safe_sf


def _mode(bf16: bool, int8: bool) -> str:
    return "int8" if int8 else ("bf16" if bf16 else "f32")


def _check(x: torch.Tensor, w, bits: int, bf16: bool, int8: bool, w_sf,
           quantize_x: bool) -> None:
    """The JAX package's argument checks, with the same messages."""
    if x.ndim != 2:
        raise ValueError(f"term_matmul takes x (M, K), got {tuple(x.shape)}")
    K = x.shape[1]
    if isinstance(w, PackedWeight8):
        if w_sf is not None:
            raise ValueError("PackedWeight8 carries its own w_sf")
        if int8:
            raise ValueError(
                "int8 mode is for <= 7-bit grids (pack_weight_int); "
                "PackedWeight8 exists for 8-bit grids")
        K2 = w.lo.shape[0]
        if K2 < K or K2 - K >= 8:
            raise ValueError(
                f"packed weight rows {K2} do not cover x K {K} "
                "(pack_weight_u8s pads to the next multiple of 8)")
    else:
        if w.ndim != 2 or w.shape[0] != K:
            raise ValueError(f"term_matmul takes x (M, K) and w (K, N), got "
                             f"{tuple(x.shape)} and {tuple(w.shape)}")
        w_is_int = not (w.dtype.is_floating_point or w.dtype.is_complex)
        if w_is_int and w.dtype not in (torch.int8, torch.int16):
            raise ValueError(
                f"integer weights must be int8 or int16, got {w.dtype}")
        if w_is_int and w_sf is None:
            raise ValueError("integer weights require w_sf")
        if not w_is_int and w_sf is not None:
            raise ValueError("w_sf is only meaningful for integer weights")
        if int8:
            if bf16:
                raise ValueError("int8 and bf16 modes are mutually exclusive")
            if w.dtype != torch.int8:
                raise ValueError("int8 mode requires int8-packed weights")
            if bits > 7:
                raise ValueError(
                    f"int8 mode needs bits <= 7 (magnitudes < 128), got {bits}")
    if not quantize_x and int8:
        raise ValueError("int8 mode requires quantized activations")


def _scales(x: torch.Tensor, w, sf, w_sf, mode: str, quantize_x: bool):
    """(sf, epilogue scale) as float32 0-d tensors: ``sf`` is 1 for raw
    input; the epilogue is ``w_sf`` in the f32 mode, ``sf * w_sf``
    otherwise (the TPU kernel's ``sf_arr``)."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    sf_s = as_scale(sf, x.device) if quantize_x else one
    if isinstance(w, PackedWeight8):
        wsf_s = as_scale(w.w_sf, x.device)
    else:
        wsf_s = as_scale(w_sf, x.device) if w_sf is not None else one
    return sf_s, (wsf_s if mode == "f32" else sf_s * wsf_s)


def term_matmul_ref(x: torch.Tensor, w, sf, bits: int = 8,
                    num_keep_terms: int = 8, bf16: bool = False,
                    int8: bool = False, w_sf=None,
                    quantize_x: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`term_matmul`, every mode, with the
    kernel's scale association.  The int8 mode saturates the activations
    at 127, as the JAX kernel's int8 cast, and multiplies the integers in
    float64 (exact: ``|acc| <= 128 * 127 * K``), so it is bit-exact on
    any device."""
    _check(x, w, bits, bf16, int8, w_sf, quantize_x)
    mode = _mode(bf16, int8)
    sf_s, epi = _scales(x, w, sf, w_sf, mode, quantize_x)
    if not quantize_x:
        xa = x.to(torch.float32)
    elif mode == "f32":
        xa = tr_quantize_ref(x, sf_s, bits, 1, num_keep_terms)
    else:  # the signed integer quantized values; sf goes to the epilogue
        xa = tr_quantize_int_ref(x, sf_s, bits, num_keep_terms)
        if mode == "int8":
            xa = xa.clamp(max=127)
        xa = xa.to(torch.float32)
    if isinstance(w, PackedWeight8):
        wa = _decode_u8s(w)[:x.shape[1]].to(torch.float32)
    else:
        wa = w.to(torch.float32)
    if mode == "int8":
        acc = torch.matmul(xa.to(torch.float64),
                           wa.to(torch.float64)).to(torch.float32)
    else:
        if mode == "bf16":
            xa = xa.to(torch.bfloat16).to(torch.float32)
            wa = wa.to(torch.bfloat16).to(torch.float32)
        acc = torch.matmul(xa, wa)
    return acc * epi


def _weight_format(w) -> str | None:
    """'packed8', or the name of ``w``'s dtype in _FORMATS (None if the
    kernel does not take it)."""
    if isinstance(w, PackedWeight8):
        return "packed8"
    return _DTYPE_FORMATS.get(w.dtype)


def _variant_name(mode: str, fmt: str, quantize_x: bool) -> str:
    return (mode + ("" if quantize_x else "_raw")
            + ("" if fmt == "f32" else "_" + fmt))


# Every combination the checks admit: the launch counter's key (mode,
# "_raw" for raw input, the weight format unless float32) -> (mode, weight
# format, quantize_x).
VARIANTS = {_variant_name(m, f, q): (m, f, q)
            for m in ("f32", "bf16") for q in (True, False) for f in _FORMATS}
VARIANTS["int8_int8"] = ("int8", "int8", True)


def variant(bf16: bool = False, int8: bool = False, w=None,
            quantize_x: bool = True) -> str:
    """The launch counter's key of a call: ``f32``, ``f32_raw_packed8``,
    ``bf16_int16``, ``int8_int8``, ..."""
    fmt = "f32" if w is None else (_weight_format(w) or "f32")
    return _variant_name(_mode(bf16, int8), fmt, quantize_x)


def term_matmul(x: torch.Tensor, w, sf, bits: int = 8,
                num_keep_terms: int = 8, bf16: bool = False,
                int8: bool = False, interpret: bool | None = None,
                bm: int = 1024, bk: int = 2048, bn: int = 512, w_sf=None,
                pipeline: bool = True, bsub: int | None = None,
                quantize_x: bool = True) -> torch.Tensor:
    """``tr_quantize(x, sf, bits, 1, num_keep_terms) @ w`` in one kernel.

    Keeps the JAX signature.  ``interpret``, ``bm``, ``bk``, ``bn``,
    ``pipeline`` and ``bsub`` only tune TPU tiles and are ignored.
    ``w``: (K, N) float32 or bfloat16 weights, int8/int16 with ``w_sf``,
    or a :class:`PackedWeight8`.  ``sf`` is read from device memory by the
    kernel (no host sync) and ignored for raw input.  Returns (M, N)
    float32.  On the card, M <= :data:`STREAM_MAX_M` takes the
    weight-streaming kernel, larger M a tensor-core kernel (:func:`plan`).
    """
    del interpret, bm, bk, bn, pipeline, bsub
    if torch.compiler.is_exporting():
        return _call_op(x, w, sf, bits, num_keep_terms, bf16, int8, w_sf,
                        quantize_x)
    if not x.is_cuda:
        return term_matmul_ref(x, w, sf, bits, num_keep_terms, bf16, int8,
                               w_sf, quantize_x)
    return launch(x, w, sf, bits, num_keep_terms, bf16, int8, w_sf,
                  quantize_x)


@torch.library.custom_op("tq::term_matmul", mutates_args=(),
                         device_types="cpu")
def term_matmul_op(x: torch.Tensor, w: torch.Tensor,
                   signs: Optional[torch.Tensor], sf: Optional[torch.Tensor],
                   w_sf: Optional[torch.Tensor], bits: int,
                   num_keep_terms: int, bf16: bool, int8: bool,
                   quantize_x: bool) -> torch.Tensor:
    """:func:`term_matmul` as an operator of plain tensors, the one an
    exported program calls: ``w`` is the weight tensor, or the ``lo``
    plane of a :class:`PackedWeight8` whose sign plane is ``signs`` and
    scale ``w_sf``; ``sf`` is None for raw input.  This CPU
    implementation is the plain version; the CUDA one launches the
    kernel."""
    return term_matmul_ref(*_op_operands(x, w, signs, sf, w_sf, bits,
                                         num_keep_terms, bf16, int8,
                                         quantize_x))


@term_matmul_op.register_kernel("cuda")
def _term_matmul_op_cuda(x, w, signs, sf, w_sf, bits, num_keep_terms, bf16,
                         int8, quantize_x):
    return launch(*_op_operands(x, w, signs, sf, w_sf, bits, num_keep_terms,
                                bf16, int8, quantize_x))


@term_matmul_op.register_fake
def _term_matmul_op_fake(x, w, signs, sf, w_sf, bits, num_keep_terms, bf16,
                         int8, quantize_x):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)


def _op_operands(x, w, signs, sf, w_sf, bits, num_keep_terms, bf16, int8,
                 quantize_x):
    """The operator's arguments as :func:`term_matmul`'s."""
    if signs is not None:
        w, w_sf = PackedWeight8(w, signs, w_sf), None
    return (x, w, sf if quantize_x else 1.0, bits, num_keep_terms, bf16, int8,
            w_sf, quantize_x)


def _call_op(x, w, sf, bits, num_keep_terms, bf16, int8, w_sf, quantize_x):
    """:func:`term_matmul` through ``tq::term_matmul`` (while exporting)."""
    _check(x, w, bits, bf16, int8, w_sf, quantize_x)
    packed = isinstance(w, PackedWeight8)
    wsf = w.w_sf if packed else w_sf
    return term_matmul_op(
        x, w.lo if packed else w, w.signs if packed else None,
        as_scale(sf, x.device) if quantize_x else None,
        as_scale(wsf, x.device) if wsf is not None else None, bits,
        num_keep_terms, bf16, int8, quantize_x)


def launch(x: torch.Tensor, w, sf, bits: int = 8, num_keep_terms: int = 8,
           bf16: bool = False, int8: bool = False, w_sf=None,
           quantize_x: bool = True, kernel: str | None = None
           ) -> torch.Tensor:
    """:func:`term_matmul` on CUDA tensors: check, plan, launch, count.

    ``kernel`` ("stream", "mma" or "mma_lp") overrides the route, to
    time one kernel at a shape the route gives another;
    :func:`term_matmul` never passes it.  Raises on what the kernels do
    not take.
    """
    _check(x, w, bits, bf16, int8, w_sf, quantize_x)
    packed = isinstance(w, PackedWeight8)
    wt = w.lo if packed else w
    fmt = _weight_format(w)
    if fmt is None:
        raise TypeError(f"term_matmul kernel takes float32, bfloat16, int8, "
                        f"int16 or packed weights, got {wt.dtype}")
    if not x.is_cuda:
        raise ValueError(f"term_matmul kernel takes CUDA tensors, x is on "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"term_matmul kernel takes float32 x, got {x.dtype}")
    if wt.device != x.device or (packed and w.signs.device != x.device):
        raise ValueError(f"x is on {x.device}, w on {wt.device}")
    if packed and (w.lo.dtype != torch.int8 or w.signs.dtype != torch.int8
                   or w.signs.shape != (w.lo.shape[0] // 8, w.lo.shape[1])
                   or w.lo.shape[0] % 8):
        raise ValueError("PackedWeight8 needs int8 lo (K8, N) and int8 signs "
                         "(K8 // 8, N) with K8 a multiple of 8")
    if quantize_x and not 1 <= bits <= MAX_BITS:
        raise ValueError(f"term_matmul kernel takes 1 <= bits <= {MAX_BITS}, "
                         f"got {bits}")
    M, K = x.shape
    N = wt.shape[1]
    mode = _mode(bf16, int8)
    route = kernel or _route(M, mode)
    clusters = (_mma_clusters(x.device.index, route, mode, fmt)
                if route in ("mma", "mma_lp") else None)
    p = plan(M, N, K, fmt, mode, _sm_count(x.device.index), route, clusters)
    if max(M, N, K) >= 2**31 or max(p.grid[1:]) > 65535:
        raise ValueError(f"term_matmul kernel: shape {(M, K, N)} too large")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    x, wt = x.contiguous(), wt.contiguous()
    signs = w.signs.contiguous() if packed else None
    sf_t = as_scale(sf, x.device) if quantize_x else None
    wsf = w.w_sf if packed else w_sf
    wsf_t = as_scale(wsf, x.device) if wsf is not None else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    budget = min(num_keep_terms, MAX_BITS + 1)
    stream = _build.stream(x.device)
    if p.kernel == "mma":
        _build.check(_build.load().tq_term_matmul_mma(
            x.data_ptr(), wt.data_ptr(), ptr(signs), ptr(sf_t), ptr(wsf_t),
            out.data_ptr(), M, N, K, bits, budget, _FORMATS[fmt],
            int(quantize_x), p.splits, p.k_per_split, stream),
            "tq_term_matmul_mma")
    elif p.kernel == "mma_lp":
        _build.check(_build.load().tq_term_matmul_mma_lp(
            x.data_ptr(), wt.data_ptr(), ptr(signs), ptr(sf_t), ptr(wsf_t),
            out.data_ptr(), M, N, K, bits, budget, _MODES[mode],
            _FORMATS[fmt], int(quantize_x), p.splits, p.k_per_split,
            stream), "tq_term_matmul_mma_lp")
    else:
        _build.check(_build.load().tq_term_matmul_stream(
            x.data_ptr(), wt.data_ptr(), ptr(signs), ptr(sf_t), ptr(wsf_t),
            out.data_ptr(), M, N, K, bits, budget, _MODES[mode],
            _FORMATS[fmt], int(quantize_x), p.splits, p.k_per_split,
            p.row_tile, stream), "tq_term_matmul_stream")
    term_matmul.launches[_variant_name(mode, fmt, quantize_x)] += 1
    term_matmul.kernel_launches[p.kernel] += 1
    return out


@functools.lru_cache(maxsize=None)
def _mma_clusters(index: int, kernel: str = "mma", mode: str = "f32",
                  fmt: str = "f32") -> tuple[int, ...]:
    """How many clusters of s = 1 .. 8 blocks of the tensor-core kernel
    ``kernel`` ("mma" on weight format ``fmt``, or "mma_lp" in ``mode``)
    the card ``index`` runs at once (the occupancy API; ragged GPCs hold
    fewer large clusters than the SM count suggests)."""
    lib = _build.load()
    with torch.cuda.device(index):
        if kernel == "mma":
            n = tuple(lib.tq_term_matmul_mma_clusters(_FORMATS[fmt], s)
                      for s in range(1, _MMA_MAX_SPLITS + 1))
        else:
            n = tuple(lib.tq_term_matmul_mma_lp_clusters(_MODES[mode], s)
                      for s in range(1, _MMA_MAX_SPLITS + 1))
    for v in n:
        if v < 0:
            _build.check(-v, f"tq_term_matmul_{kernel}_clusters")
    return n


def _route(M: int, mode: str) -> str:
    """The kernel :func:`plan` takes by default: the weight-streaming
    kernel for M <= STREAM_MAX_M; above it the tensor cores, "mma" for
    the f32 mode in every weight format and "mma_lp" for the bf16 and
    int8 modes."""
    if M <= STREAM_MAX_M:
        return "stream"
    return "mma_lp" if mode in ("bf16", "int8") else "mma"


class Plan(NamedTuple):
    """How :func:`term_matmul` launches at one shape (see :func:`plan`)."""

    kernel: str                  # "stream", "mma" or "mma_lp"
    grid: tuple[int, int, int]   # blocks along x, y, z
    row_tile: int                # rows of x a block takes
    splits: int                  # K splits (blocks of a cluster)
    k_per_split: int             # K rows a split takes (the last: the rest)


@functools.lru_cache(maxsize=1024)  # pure: computed once per shape
def plan(M: int, N: int, K: int, fmt: str, mode: str, sms: int,
         kernel: str | None = None,
         clusters: tuple[int, ...] | None = None) -> Plan:
    """The kernel, grid and K splits for an (M, K) x (K, N) product in
    weight format ``fmt`` and mode ``mode`` on a card of ``sms`` SMs.
    ``kernel`` None routes by M and mode (:func:`_route`): the
    weight-streaming kernel for M <= STREAM_MAX_M; above it the
    tensor-core kernels, ``mma`` for every f32 variant and ``mma_lp`` for
    every bf16 and int8 variant (any weight format, quantized or raw
    input).  A named ``kernel`` is taken at any M.

    * stream: a block per strip of 31 lanes x 16 bytes of columns and per
      row group of ``row_tile`` rows of x (1 for M = 1, else 8 with the
      rows past M masked: only generation's M = 1 is a workload); K split in
      multiples of 8 rows over a cluster of up to 8 blocks, as evenly
      over the SMs as one wave allows (:func:`_stream_splits`).
    * mma: a block per 32x128 output tile and K split in multiples of 8
      rows over a cluster of up to 8 blocks: the largest cluster of which
      the card runs one per tile at once (``clusters[s - 1]``: clusters of
      s blocks it runs at once; by default ``sms // s``, one block an SM);
      the partials meet in the cluster's shared memory.
    * mma_lp: the same with a 64x128 output tile and K split in
      multiples of one mma's K (16 in the bf16 mode, 32 in the int8
      mode).
    """
    if kernel is None:
        kernel = _route(M, mode)
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be 'stream', 'mma' or 'mma_lp', got "
                         f"{kernel!r}")
    if kernel == "stream":
        cols = _STREAM_LANES * (16 // _FORMAT_BYTES[fmt])
        strips = -(-N // cols)
        row_tile = 1 if M <= 1 else _STREAM_MAX_ROWS
        row_groups = -(-M // row_tile)
        groups = max(1, -(-K // _STREAM_GROUP))
        # Blocks a SM: the kernel's launch bounds (128 threads; 4 blocks
        # for one row of x, 2 for 8).
        splits = _stream_splits(max(1, strips * row_groups), groups, sms,
                                4 if row_tile == 1 else 2)
        k_per_split = -(-groups // splits) * _STREAM_GROUP
        splits = max(1, -(-K // k_per_split))
        return Plan("stream", (strips * splits, row_groups, 1), row_tile,
                    splits, k_per_split)
    if kernel == "mma":
        if mode != "f32":
            raise ValueError(f"the mma kernel takes the f32 mode, got mode "
                             f"{mode!r}")
        return _cluster_plan("mma", M, N, K, _MMA_TILE, _MMA_K_STEP, sms,
                             clusters)
    if mode not in _MMA_LP_K_STEP:
        raise ValueError(f"the mma_lp kernel takes the bf16 and int8 "
                         f"modes, got mode {mode!r}")
    return _cluster_plan("mma_lp", M, N, K, _MMA_LP_TILE,
                         _MMA_LP_K_STEP[mode], sms, clusters)


def _cluster_plan(kernel: str, M: int, N: int, K: int,
                  tile: tuple[int, int], k_step: int, sms: int,
                  clusters: tuple[int, ...] | None) -> Plan:
    """A tensor-core kernel's plan: a block per ``tile`` of the output and
    K split in multiples of ``k_step`` over the largest cluster of up to
    8 blocks of which the card runs one per tile at once (``clusters[s -
    1]``, by default ``sms // s``)."""
    rows, cols = tile
    tiles_n, tiles_m = -(-N // cols), -(-M // rows)
    k_steps = -(-K // k_step)
    fits = clusters or tuple(sms // s for s in range(1, _MMA_MAX_SPLITS + 1))
    splits = max([1] + [s for s in range(1, min(_MMA_MAX_SPLITS, k_steps) + 1)
                        if tiles_m * tiles_n <= fits[s - 1]])
    k_per_split = max(1, -(-k_steps // splits)) * k_step
    splits = max(1, -(-K // k_per_split))
    return Plan(kernel, (tiles_n * splits, tiles_m, 1), rows, splits,
                k_per_split)


def _stream_splits(blocks: int, groups: int, sms: int, per_sm: int) -> int:
    """K splits of the streaming kernel for ``blocks`` (strip, row group)
    pairs: the split, up to 8 and up to ``groups`` of 8 rows, whose
    blocks fit on the card in one wave (``per_sm`` a SM, as the launch
    bounds allow) and spread most evenly over the SMs (blocks / (sms *
    the most on one SM)); the larger split on a tie."""
    best, best_share = 1, 0.0
    for s in range(1, min(_STREAM_MAX_SPLITS, groups) + 1):
        n = blocks * s
        if n > sms * per_sm and s > 1:
            break
        share = n / (sms * -(-n // sms))
        if share >= best_share:
            best, best_share = s, share
    return best


term_matmul.launches = dict.fromkeys(VARIANTS, 0)
# Launches per kernel, whichever variant; "grouped": the grouped expert
# product (kernels/term_matmul_grouped.py), on no route of term_matmul.
term_matmul.kernel_launches = dict.fromkeys([*_KERNELS, "grouped"], 0)
