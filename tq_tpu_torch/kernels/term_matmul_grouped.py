"""Grouped TR expert product: every expert of a mixture-of-experts layer
in one CUDA launch, and its plain version.

No TPU kernel is ported here: the JAX package runs one ``term_matmul``
per expert.  :func:`term_matmul_grouped` computes, for each product g of
a :class:`GroupedWeights`,

    out[g, p] = x[p] @ q_g[e] * w_sf_g[e]   for every pair p of expert e,

``x``'s rows grouped by expert: expert e owns rows ``ends[e - 1] ..
ends[e]``, ``ends`` the inclusive prefix sums of the experts' loads, a
device tensor.  Each expert's weights are a
:class:`~tq_tpu_torch.kernels.term_matmul.PackedWeight8` of its own; the
product is ``term_matmul``'s raw-input f32 variant (``f32_raw_packed8``),
``x`` itself times the decoded weights, float32 throughout.

* On a CUDA tensor it launches ``csrc/term_matmul_grouped.cu``, which
  reads the experts' row offsets on the device: the host never reads the
  loads, so the call makes no host sync.  It raises on what the kernel
  does not take.
* On a CPU tensor it runs :func:`term_matmul_grouped_ref`, a loop of
  ``term_matmul_ref`` over the experts' slices.

``held`` (expert ids, or None for all) names the experts the call
computes; the rows of pairs of other experts are zeros.
The pairs' rows may be gathered from the caller's rows (``gather``, the
expert layer's sort), and the outputs scaled and scattered back to the
caller's pair order (``scatter``, ``scale``): the expert layer then
needs no gather, weighting or scatter of its own.

:func:`group_weights` builds the device table once per layer: each
expert's ``lo`` and ``signs`` addresses and a stacked ``w_sf``.  The
weights themselves are neither copied nor stacked; the table keeps them
alive.  An expert-parallel rank's table covers the router's every id
and holds packs for its own experts alone: an id held elsewhere has no
pack (null addresses, never read), and a call on such a table names its
experts in ``held``, each one with a pack (the table keeps their ids on
the host, :attr:`GroupedWeights.stored`, so that is checked without a
sync).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from tq_tpu_torch.kernels import _build
from tq_tpu_torch.kernels.term_matmul import (PackedWeight8, term_matmul,
                                              term_matmul_ref)
from tq_tpu_torch.kernels.tr_quantize import _sm_count
from tq_tpu_torch.ops.term_reveal import as_scale

__all__ = ["term_matmul_grouped", "term_matmul_grouped_ref", "plan",
           "GroupedPlan", "GroupedWeights", "group_weights", "layout_error",
           "max_tiles", "MAX_EXPERTS", "TILE"]

MAX_EXPERTS = 256  # experts warp 0 of a block scans (kMaxExperts)
TILE = 8           # most pairs a block takes (kTile)
# The kernel's columns a block (kStrip: 32 lanes x 4), K rows a step (one
# sign byte), most blocks in a cluster, and blocks an SM (its launch
# bounds).
_STRIP, _GROUP, _MAX_SPLITS, _BLOCKS_PER_SM = 128, 8, 8, 4
_VARIANT = "f32_raw_packed8"  # term_matmul's launch-counter key


class GroupedWeights(NamedTuple):
    """The experts of one or more products with one K and N, addressed by
    a device table (:func:`group_weights`)."""

    packs: tuple          # G tuples of E PackedWeight8 (None: held elsewhere)
    ptrs: torch.Tensor    # (G, E, 2) int64: each expert's lo, signs address
    w_sf: torch.Tensor    # (G, E) float32
    k: int                # x's columns (K)
    stored: tuple         # the ids of the experts with packs

    @property
    def n(self) -> int:
        return next(p for p in self.packs[0] if p is not None).lo.shape[1]


def layout_error(products: Sequence[Sequence], k: int) -> str | None:
    """Why the kernel cannot take these experts' weights (one sequence of
    E per product, None for an expert held elsewhere) at ``k`` input
    columns, or None: each a :class:`PackedWeight8` of contiguous int8
    planes, (K8, N) and (K8 / 8, N) with K <= K8 < K + 8, one N for all, a
    multiple of 16, every plane 16-byte aligned (the kernel's 16-byte
    copies), all on one device; at most :data:`MAX_EXPERTS` experts, as
    many in each product, at least one with a pack, the same ones in
    each."""
    if not products or not products[0]:
        return "no experts"
    E = len(products[0])
    if E > MAX_EXPERTS:
        return f"{E} experts, more than {MAX_EXPERTS}"
    stored = [p is not None for p in products[0]]
    if not any(stored):
        return "no expert has a pack"
    first = products[0][stored.index(True)]
    if not isinstance(first, PackedWeight8):
        return f"experts' weights are {type(first).__name__}, not PackedWeight8"
    N, dev = first.lo.shape[-1], first.lo.device
    if N % 16:
        return f"N = {N} is not a multiple of 16"
    for packs in products:
        if len(packs) != E:
            return f"products of {len(packs)} and {E} experts"
        if [p is not None for p in packs] != stored:
            return "products hold packs of different experts"
        for p in packs:
            if p is None:
                continue
            if not isinstance(p, PackedWeight8):
                return (f"experts' weights are {type(p).__name__}, not "
                        "PackedWeight8")
            lo, signs = p.lo, p.signs
            K8 = lo.shape[0]
            if (lo.dtype != torch.int8 or signs.dtype != torch.int8
                    or lo.dim() != 2 or lo.shape[1] != N or K8 % 8
                    or signs.shape != (K8 // 8, N)
                    or not k <= K8 < k + 8):
                return (f"PackedWeight8 planes {tuple(lo.shape)}, "
                        f"{tuple(signs.shape)} do not hold ({k}, {N})")
            if not (lo.is_contiguous() and signs.is_contiguous()):
                return "PackedWeight8 planes are not contiguous"
            if lo.data_ptr() % 16 or signs.data_ptr() % 16:
                return "PackedWeight8 planes are not 16-byte aligned"
            if lo.device != dev or signs.device != dev:
                return f"experts on {lo.device} and {dev}"
    return None


def group_weights(products: Sequence[Sequence[PackedWeight8 | None]],
                  k: int) -> GroupedWeights:
    """The device table of the experts' 9-bit packs, one sequence of E
    per product (gate and up may share a launch; None for an expert held
    elsewhere): their planes' addresses and their w_sf stacked, on their
    device, zeros for an expert without a pack.  Raises where
    :func:`layout_error` finds a fault."""
    err = layout_error(products, k)
    if err is not None:
        raise ValueError(f"term_matmul_grouped: {err}")
    packs = tuple(tuple(p) for p in products)
    dev = next(p for p in packs[0] if p is not None).lo.device
    ptrs = torch.tensor([[[p.lo.data_ptr(), p.signs.data_ptr()]
                          if p is not None else [0, 0] for p in ps]
                         for ps in packs], dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w_sf = torch.stack([torch.stack([as_scale(p.w_sf, dev) if p is not None
                                     else zero for p in ps])
                        for ps in packs])
    return GroupedWeights(packs, ptrs, w_sf, k,
                          tuple(e for e, p in enumerate(packs[0])
                                if p is not None))


def term_matmul_grouped_ref(x: torch.Tensor, ends: torch.Tensor,
                            gw: GroupedWeights,
                            held: Sequence[int] | None = None, *,
                            gather: torch.Tensor | None = None,
                            top_k: int = 1,
                            scatter: torch.Tensor | None = None,
                            scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain version of :func:`term_matmul_grouped`: the pairs' rows
    gathered, ``term_matmul_ref`` on each held expert's rows, product by
    product, then scaled and scattered; (G, P, N) float32, zeros in the
    rows of pairs of experts not held."""
    _held(gw, held, x.device)
    if gather is not None:
        x = x.index_select(0, gather // top_k)
    out = torch.zeros((len(gw.packs), x.shape[0], gw.n), dtype=torch.float32,
                      device=x.device)
    keep = None if held is None else set(held)
    start = 0
    for e, stop in enumerate(ends.tolist()):
        if stop > start and (keep is None or e in keep):
            for g, packs in enumerate(gw.packs):
                out[g, start:stop] = term_matmul_ref(
                    x[start:stop], packs[e], 1.0, quantize_x=False)
        start = stop
    rows = (scatter if scatter is not None
            else torch.arange(x.shape[0], device=x.device))
    if scale is not None:
        out = out * scale[rows][:, None]
    if scatter is not None:
        out = torch.zeros_like(out).index_copy_(1, scatter, out)
    return out


def max_tiles(P: int, E: int) -> int:
    """The most row tiles of :data:`TILE` pairs that P pairs over E
    experts make: the sum of ceil(load / 8) over the experts with pairs
    is at most (P + 7 min(E, P)) / 8 (at most ceil(P / 8) + E)."""
    return max(1, (P + 7 * min(E, P)) // TILE)


class GroupedPlan(NamedTuple):
    """How :func:`term_matmul_grouped` launches at one shape."""

    grid: tuple[int, int, int]  # strips x splits, row tiles, products
    splits: int                 # K splits (cluster blocks)
    k_per_split: int            # K rows a split takes (the last: the rest)


@functools.lru_cache(maxsize=1024)  # pure: computed once per shape
def plan(P: int, E: int, N: int, K: int, G: int, sms: int) -> GroupedPlan:
    """The grid and K splits of G products of P pairs over E experts
    (those that may own row tiles: the experts with packs), (K, N) each,
    on a card of ``sms`` SMs: a block per strip of 128 columns, row tile
    (:func:`max_tiles`, known without the loads) and product; K split
    over a cluster, up to 8 and up to K's groups of 8 rows, only while
    the blocks fit one wave (``_BLOCKS_PER_SM`` an SM):
    a decode step's ~100 tiles fill the card unsplit, a few pairs do
    not."""
    strips = -(-N // _STRIP)
    tiles = max_tiles(P, E)
    groups = -(-K // _GROUP)
    blocks = strips * tiles * G
    splits = 1
    while (splits < min(_MAX_SPLITS, groups)
           and blocks * (splits + 1) <= sms * _BLOCKS_PER_SM):
        splits += 1
    k_per_split = -(-groups // splits) * _GROUP
    splits = -(-K // k_per_split)
    return GroupedPlan((strips * splits, tiles, G), splits, k_per_split)


def _pairs(x: torch.Tensor, gw: GroupedWeights, gather) -> int:
    """The pairs of a call, from shapes alone, checking x's."""
    if x.dtype != torch.float32:
        raise TypeError(f"term_matmul_grouped kernel takes float32 x, got "
                        f"{x.dtype}")
    if x.ndim != 2 or x.shape[1] != gw.k:
        raise ValueError(f"term_matmul_grouped takes x (P, {gw.k}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("term_matmul_grouped kernel takes a contiguous x")
    return gather.shape[0] if gather is not None else x.shape[0]


@functools.lru_cache(maxsize=64)
def _held_mask(held: tuple, stored: tuple, E: int, device) -> torch.Tensor:
    missing = sorted(set(held) - set(stored))
    if missing:
        raise ValueError(f"term_matmul_grouped: held experts {missing[:8]} "
                         "have no pack")
    mask = torch.zeros(E, dtype=torch.bool)
    mask[list(held)] = True
    return mask.to(device)


def _held(gw: GroupedWeights, held, device) -> torch.Tensor | None:
    """The kernel's (E,) mask of the experts ``held`` names (None: every
    expert), built once a share; refused where one of them has no pack,
    or where ``held`` is None and some expert has none."""
    E = gw.ptrs.shape[1]
    if held is None:
        if len(gw.stored) < E:
            raise ValueError(f"term_matmul_grouped: a table of "
                             f"{len(gw.stored)} packs for {E} experts "
                             "takes `held`")
        return None
    return _held_mask(tuple(held), gw.stored, E, device)


def _check(x: torch.Tensor, P: int, ends: torch.Tensor, gw: GroupedWeights,
           gather, scatter, scale) -> None:
    E = gw.ptrs.shape[1]
    if (ends.dtype != torch.int64 or ends.shape != (E,)
            or not ends.is_contiguous()):
        raise ValueError(f"term_matmul_grouped takes ends ({E},) int64, got "
                         f"{tuple(ends.shape)} {ends.dtype}")
    for name, t, dtype in (("gather", gather, torch.int64),
                           ("scatter", scatter, torch.int64),
                           ("scale", scale, torch.float32)):
        if t is not None and (t.dtype != dtype or t.shape != (P,)
                              or not t.is_contiguous()):
            raise ValueError(f"term_matmul_grouped takes {name} ({P},) "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("ends", ends), ("the experts", gw.ptrs),
                    ("gather", gather), ("scatter", scatter),
                    ("scale", scale)):
        if t is not None and t.device != x.device:
            raise ValueError(f"x is on {x.device}, {name} on {t.device}")


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def term_matmul_grouped(x: torch.Tensor, ends: torch.Tensor,
                        gw: GroupedWeights,
                        held: Sequence[int] | None = None, *,
                        gather: torch.Tensor | None = None, top_k: int = 1,
                        scatter: torch.Tensor | None = None,
                        scale: torch.Tensor | None = None) -> torch.Tensor:
    """(G, P, N) float32: each product of ``gw`` on the rows of each
    expert's pairs (``ends``: the loads' inclusive prefix sums, (E,)
    int64; ``held``: the ids of the experts computed, all when None, the
    others' rows zeros; it names only experts with packs, and is required
    where some have none).  Pair p's row is ``x[p]`` of x (P, K), or ``x[gather[p]
    // top_k]`` with ``gather``.  Its output goes to row p, or to row
    ``scatter[p]``,
    times ``scale[scatter[p]]`` with ``scale`` (``scale[p]`` without
    ``scatter``).  The kernel on CUDA tensors, with no host sync; the
    plain version on CPU tensors."""
    kw = dict(gather=gather, top_k=top_k, scatter=scatter, scale=scale)
    if not x.is_cuda:
        return term_matmul_grouped_ref(x, ends, gw, held, **kw)
    P = _pairs(x, gw, gather)
    _check(x, P, ends, gw, gather, scatter, scale)
    mask = _held(gw, held, x.device)
    K = gw.k
    G, E = gw.w_sf.shape
    N = gw.n
    out = (torch.zeros if mask is not None else torch.empty)(
        (G, P, N), dtype=torch.float32, device=x.device)
    if not P:
        return out
    # Row tiles are counted over the experts with packs alone: every
    # expert that ``held`` names has one.
    p = plan(P, len(gw.stored), N, K, G, _sm_count(x.device.index))
    if P >= 2**31 or max(p.grid[1:]) > 65535:
        raise ValueError(f"term_matmul_grouped kernel: {P} pairs of {G} "
                         "products too many")
    _build.check(_build.load().tq_term_matmul_grouped(
        x.data_ptr(), ends.data_ptr(), _ptr(mask), gw.ptrs.data_ptr(),
        gw.w_sf.data_ptr(), out.data_ptr(), _ptr(gather), _ptr(scatter),
        _ptr(scale), P, E, N, K, G, p.grid[1], p.splits, p.k_per_split,
        top_k, _build.stream(x.device)),
        "tq_term_matmul_grouped")
    term_matmul.launches[_VARIANT] += 1
    term_matmul.kernel_launches["grouped"] += 1
    return out
