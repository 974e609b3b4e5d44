"""The grouped ``tr_quantize`` kernel (B2): its index map and its plane
walk, emulated in numpy on the CPU.

The CUDA kernel (``csrc/tr_quantize.cu::tr_grouped_kernel``) runs only on
the card, where ``chip_smoke.py`` holds it bit for bit against the plain
version.  Here :func:`_emulate` repeats it step for step:

* the index map: ``x`` viewed in place as ``(outer, n, inner)``
  (:func:`grouped_view`), a thread per cell (outer, group, column),
  reading the group's elements ``inner`` apart and writing the results
  back at the same addresses; every element is read and written exactly
  once, on every axis, with a trailing partial group;
* the plane walk in cut-plane form: the planes holding a term of the
  group visited in the reference's order, each plane's terms counted,
  the walk stopped at the plane where the budget runs out, then the
  terms above it kept and the cut plane's in the first ``rem`` elements
  in ascending index; it equals the port's plain version at every budget
  and the JAX package's grouped kernel (interpret mode).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import tr_quantize as tk

jk = importlib.import_module("tq_tpu.kernels.tr_quantize")

MAX_GROUP = 32  # the generic instantiation's width (kMaxGroup)


def _cells(shape, axis, g):
    """Every thread's flat element index of its group's row j, as the
    kernel's cell_of and address arithmetic give them: int64 ``(cells, G)``
    addresses, -1 where the row is absent (past the trailing partial group
    or, in the generic instantiation, past g)."""
    outer, n, inner = tk.grouped_view(tuple(shape), axis)
    groups = -(-n // g)
    t = np.arange(outer * groups * inner, dtype=np.int64)
    col, r = t % inner, t // inner
    grp, o = r % groups, r // groups
    first = grp * g
    m = np.minimum(g, n - first)  # rows present
    at = (o * n + first) * inner + col
    j = np.arange(g if g in (8, 16) else MAX_GROUP)
    addr = at[:, None] + j[None, :] * inner
    return np.where(j < m[:, None], addr, -1)


def _walk(t: np.ndarray, budget: int, serial: bool):
    """CutPlane over the uint32 term masks t (cells, G): the planes kept
    whole, the cut plane (0 if none) and the terms left for it."""
    planes = np.bitwise_or.reduce(t, axis=1)
    rem = np.full(t.shape[0], budget, np.int64)
    whole = np.zeros_like(planes)
    cut = np.zeros_like(planes)
    live = np.ones(t.shape[0], bool)
    for _ in range(32):
        live &= (planes != 0) & (rem > 0)
        if not live.any():
            break
        if serial:
            p = planes & (np.uint32(0) - planes)
        else:
            p = np.zeros_like(planes)
            nz = planes != 0
            p[nz] = np.left_shift(np.uint32(1), np.floor(
                np.log2(planes[nz].astype(np.float64))).astype(np.uint32))
        c = ((t & p[:, None]) != 0).sum(axis=1)
        stop = live & (c > rem)
        cut[stop] = p[stop]
        go = live & ~stop
        whole[go] |= p[go]
        rem[go] -= c[go]
        planes[go] ^= p[go]
        live &= ~stop
    return whole, cut, rem


def _masks(v: np.ndarray, sf: np.float32, bits: int):
    """(q, t, neg): the kernel's quotient and term masks, uint32."""
    maxq = np.float32(2**bits - 1)
    q = np.fmin(np.floor(np.abs(v) / sf + np.float32(0.5)), maxq)
    q = q.astype(np.uint32)
    dn1 = q << np.uint32(1)
    a = q & ~dn1
    t = a | (dn1 & (q << np.uint32(2)) & ~q)
    return q, t, (q >> np.uint32(1)) & a


def _emulate(x: np.ndarray, sf: np.float32, bits: int, g: int, budget: int,
             axis: int, serial: bool):
    """The kernel's output on float32 ``x``, and how often it read and
    wrote each element."""
    addr = _cells(x.shape, axis, g)
    flat = x.reshape(-1)
    present = addr >= 0
    reads = np.bincount(addr[present], minlength=flat.size)
    G = addr.shape[1]
    v = np.where(present, flat[np.where(present, addr, 0)], np.float32(0))
    q, t, neg = _masks(v, sf, bits)
    whole, cut, rem = _walk(t, budget, serial)
    res = np.empty_like(v)
    for j in range(G):  # ascending index
        kept = t[:, j] & whole
        take = ((t[:, j] & cut) != 0) & (rem > 0)
        kept[take] |= cut[take]
        rem -= take
        val = (kept.astype(np.int64)
               - ((kept & neg[:, j]).astype(np.int64) << 1))
        m = val.astype(np.float32)
        res[:, j] = np.where(v[:, j] < 0, -m, m) * sf
    out = np.full_like(flat, np.nan)
    writes = np.bincount(addr[present], minlength=flat.size)
    out[addr[present]] = res[present]
    return out.reshape(x.shape), reads, writes


@pytest.mark.parametrize("shape,axis", [
    ((37, 64), 0), ((37, 64), 1),                          # inner 64, 1
    ((5, 19, 10), 0), ((5, 19, 10), 1), ((5, 19, 10), 2),  # inner 10, 1
    ((3, 3, 21, 3), 0), ((3, 3, 21, 3), 1), ((3, 3, 21, 3), 2),  # inner 3
    ((3, 3, 21, 3), 3), ((3, 3, 21, 3), -2),
    ((2, 45, 64), 1), ((3, 3, 20, 12), 2)])
@pytest.mark.parametrize("g", [3, 8, 16])
def test_index_map_reads_and_writes_every_element_once(shape, axis, g):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    out, reads, writes = _emulate(x, np.float32(0.05), 9, g, 12, axis, False)
    assert (reads == 1).all() and (writes == 1).all()
    # The output lies in x's own layout: the plain version's values.
    want = tk.tr_quantize_ref(torch.from_numpy(x), torch.tensor(0.05), 9, g,
                              12, axis).numpy()
    np.testing.assert_array_equal(out, want)


def test_grouped_view_reads_x_in_place():
    assert tk.grouped_view((3, 3, 512, 512), 2) == (9, 512, 512)
    assert tk.grouped_view((3, 3, 512, 512), -2) == (9, 512, 512)
    assert tk.grouped_view((784, 512), 0) == (1, 784, 512)
    assert tk.grouped_view((24, 64), -1) == (24, 64, 1)
    assert tk.grouped_view((7,), 0) == (1, 7, 1)


@pytest.mark.parametrize("shape,axis,g", [
    ((3 << 30, 3), 0, 2), ((5, 1 << 33), 1, 8),
    ((7, (1 << 32) + 5, 3), 1, 16)])
def test_cell_numbering_past_32_bits(shape, axis, g):
    """Past 2^32 cells the kernel numbers them in 64 bits: the last cell's
    last row is x's last element (Python integers, as the 64-bit path)."""
    outer, n, inner = tk.grouped_view(shape, axis)
    groups = -(-n // g)
    cells = outer * groups * inner
    assert cells > 2**32
    t = cells - 1
    col, r = t % inner, t // inner
    grp, o = r % groups, r // groups
    m = min(g, n - grp * g)
    last = (o * n + grp * g) * inner + col + (m - 1) * inner
    assert last == np.prod(shape, dtype=object) - 1


def _group_data(rng, g: int, bits: int, inner: int = 5):
    """x of shape (3g + tail, inner), grouped on axis 0 with a trailing
    partial group (none where g is 2): every plane below ``bits`` used,
    each group's term count anywhere from 0 to full (elements dropped to
    zero with a probability drawn per group), and every element at a
    multiple of sf or between two."""
    n = 3 * g + (g // 2 if g > 2 else 0)
    sf = np.float32(0.0371)
    q = np.floor(2.0 ** rng.uniform(0, bits, size=(n, inner)))
    q = np.minimum(q, 2**bits - 1)
    keep = rng.uniform(size=(-(-n // g), inner))
    q *= rng.uniform(size=(n, inner)) < np.repeat(keep, g, axis=0)[:n]
    frac = rng.choice([0.0, 0.25, -0.25, 0.49], size=q.shape)
    x = (np.maximum(q + frac, 0) * sf).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.5] *= -1
    return x, sf


@pytest.mark.parametrize("mode", ["largest", "serial"])
@pytest.mark.parametrize("bits", [1, 4, 9, 16, 24])
@pytest.mark.parametrize("g", [2, 3, 7, 8, 16, 31, 32])
def test_plane_walk_matches_jax(g, bits, mode):
    """The emulated kernel at every budget from 0 to past the largest
    group's term count against the plain version, and at a budget that
    cuts about half the groups inside a plane against the JAX package's
    kernel."""
    rng = np.random.default_rng(g * 100 + bits)
    x, sf = _group_data(rng, g, bits)
    xt, sft = torch.from_numpy(x), torch.tensor(sf)
    serial = mode == "serial"
    terms = np.bitwise_count(_masks(x, sf, bits)[1])
    counts = np.pad(terms, ((0, -x.shape[0] % g), (0, 0))).reshape(
        -1, g, x.shape[1]).sum(1)  # each group's term count
    for budget in range(0, int(counts.max()) + 2):
        got, _, _ = _emulate(x, sf, bits, g, budget, 0, serial)
        want = tk.tr_quantize_ref(xt, sft, bits, g, budget, 0, mode).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"budget {budget}")
    budget = int(np.median(counts[counts > 0])) - 1
    jax_out = np.asarray(jax.jit(
        lambda v, s: jk.tr_quantize(v, s, bits, g, budget, axis=0,
                                    keep_mode=mode))(jnp.asarray(x), sf))
    got, _, _ = _emulate(x, sf, bits, g, budget, 0, serial)
    np.testing.assert_array_equal(got, jax_out)
    assert (counts > budget).any() and (counts <= budget).any()
