"""The element-wise ``tr_quantize`` kernels' launch plan and their reveal
arithmetic, on the CPU.

The CUDA kernels (``csrc/tr_quantize.cu``) run only on the card, where
``chip_smoke.py`` holds them bit for bit against the plain versions.  Here:

* :func:`plan`'s span and grid, run through a simulation of the kernel's
  loops (one element at a time over the head and the tail, ``_UNROLL``
  16-byte vectors a thread a tile over the rest), cover every element
  exactly once, at every start offset of ``x`` within 16 bytes;
* the kernel's reveal, emulated in numpy step for step (the keep-terms
  loop interleaved over a thread's elements with its early exit, the
  shortcut for a budget of at least the term count), equals the JAX
  package's kernel (interpret mode) and the port's plain version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import tr_quantize as tk

jk = importlib.import_module("tq_tpu.kernels.tr_quantize")

SMS, PER_SM = 132, 8  # an H100's SMs; blocks an SM as the occupancy API
RESNET_N = 200_704 * 64  # a (64, 56, 56, 64) activation

# (input bytes, output bytes): float32 in, float32 or int32 out; bfloat16
# in, bfloat16 or int32 out.
PAIRS = [(4, 4), (2, 2), (2, 4)]
# x 0-3 (float32) or 0-7 (bfloat16) elements past a 16-byte boundary.
STARTS = [(i, o, k) for i, o in PAIRS for k in range(16 // i)]


def _simulate(p, n: int) -> np.ndarray:
    """How often the kernel's loops touch each of the n elements under
    plan ``p`` (csrc/tr_quantize.cu::elementwise)."""
    cover = np.zeros(n, np.uint8)
    threads, tile = tk._THREADS, tk._UNROLL * tk._THREADS
    # One element at a time, grid-stride: thread g takes i = g where there
    # are no vectors, else i = stride - 1 - g (the threads a million at a
    # time).
    stride = p.blocks * threads
    singles = p.head + p.tail
    vec_end = p.head + p.n_vec * p.vec
    for start in range(0, singles, stride):
        for g0 in range(0, stride, 1 << 20):
            g = np.arange(g0, min(stride, g0 + (1 << 20)), dtype=np.int64)
            i = start + (stride - 1 - g if p.n_vec else g)
            i = i[i < singles]
            cover[np.where(i < p.head, i, vec_end + (i - p.head))] += 1
    # Vectors: thread (b, t) from b * tile + t, grid-stride by blocks *
    # tile, taking t + u * threads for u < _UNROLL.
    first = (np.arange(p.blocks, dtype=np.int64)[:, None] * tile
             + np.arange(threads)[None, :]).ravel()
    for start in range(0, p.n_vec, p.blocks * tile):
        t = first + start
        t = t[t < p.n_vec]
        for u in range(tk._UNROLL):
            j = t + u * threads
            j = j[j < p.n_vec]
            for k in range(p.vec):
                cover[p.head + j * p.vec + k] += 1
    return cover


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 31, 257, RESNET_N,
                               RESNET_N + 3])
@pytest.mark.parametrize("in_size,out_size,offset", STARTS)
def test_plan_covers_every_element_once(n, in_size, out_size, offset):
    """x starts ``offset`` elements past a 16-byte boundary; the output is
    aligned, or as far past a boundary as lets the same element align
    both."""
    x_addr = offset * in_size
    for out_addr in {0, (offset * out_size) % 16}:
        p = tk.plan(n, x_addr, out_addr, in_size, out_size, SMS, PER_SM)
        assert p.head + p.n_vec * p.vec + p.tail == n
        assert (_simulate(p, n) == 1).all()
        if p.n_vec:
            assert (x_addr + p.head * in_size) % 16 == 0
            assert (out_addr + p.head * out_size) % 16 == 0
            assert p.head < p.vec and p.tail < p.vec
            assert 1 <= p.blocks <= SMS * PER_SM
        else:  # a block per _THREADS elements
            assert p.blocks == -(-n // tk._THREADS)


@pytest.mark.parametrize("in_size,out_size", PAIRS)
def test_plan_vector_width_falls_to_one_where_misaligned(in_size, out_size):
    n = 1 << 20
    vec = 16 // in_size
    aligned = tk.plan(n, 0, 0, in_size, out_size, SMS, PER_SM)
    assert (aligned.vec, aligned.head, aligned.per_thread) == (
        vec, 0, vec * tk._UNROLL)
    # x one element past a boundary, the output on one: no element aligns
    # both (for bfloat16 into int32, 4 elements past one would).
    for x_addr, out_addr in [(in_size, 0), (0, out_size), (0, 8),
                             (1, 0), (0, 1), (in_size, 3 * out_size)]:
        p = tk.plan(n, x_addr, out_addr, in_size, out_size, SMS, PER_SM)
        assert (p.vec, p.per_thread, p.head, p.n_vec, p.tail) == (
            1, 1, n, 0, 0), (x_addr, out_addr)
    # Both as far past a boundary: the head aligns them.
    p = tk.plan(n, in_size, out_size, in_size, out_size, SMS, PER_SM)
    assert (p.vec, p.head) == (vec, vec - 1)
    assert p.n_vec == (n - p.head) // vec


def test_plan_sizes_the_grid():
    p = tk.plan(RESNET_N, 0, 0, 4, 4, SMS, PER_SM)
    assert p.blocks == SMS * PER_SM
    # The serving generator's (1, 650): one element a thread, 3 blocks.
    assert tk.plan(650, 0, 0, 4, 4, SMS, PER_SM) == tk.ElementwisePlan(
        vec=1, per_thread=1, head=650, n_vec=0, tail=0, blocks=3)
    with pytest.raises(ValueError, match="32"):
        tk.plan(2**33 + 8, 0, 0, 4, 4, SMS, PER_SM)


@pytest.mark.parametrize("in_size,out_size", PAIRS)
def test_plan_takes_small_n_one_element_a_thread(in_size, out_size):
    """Vectors only where one wave of threads of one element each does not
    cover x; below, one element a thread, a block per _THREADS: the LSTM's
    (10, 650) and (350, 650) activations go that way, a ResNet-18 layer4
    activation does not."""
    vec = 16 // in_size
    wave = SMS * tk._SM_THREADS
    for n in (1, 650, 6500, 227_500, wave):
        assert tk.plan(n, 0, 0, in_size, out_size, SMS, PER_SM) == (
            tk.ElementwisePlan(1, 1, n, 0, 0, -(-n // tk._THREADS)))
    for n in (wave + 1, 455_000, 64 * 7 * 7 * 512):
        p = tk.plan(n, 0, 0, in_size, out_size, SMS, PER_SM)
        assert p.vec == vec and p.n_vec == n // vec


@pytest.mark.parametrize("offset", [0, 1, 5])
def test_chunks_split_a_launch_at_aligned_starts(monkeypatch, offset):
    """Past ``_CHUNK`` elements a launch is split, each piece starting
    where x does modulo 16 bytes, so that its vectors index in 32 bits and
    the plan of every whole piece is the same."""
    monkeypatch.setattr(tk, "_CHUNK", 32)
    x = torch.arange(offset + 100, dtype=torch.float32)[offset:]
    out = torch.empty(100, dtype=torch.int32)
    pieces = tk._chunks(x, out)
    assert [p.numel() for p, _ in pieces] == [32, 32, 32, 4]
    assert torch.equal(torch.cat([p for p, _ in pieces]), x)
    for xs, outs in pieces:
        assert xs.numel() == outs.numel()
        assert (xs.data_ptr() - x.data_ptr()) % 16 == 0
        assert (outs.data_ptr() - out.data_ptr()) % 16 == 0
    (whole,) = tk._chunks(x[:32], out[:32])  # one launch, no slicing
    assert whole[0].data_ptr() == x.data_ptr() and whole[0].numel() == 32
    assert tk._chunks(x[:0], out[:0]) == ()


def _top_bit(r: np.ndarray) -> np.ndarray:
    """bfind then shl: the highest set bit, 0 for 0."""
    out = np.zeros_like(r)
    nz = r != 0
    out[nz] = np.left_shift(np.uint32(1),
                            np.floor(np.log2(r[nz])).astype(np.uint32))
    return out


def _kernel_values(q: np.ndarray, bits: int, budget: int, serial: bool,
                   per_thread: int) -> np.ndarray:
    """The kernel's signed kept value of each uint32 q, as
    Reveal::operator() and tq::keep_terms_n compute it: the keep-terms
    loop stepping ``per_thread`` elements together until the budget or no
    term is left in any, skipped where the budget is at least the term
    count."""
    if budget >= 2 * (bits + 1) // 3:
        return q.astype(np.int32)
    q = q.reshape(-1, per_thread)
    dn1 = q << np.uint32(1)
    a = q & ~dn1
    t = a | (dn1 & (q << np.uint32(2)) & ~q)
    neg = (q >> np.uint32(1)) & a
    rest = t.copy()
    for row in range(rest.shape[0]):
        r = rest[row]
        for _ in range(budget):
            if not r.any():
                break
            r = r & (r - np.uint32(1)) if serial else r ^ _top_bit(r)
        rest[row] = r
    kept = t ^ rest
    val = kept.astype(np.int64) - ((kept & neg).astype(np.int64) << 1)
    return val.astype(np.int32).ravel()


@pytest.mark.parametrize("mode", ["largest", "serial"])
@pytest.mark.parametrize("bits", [1, 3, 9, 16, 24])
def test_interleaved_reveal_matches_jax(rng, bits, mode):
    """The kernel's reveal over 16 elements a thread (the bfloat16 body)
    and 8 (the float32 body), at every budget, against the JAX package's
    kernel and the port's plain int variant."""
    sf = np.float32(0.0371)
    hi = min(2**bits, 1 << 11)
    q = np.concatenate([np.arange(hi), rng.integers(0, 2**bits, 2048 - hi)])
    x = (rng.permutation(q).astype(np.float64) * sf).astype(np.float32)
    x[1::2] *= -1
    xt, sft = torch.from_numpy(x), torch.tensor(sf)
    budgets = list(range(0, tk.max_hese_terms(bits) + 2))
    run = jax.jit(lambda v, s: [jk.tr_quantize(v, s, bits, 1, b,
                                               keep_mode=mode)
                                for b in budgets])
    want = run(jnp.asarray(x), jnp.float32(sf))
    # q itself: every term kept.
    q = np.abs(tk.tr_quantize_int_ref(xt, sft, bits, budgets[-1],
                                      mode).numpy()).astype(np.uint32)
    for budget, w in zip(budgets, want):
        plain = tk.tr_quantize_int_ref(xt, sft, bits, budget, mode).numpy()
        np.testing.assert_array_equal(plain.astype(np.float32) * sf,
                                      np.asarray(w))
        for per_thread in (8, 16):
            got = _kernel_values(q, bits, budget, mode == "serial",
                                 per_thread)
            np.testing.assert_array_equal(np.where(x < 0, -got, got), plain,
                                          err_msg=f"budget {budget}")


def test_quantize_rounds_down_after_the_clamp():
    """quantize_rcp's floor(min(y + 0.5, maxq)) equals the plain version's
    min(floor(y + 0.5), maxq) for y past maxq, at the boundaries below it,
    for infinities and for NaN (fminf returns maxq)."""
    for bits in (1, 9, 24):
        maxq = np.float32(2**bits - 1)
        y = np.concatenate([np.arange(0, 2**min(bits, 12) + 3) - 0.5,
                            [maxq - 0.5, maxq, maxq + 0.49, 2.0**30, 1e30,
                             np.inf, np.nan]]).astype(np.float32)
        y = np.concatenate([y, np.nextafter(y, np.float32(np.inf))])
        y = y[~(y < 0)]
        with np.errstate(invalid="ignore"):
            got = np.floor(np.fmin(y + np.float32(0.5), maxq))
            want = np.fmin(np.floor(y + np.float32(0.5)), maxq)
        np.testing.assert_array_equal(got, want)


def test_launch_refuses_a_wrong_output():
    """The launcher's ``out`` must be contiguous, of x's shape and the
    output type: anything else raises before a launch."""
    x = torch.zeros(8)
    for out in (torch.empty(7), torch.empty(8, dtype=torch.int32),
                torch.empty(16)[::2]):
        with pytest.raises(ValueError, match="out must be"):
            tk._launch_elementwise(x, 0.1, 8, 3, "largest", False, out=out)
    with pytest.raises(ValueError, match="out must be"):
        tk._launch_elementwise(x, 0.1, 8, 3, "largest", True,
                               out=torch.empty(8))
