"""The port's fused term matmul, every mode and weight format, and its
weight packing, against the JAX package's (``term_matmul`` runs in
interpret mode on the CPU)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import term_matmul as tm
from tq_tpu_torch.utils.params import params_from_jax

jm = importlib.import_module("tq_tpu.kernels.term_matmul")


def _close(got: torch.Tensor, want, rtol=1e-5):
    """The f32 mode's tolerance for float32 sums taken in another order:
    rtol=1e-5, atol=1e-4 * max|ref|."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (13, 100, 7), (130, 300, 70)])
@pytest.mark.parametrize("bits,terms", [(8, 3), (4, 2), (9, 9)])
def test_plain_version_matches_jax_f32(rng, M, K, N, bits, terms):
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    sf = np.float32(0.03)
    want = np.asarray(jm.term_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.float32(sf), bits, terms,
                                     bm=64, bk=128, bn=128))
    got = tm.term_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.tensor(sf), bits, terms)
    # Float32 sums taken in another order: tests/test_term_matmul.py's
    # CPU tolerance.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        got, tm.term_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                torch.tensor(sf), bits, terms),
        rtol=0, atol=0)


def _weights(rng, fmt: str, K: int, N: int):
    """(JAX weight, port weight, w_sf or None) in format ``fmt``: the
    same values on both sides (integer weights hold q, the pack q*w_sf)."""
    w_sf = np.float32(0.0123)
    if fmt == "f32":
        w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
        return jnp.asarray(w), torch.from_numpy(w), None
    if fmt == "bf16":
        w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
        return (jnp.asarray(w, jnp.bfloat16),
                torch.from_numpy(w).to(torch.bfloat16), None)
    if fmt in ("int8", "int16"):
        hi = 127 if fmt == "int8" else 255
        q = rng.integers(-hi, hi + 1, size=(K, N)).astype(fmt)
        return (jnp.asarray(q), torch.from_numpy(q), w_sf)
    q = rng.integers(-255, 256, size=(K, N)).astype(np.float32)
    wq = (q * w_sf).astype(np.float32)
    jw = jm.pack_weight_u8s(jnp.asarray(wq), jnp.float32(w_sf), 8)
    tw = tm.pack_weight_u8s(torch.from_numpy(wq), torch.tensor(w_sf), 8)
    for a, b in zip(jw, tw):  # the pack, byte for byte
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jw, tw, None


FORMATS = ("f32", "bf16", "int8", "int16", "packed8")


@pytest.mark.parametrize("M,K,N", [(5, 37, 19), (70, 130, 66), (1, 37, 34)])
@pytest.mark.parametrize("mode,fmt,quantize_x", [
    (m, f, q) for m in ("f32", "bf16") for f in FORMATS for q in (True, False)
] + [("int8", "int8", True)])
def test_every_mode_matches_jax(rng, mode, fmt, quantize_x, M, K, N):
    x = rng.normal(size=(M, K)).astype(np.float32)
    jw, tw, w_sf = _weights(rng, fmt, K, N)
    bits, terms = (6, 3) if mode == "int8" else (8, 3)
    sf = np.float32(0.03)
    kw = dict(bf16=mode == "bf16", int8=mode == "int8",
              quantize_x=quantize_x)
    want = jm.term_matmul(jnp.asarray(x), jw, jnp.float32(sf), bits, terms,
                          w_sf=None if w_sf is None else jnp.float32(w_sf),
                          bm=64, bk=128, bn=128, **kw)
    tw_sf = None if w_sf is None else torch.tensor(w_sf)
    got = tm.term_matmul(torch.from_numpy(x), tw, torch.tensor(sf), bits,
                         terms, w_sf=tw_sf, **kw)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    if mode == "int8":  # int32 accumulation: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)
    assert tm.variant(kw["bf16"], kw["int8"], tw, quantize_x) in tm.VARIANTS


def test_cpu_tensor_counts_no_launch(rng):
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    tm.term_matmul(x, w, 0.1, 6, 2)
    tm.term_matmul(x, w.to(torch.int8), 0.1, 6, 2, int8=True,
                   w_sf=torch.tensor(0.5))
    assert set(tm.term_matmul.launches) == set(tm.VARIANTS)
    assert len(tm.VARIANTS) == 21
    assert not any(tm.term_matmul.launches.values())
    assert set(tm.term_matmul.kernel_launches) == {"stream", "mma",
                                                   "mma_lp", "grouped"}
    assert not any(tm.term_matmul.kernel_launches.values())


def test_launch_refuses_cpu_tensors():
    """The kernel path never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.launch(torch.zeros(1, 8), torch.zeros(8, 3), 0.1, 6, 2)


# Shapes of the plan tests: the LSTM serving shapes at M = 1, 2, 8 and 16,
# the eval shapes (M = 128, 350), ragged ones (N = 34 = 2 mod 16, K off a
# multiple of 8), a K past the kernel's 512-row activation chunk, K = 0.
PLAN_SHAPES = [(1, 650, 33278), (1, 650, 2600), (2, 650, 33278),
               (8, 650, 2600), (16, 650, 33278), (1, 19, 34), (2, 37, 34),
               (3, 1, 5), (1, 5000, 300), (128, 784, 512), (350, 650, 2600),
               (77, 300, 45), (4, 0, 9)]
MODES_OF = {"f32": ("f32", "bf16"), "bf16": ("f32", "bf16"),
            "int8": ("f32", "bf16", "int8"), "int16": ("f32", "bf16"),
            "packed8": ("f32", "bf16")}


def _check_plan(p, M, K, N, fmt, mode):
    """A plan's K ranges cover K in order, and its geometry is its
    kernel's: the streaming kernel's strips and row groups, or a
    tensor-core kernel's output tiles, with up to 8 K splits."""
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split))
              for s in range(p.splits)]  # the kernels' K ranges
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e > b for b, e in ranges) or K == 0
    assert 1 <= p.splits <= 8
    if p.kernel == "stream":
        cols = 31 * 16 // {"f32": 4, "bf16": 2, "int16": 2}.get(fmt, 1)
        assert p.row_tile == (1 if M <= 1 else 8)
        assert p.k_per_split % 8 == 0
        assert p.grid == (-(-N // cols) * p.splits, -(-M // p.row_tile), 1)
    elif p.kernel == "mma":
        assert p.k_per_split % 8 == 0
        assert p.row_tile == 32
        assert p.grid == (-(-N // 128) * p.splits, -(-M // 32), 1)
    else:  # mma_lp: K splits in whole mma chunks
        assert p.k_per_split % (16 if mode == "bf16" else 32) == 0
        assert p.row_tile == 64
        assert p.grid == (-(-N // 128) * p.splits, -(-M // 64), 1)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_plan_routes_by_m_and_splits_k_in_order(M, K, N, fmt):
    for mode in MODES_OF[fmt]:
        for sms in (132, 114, 16):
            p = tm.plan(M, N, K, fmt, mode, sms)
            assert p.kernel == (
                "stream" if M <= tm.STREAM_MAX_M else
                "mma_lp" if mode in ("bf16", "int8") else "mma")
            _check_plan(p, M, K, N, fmt, mode)


@pytest.mark.parametrize("M,K,N", [(1, 650, 33278), (1, 650, 2600),
                                   (128, 784, 512), (350, 650, 2600)])
@pytest.mark.parametrize("kernel", ["stream", "mma"])
def test_plan_takes_a_named_kernel(M, K, N, kernel):
    """A named kernel is taken also where the route gives another (the
    streaming kernel at M = 128 and 350, mma at M = 1), with the geometry
    the route gives that kernel, its K ranges covering K in order; where
    the route gives it, the two plans are one."""
    modes = ("f32", "bf16", "int8") if kernel == "stream" else ("f32",)
    for mode in modes:
        p = tm.plan(M, N, K, "int8", mode, 132, kernel=kernel)
        assert p.kernel == kernel
        _check_plan(p, M, K, N, "int8", mode)
        route = tm.plan(M, N, K, "int8", mode, 132)
        assert (route == p) == (route.kernel == kernel)


@pytest.mark.parametrize("kernel", ["tiled", "wide"])
def test_plan_refuses_unknown_kernels(kernel):
    """plan takes "stream", "mma" and "mma_lp" by name, and nothing else."""
    with pytest.raises(ValueError, match="kernel must be"):
        tm.plan(1, 8, 8, "f32", "f32", 132, kernel=kernel)
    with pytest.raises(ValueError, match="kernel must be"):
        tm.plan(128, 512, 784, "f32", "f32", 132, kernel=kernel)


def test_plan_fills_the_card_at_the_serving_shapes():
    """About two blocks per SM at the decoder shape; the recurrent shape's
    few strips take the largest cluster."""
    for fmt in FORMATS:
        p = tm.plan(1, 33278, 650, fmt, "f32", 132)
        assert p.grid[0] * p.grid[1] >= 2 * 132
    p = tm.plan(1, 2600, 650, "packed8", "f32", 132)
    assert p.splits == 8 and p.k_per_split == 88 and p.grid == (48, 1, 1)


@pytest.mark.parametrize("M,K,N,splits,k_per_split", [
    (128, 784, 512, 8, 104), (128, 512, 512, 8, 64), (128, 512, 10, 8, 64),
    (16, 784, 512, 8, 104), (16, 512, 10, 8, 64), (9, 650, 2600, 6, 112),
    (350, 650, 2600, 1, 656)])
def test_plan_mma_fills_one_wave(M, K, N, splits, k_per_split):
    """The MLP's shapes take 8 K splits (16 tiles of 32 x 128 x 8 = 128
    blocks at 128 x 784 x 512, within one of a 132-SM card's waves);
    tiles that already fill the card take no split."""
    p = tm.plan(M, N, K, "f32", "f32", 132)
    assert (p.kernel, p.splits, p.k_per_split) == ("mma", splits,
                                                   k_per_split)
    tiles = -(-M // 32) * -(-N // 128)
    assert tiles * p.splits <= max(132, tiles)
    for mode, fmt in (("bf16", "f32"), ("bf16", "packed8"), ("int8", "int8")):
        with pytest.raises(ValueError, match="mma kernel takes"):
            tm.plan(M, N, K, fmt, mode, 132, kernel="mma")


@pytest.mark.parametrize("M,K,N,splits,k_per_split", [
    (128, 784, 512, 6, 136), (16, 784, 512, 8, 104), (9, 650, 2600, 5, 136),
    (350, 650, 2600, 1, 656)])
def test_plan_mma_takes_the_largest_cluster_that_fits(M, K, N, splits,
                                                      k_per_split):
    """With the card's cluster occupancy (an H100 runs 15 clusters of 8
    blocks of this kernel at once, 17 of 6, 22 of 5), the 16 tiles of
    128 x 784 x 512 take clusters of 6, not 8 (a second wave)."""
    h100 = (132, 66, 39, 30, 22, 17, 15, 15)
    p = tm.plan(M, N, K, "f32", "f32", 132, clusters=h100)
    assert (p.splits, p.k_per_split) == (splits, k_per_split)
    assert -(-M // 32) * -(-N // 128) <= h100[p.splits - 1] or p.splits == 1


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("M,K,N,splits,k_per_split", [
    (128, 784, 512, 7, {"bf16": 112, "int8": 128}),
    (77, 300, 45, {"bf16": 7, "int8": 5}, {"bf16": 48, "int8": 64}),
    (9, 650, 2600, 6, {"bf16": 112, "int8": 128}),
    (350, 650, 2600, 1, {"bf16": 656, "int8": 672}),
    (8192, 2048, 512, 1, 2048)])
def test_plan_mma_lp_fills_one_wave(M, K, N, splits, k_per_split, mode):
    """The bf16 and int8 modes at M > 8 take the mma_lp kernel in every
    weight format and input, on 64 x 128 tiles; K splits over a cluster
    while the tiles times the splits fit one wave of a 132-SM card (the
    MLP's 8 tiles take 7 splits of whole mma chunks), and tiles that
    fill the card (the LSTM chunk, bench.py's shape) take none."""
    splits = splits[mode] if isinstance(splits, dict) else splits
    kps = k_per_split[mode] if isinstance(k_per_split, dict) else k_per_split
    for fmt in (("int8",) if mode == "int8" else FORMATS):
        p = tm.plan(M, N, K, fmt, mode, 132)
        assert (p.kernel, p.splits, p.k_per_split) == ("mma_lp", splits, kps)
        tiles = -(-M // 64) * -(-N // 128)
        assert tiles * p.splits <= max(132, tiles)
    with pytest.raises(ValueError, match="mma_lp kernel takes"):
        tm.plan(M, N, K, "f32", "f32", 132, kernel="mma_lp")
    # The f32 mode's other weight formats take the mma kernel.
    if mode == "bf16":
        for fmt in FORMATS[1:]:
            assert tm.plan(M, N, K, fmt, "f32", 132).kernel == "mma"


# The f32 mode's shapes on the narrow weight formats: the batch-64 LSTM
# serving step's decoder and recurrent products, a 35-step chunk at batch
# 64, the MLP's first layer; (splits, k_per_split) on a 132-SM card by
# default and with an H100's cluster occupancy.
NARROW_F32_PLANS = [((64, 650, 33278), (1, 656), (1, 656)),
                    ((64, 650, 2600), (3, 224), (2, 328)),
                    ((2240, 650, 2600), (1, 656), (1, 656)),
                    ((128, 784, 512), (8, 104), (6, 136))]


@pytest.mark.parametrize("fmt", FORMATS[1:])
@pytest.mark.parametrize("shape,default,h100", NARROW_F32_PLANS,
                         ids=["x".join(map(str, c[0])) for c in
                              NARROW_F32_PLANS])
def test_plan_narrow_f32_takes_the_mma_kernel(shape, default, h100, fmt):
    """The f32 mode on bf16-stored, int8, int16 and 9-bit weights at M > 8
    takes the mma kernel on float32 weights' tile and K split (so the two
    sum in the same order)."""
    M, K, N = shape
    h100_clusters = (132, 66, 39, 30, 22, 17, 15, 15)
    for clusters, want in ((None, default), (h100_clusters, h100)):
        p = tm.plan(M, N, K, fmt, "f32", 132, clusters=clusters)
        assert p.kernel == "mma" and (p.splits, p.k_per_split) == want
        assert p == tm.plan(M, N, K, "f32", "f32", 132, clusters=clusters)
        assert p.grid == (-(-N // 128) * p.splits, -(-M // 32), 1)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_plan_mma_lp_takes_the_largest_cluster_that_fits(mode):
    """With a card's cluster occupancy (an H100 runs 22 clusters of 5
    blocks of a 512-thread kernel, 17 of 6), the 21 tiles of 9 x 650 x
    2600 take clusters of 5, not 6."""
    h100 = (132, 66, 39, 30, 22, 17, 15, 15)
    p = tm.plan(9, 2600, 650, "int8", mode, 132, clusters=h100)
    assert (p.splits, p.k_per_split) == (5, {"bf16": 144, "int8": 160}[mode])


def _bf16(v: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _mma_lp_emulation(xa, wa, p, mode: str, epi: np.float32) -> np.ndarray:
    """The mma_lp kernel's sum order: each K split of ``p`` on its own
    (bf16: every mma's 16 exact bf16 products added to a float32
    accumulator; int8: an exact integer sum), the splits' partials added
    in rank order (float32; int32, exact), times ``epi``."""
    K = xa.shape[1]
    total = None
    for s in range(p.splits):
        kb, ke = s * p.k_per_split, min(K, (s + 1) * p.k_per_split)
        if mode == "int8":
            part = xa[:, kb:ke].astype(np.int64) @ wa[kb:ke].astype(np.int64)
        else:
            part = np.zeros((xa.shape[0], wa.shape[1]), np.float32)
            for c in range(kb, ke, 16):
                e = min(ke, c + 16)
                part = (part + xa[:, c:e].astype(np.float64)
                        @ wa[c:e].astype(np.float64)).astype(np.float32)
        total = part if total is None else total + part
    return total.astype(np.float32) * np.float32(epi)


@pytest.mark.parametrize("variant,fmt,quantize_x,bits,terms", [
    ("bf16", "f32", True, 8, 3), ("bf16", "f32", False, 8, 3),
    ("bf16", "int16", True, 8, 3), ("int8", "int8", True, 7, 3),
    ("int8", "int8", True, 7, 1)])
@pytest.mark.parametrize("M,K,N", [(128, 784, 512), (16, 512, 10),
                                   (77, 300, 45)])
def test_mma_lp_sum_order_matches_jax(rng, M, K, N, variant, fmt, quantize_x,
                                      bits, terms):
    """The mma_lp kernel's numerics, emulated on its plan's K splits,
    against the JAX package's term_matmul (interpret mode): the int8 mode
    bit for bit (at 7 bits and one term, q >= 96 keeps +128, which the
    JAX kernel's int8 cast saturates to 127), the bf16 mode within
    rtol 1e-5, atol 1e-4 * max|ref| (float32 sums in another order)."""
    mode = variant
    x = rng.normal(size=(M, K)).astype(np.float32)
    jw, tw, w_sf = _weights(rng, fmt, K, N)
    sf = np.float32(0.03)
    kw = dict(bf16=mode == "bf16", int8=mode == "int8",
              quantize_x=quantize_x)
    want = np.asarray(jm.term_matmul(
        jnp.asarray(x), jw, jnp.float32(sf), bits, terms,
        w_sf=None if w_sf is None else jnp.float32(w_sf), bm=64, bk=128,
        bn=128, **kw))
    tw_sf = None if w_sf is None else torch.tensor(w_sf)
    ref = tm.term_matmul_ref(torch.from_numpy(x), tw, torch.tensor(sf), bits,
                             terms, w_sf=tw_sf, **kw).numpy()
    if quantize_x:
        xa = tm.tr_quantize_int_ref(torch.from_numpy(x), torch.tensor(sf),
                                    bits, terms).numpy()
        if mode == "int8":
            xa = np.minimum(xa, 127)
            assert terms > 1 or (xa == 127).any()  # saturated +128s
    else:
        xa = x
    wa = tw.to(torch.float32).numpy()
    epi = np.float32(sf if quantize_x else 1) * np.float32(
        1 if w_sf is None else w_sf)
    p = tm.plan(M, N, K, fmt, mode, 132)
    assert p.kernel == "mma_lp"
    if mode == "bf16":
        got = _mma_lp_emulation(_bf16(xa), _bf16(wa), p, mode, epi)
        _close(torch.from_numpy(got), want)
        _close(torch.from_numpy(ref), want)
    else:
        got = _mma_lp_emulation(xa, wa, p, mode, epi)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref, want)


def _tf32_rna(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round float32 to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(v: np.ndarray):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


@pytest.mark.parametrize("quantize_x", [True, False])
@pytest.mark.parametrize("M,K,N", [(128, 784, 512), (16, 512, 10),
                                   (77, 300, 45)])
def test_3xtf32_plan_within_the_f32_tolerance(rng, M, K, N, quantize_x):
    """The tensor-core kernel's numerics, emulated: each operand split
    into a TF32 high part and a TF32 remainder, ``lo_a @ hi_b + hi_a @ lo_b
    + hi_a @ hi_b`` in float32.  It must stay within the tolerance that
    chip_smoke.py holds the kernel to against the plain version (rtol
    1e-5, atol 1e-4 * max|ref|) of the JAX package's term_matmul, where
    one TF32 product alone does not."""
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    sf = np.float32(0.03)
    want = np.asarray(jm.term_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.float32(sf), 8, 3, bm=64, bk=128,
                                     bn=128, quantize_x=quantize_x))
    xa = (tm.tr_quantize_ref(torch.from_numpy(x), torch.tensor(sf), 8, 1,
                             3).numpy() if quantize_x else x)
    a_hi, a_lo = _split_tf32(xa)
    b_hi, b_lo = _split_tf32(w)
    got = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    assert got.dtype == np.float32
    tol = 1e-5 * np.abs(want) + 1e-4 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(a_hi @ b_hi - want) > tol).any()  # 1xTF32 misses


def _exact_in_tf32(v: np.ndarray) -> np.ndarray:
    """Per value: its TF32 split is (v, 0), as the mma kernel's two-product
    instantiations take it."""
    hi, lo = _split_tf32(v.astype(np.float32))
    return (lo == 0) & (hi == v)


def test_narrow_weights_exact_in_tf32_exhaustive():
    """The premise of the mma kernel's two products: the TF32 remainder
    (cvt.rna.tf32 of v - rna(v)) is 0 for every int8 value, every finite
    bfloat16 bit pattern and every 9-bit-pack magnitude (the kernel's
    lo ^ 0x80, both signs), so the product it leaves out, hi_a * lo_b,
    is exactly 0.  Some int16 values have a remainder: they keep three
    products, and their hi + lo is the value exactly."""
    int8 = np.arange(-128, 128, dtype=np.float32)
    assert _exact_in_tf32(int8).all()
    bits = np.arange(2**16, dtype=np.uint32)
    finite = (bits >> 7) & 0xFF != 0xFF
    bf16 = (bits[finite] << 16).view(np.float32)
    assert bf16.size == 2**16 - 2**8 and _exact_in_tf32(bf16).all()
    lo = np.arange(-128, 128).astype(np.int8).view(np.uint8)
    mag = (lo ^ 0x80).astype(np.float32)  # 0 .. 255
    assert sorted(mag) == list(range(256))
    assert _exact_in_tf32(mag).all() and _exact_in_tf32(-mag).all()
    int16 = np.arange(-2**15, 2**15, dtype=np.float32)
    exact = _exact_in_tf32(int16)
    assert not exact.all() and exact[np.abs(int16) <= 2**11].all()
    hi, lo16 = _split_tf32(int16)
    np.testing.assert_array_equal(hi + lo16, int16)


def _under_2p23(u: np.ndarray, bias: float) -> np.ndarray:
    """mma_common.cuh's w_elem: the unsigned u under the exponent of 2^23,
    less ``bias`` (2^23 plus the format's offset), in float32."""
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    return (f - np.float32(bias)).astype(np.float32)


def test_weight_widening_without_conversions_exhaustive():
    """The kernels widen int8, int16 and the 9-bit pack's bytes without
    int-to-float conversions: every value comes out exact, as q (the
    pack: lo ^ 0x80 = |q|, its sign bit then set)."""
    b = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal(
        _under_2p23(b ^ 0x80, 2**23 + 128),
        b.astype(np.uint8).view(np.int8).astype(np.float32))
    h = np.arange(2**16, dtype=np.uint32)
    np.testing.assert_array_equal(
        _under_2p23(h ^ 0x8000, 2**23 + 2**15),
        h.astype(np.uint16).view(np.int16).astype(np.float32))
    lo = np.arange(-128, 128).astype(np.int8)
    mag = _under_2p23(lo.view(np.uint8).astype(np.uint32) ^ 0x80, 2**23)
    np.testing.assert_array_equal(mag, lo.astype(np.float32) + 128)
    neg = (mag.view(np.uint32) | np.uint32(1 << 31)).view(np.float32)
    np.testing.assert_array_equal(neg, -mag)


@pytest.mark.parametrize("fmt", FORMATS[1:])
@pytest.mark.parametrize("quantize_x", [True, False])
@pytest.mark.parametrize("M,K,N", [(64, 650, 260), (77, 300, 45)])
def test_narrow_mma_products_within_the_f32_tolerance(rng, M, K, N, fmt,
                                                      quantize_x):
    """The mma kernel's numerics on a narrow weight format, emulated: x
    split into TF32 high part and remainder, the weight widened (q of
    integer and packed weights, w_sf after the sum); two products
    ``lo_a @ w + hi_a @ w`` where w is exact in TF32, three for int16.
    Within chip_smoke.py's tolerance of the JAX package's term_matmul."""
    x = rng.normal(size=(M, K)).astype(np.float32)
    jw, tw, w_sf = _weights(rng, fmt, K, N)
    sf = np.float32(0.03)
    want = np.asarray(jm.term_matmul(
        jnp.asarray(x), jw, jnp.float32(sf), 8, 3,
        w_sf=None if w_sf is None else jnp.float32(w_sf), bm=64, bk=128,
        bn=128, quantize_x=quantize_x))
    xa = (tm.tr_quantize_ref(torch.from_numpy(x), torch.tensor(sf), 8, 1,
                             3).numpy() if quantize_x else x)
    wa = (tm._decode_u8s(tw)[:K] if fmt == "packed8" else tw).to(
        torch.float32).numpy()
    a_hi, a_lo = _split_tf32(xa)
    b_hi, b_lo = _split_tf32(wa)
    if fmt == "int16":
        got = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    else:
        assert not b_lo.any()
        got = a_lo @ b_hi + a_hi @ b_hi
    scale = (w_sf if w_sf is not None else
             float(tw.w_sf) if fmt == "packed8" else 1.0)
    got = (got * np.float32(scale)).astype(np.float32)
    tol = 1e-5 * np.abs(want) + 1e-4 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()


def _fma32(a, b, c):
    """float32 fma(a, b, c): the float64 product of two float32 values is
    exact, and the residuals here are small, so one rounding to float32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("sf", [0.2, 0.03, 0.0371, 1e-3, 0.4152418375,
                                37.5, 3e-7, 1.7e5])
def test_quantize_division_by_reciprocal_matches_ieee(sf):
    """The kernels' |x| / sf (tr_common.cuh::quantize_rcp, in the mma and
    the element-wise kernels): y = |x| * rn(1/sf), then two corrections
    y += r * (|x| - sf * y), equals the correctly rounded float32 division
    (__fdiv_rn) on random quotients, at every rounding boundary
    (q + 0.5) * sf and its float32 neighbours for q < 2^16, and at 200,000
    sampled ones for q in [2^16, 2^24) (the element-wise kernel takes bits
    up to 24)."""
    rng = np.random.default_rng(7)
    b = np.float32(sf)
    r = np.float32(1.0 / np.float64(b))
    q = np.concatenate([np.arange(2**16, dtype=np.float64),
                        rng.integers(2**16, 2**24, 200_000)])
    half = ((q + 0.5) * b).astype(np.float32)
    a = np.concatenate([
        np.exp(rng.uniform(np.log(2.0**-40), np.log(2.0**40), 200_000)),
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(0)), [0.0]]).astype(np.float32)
    bb = np.full_like(a, b)
    rr = np.full_like(a, r)
    y = (a.astype(np.float64) * np.float64(r)).astype(np.float32)
    for _ in range(2):
        y = _fma32(rr, _fma32(-bb, y, a), y)
    np.testing.assert_array_equal(y, a / bb)


def test_variant_names():
    w = torch.zeros(8, 3)
    assert tm.variant(w=w) == "f32"
    assert tm.variant(w=w.to(torch.int16), quantize_x=False) == \
        "f32_raw_int16"
    packed = tm.pack_weight_u8s(w, torch.tensor(1.0), 8)
    assert tm.variant(bf16=True, w=packed) == "bf16_packed8"
    assert tm.variant(w=packed, quantize_x=False) == "f32_raw_packed8"
    assert tm.variant(int8=True, w=w.to(torch.int8)) == "int8_int8"


def _bad_cases():
    z8 = np.zeros((8, 3), np.int8)
    return [
        ("carries its own w_sf", "packed", dict(w_sf=1.0)),
        ("int8 mode is for <= 7-bit grids", "packed", dict(int8=True)),
        ("do not cover x K", "packed16", {}),
        ("integer weights must be int8 or int16", z8.astype(np.int32), {}),
        ("integer weights require w_sf", z8, {}),
        ("w_sf is only meaningful", z8.astype(np.float32), dict(w_sf=1.0)),
        ("mutually exclusive", z8, dict(w_sf=1.0, int8=True, bf16=True)),
        ("int8 mode requires int8-packed", z8.astype(np.int16),
         dict(w_sf=1.0, int8=True)),
        ("int8 mode needs bits <= 7", z8, dict(w_sf=1.0, int8=True)),
        ("int8 mode requires quantized activations", z8,
         dict(w_sf=1.0, int8=True, quantize_x=False, bits=6)),
    ]


@pytest.mark.parametrize("match,w,kw", _bad_cases(),
                         ids=[c[0] for c in _bad_cases()])
def test_refuses_what_jax_refuses(match, w, kw):
    """The same ValueError, with the same message, on both sides."""
    kw = dict(kw)
    bits = kw.pop("bits", 8)
    x = np.zeros((4, 8), np.float32)
    if isinstance(w, str):
        wq = np.zeros((16 if w == "packed16" else 8, 3), np.float32)
        jw = jm.pack_weight_u8s(jnp.asarray(wq), jnp.float32(1.0), 8)
        tw = params_from_jax(jax.device_get(jw), "cpu")
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jkw = {k: (jnp.float32(v) if k == "w_sf" else v) for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if k == "w_sf" else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        jm.term_matmul(jnp.asarray(x), jw, jnp.float32(0.1), bits, 2, **jkw)
    with pytest.raises(ValueError, match=match):
        tm.term_matmul(torch.from_numpy(x), tw, 0.1, bits, 2, **tkw)


def test_rejects_bad_arguments():
    with pytest.raises(ValueError, match="w_sf"):
        tm.term_matmul(torch.zeros(4, 8), torch.zeros(8, 3), 0.1, 6, 2,
                       w_sf=torch.tensor(1.0))
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        tm.term_matmul(torch.zeros(4, 8), torch.zeros(7, 3), 0.1, 6, 2)
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        tm.term_matmul(torch.zeros(2, 4, 8), torch.zeros(8, 3), 0.1, 6, 2)


@pytest.mark.parametrize("K", [1, 7, 8, 13, 64])
def test_pack_u8s_byte_for_byte_and_round_trip(rng, K):
    N = 11
    w_sf = np.float32(0.037)
    q = rng.integers(-255, 256, size=(K, N)).astype(np.float32)
    q[0, :4] = [0, 255, -255, -128]
    wq = (q * w_sf).astype(np.float32)
    jw = jm.pack_weight_u8s(jnp.asarray(wq), jnp.float32(w_sf), 8)
    tw = tm.pack_weight_u8s(torch.from_numpy(wq), torch.tensor(w_sf), 8)
    assert tw.lo.dtype == tw.signs.dtype == torch.int8
    assert tw.lo.shape == (-(-K // 8) * 8, N)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        tm.unpack_weight_u8s(tw, k=K).numpy(),
        np.asarray(jm.unpack_weight_u8s(jw, k=K)))
    np.testing.assert_array_equal(tm.unpack_weight_u8s(tw, k=K).numpy(),
                                  (q * w_sf).astype(np.float32))


@pytest.mark.parametrize("bits", [4, 7, 8, 12])
def test_pack_int_byte_for_byte(rng, bits):
    w_sf = np.float32(0.021)
    hi = 2 ** (bits - 1)
    wq = (rng.integers(-hi, hi + 1, size=(9, 6)) * w_sf).astype(np.float32)
    jq, jsf = jm.pack_weight_int(jnp.asarray(wq), jnp.float32(w_sf), bits)
    tq, tsf = tm.pack_weight_int(torch.from_numpy(wq), torch.tensor(w_sf),
                                 bits)
    assert tq.dtype == (torch.int8 if bits <= 7 else torch.int16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(tsf) == float(jsf)


def test_pack_zero_scale_packs_zeros():
    w = torch.zeros(5, 3)
    q, sf = tm.pack_weight_int(w, torch.tensor(0.0), 8)
    assert float(sf) == 1.0 and not q.any()
    wp = tm.pack_weight_u8s(w, torch.tensor(0.0), 8)
    assert float(wp.w_sf) == 1.0
    assert (wp.lo == -128).all() and not wp.signs.any()


@pytest.mark.parametrize("pack,bits,scale", [
    ("u8s", 8, 300), ("int", 7, 200), ("int", 9, 40000)])
def test_overflow_raises_like_jax_now_and_deferred(pack, bits, scale):
    w = np.full((8, 2), np.float32(scale))
    jpack = jm.pack_weight_u8s if pack == "u8s" else jm.pack_weight_int
    tpack = tm.pack_weight_u8s if pack == "u8s" else tm.pack_weight_int
    with pytest.raises(ValueError) as jerr:
        jpack(jnp.asarray(w), jnp.float32(1.0), bits)
    with pytest.raises(ValueError) as terr:
        tpack(torch.from_numpy(w), torch.tensor(1.0), bits)
    assert str(terr.value) == str(jerr.value)
    checks = []
    tpack(torch.from_numpy(w), torch.tensor(1.0), bits, checks=checks)
    tpack(torch.zeros(8, 2), torch.tensor(1.0), bits, checks=checks)
    assert len(checks) == 2
    with pytest.raises(ValueError) as derr:
        tm.flush_pack_checks(checks)
    assert str(derr.value) == str(jerr.value)


def test_flush_pack_checks_passes_and_clears():
    checks = []
    tm.pack_weight_u8s(torch.ones(8, 2), torch.tensor(0.5), 8, checks=checks)
    tm.pack_weight_int(torch.ones(8, 2), torch.tensor(0.5), 7, checks=checks)
    tm.flush_pack_checks(checks)
    assert checks == []
    with pytest.raises(ValueError, match="bits <= 8"):
        tm.pack_weight_u8s(torch.ones(8, 2), torch.tensor(0.5), 9)
