"""The grouped TR expert product (``kernels/term_matmul_grouped.py``) and
the expert layer's grouped path (``layers/moe.py``) on the CPU.

The plain version is held against a loop of ``term_matmul_ref`` over the
experts' slices cut on the host (bit for bit: the same products on the
same rows) and against a float64 product of the decoded weights; the
grouped path of ``moe_apply`` against its per-expert path on the same
inputs (within 1e-6: both run the plain products on the same slices, but
the grouped path sums a row's pairs over its slots, the per-expert path
with ``index_add_`` in the sorted order), and the counter's lazy fold.
The kernel
itself runs on the card only (``tests/test_torch_port_cuda.py``).
"""

import types

import pytest
import torch

from test_torch_port_deepseek_v3 import SETTING, TINY, _model, _tokens
from tq_tpu_torch.kernels import term_matmul as tm
from tq_tpu_torch.kernels import term_matmul_grouped as tg
from tq_tpu_torch.layers import moe
from tq_tpu_torch.models import deepseek_v3 as dsv3


def _packs(gen, E: int, K: int, N: int, products: int = 1):
    """Each product's E experts: random 8-bit grids packed (K, N)."""
    out = []
    for _ in range(products):
        ps = []
        for _ in range(E):
            sf = float(torch.rand((), generator=gen)) * 0.01 + 0.001
            q = torch.randint(-255, 256, (K, N), generator=gen)
            ps.append(tm.pack_weight_u8s(q.to(torch.float32) * sf,
                                         torch.tensor(sf), 8))
        out.append(ps)
    return out


# (loads of each expert, K, N, held experts or None): an expert with no
# rows, one with one row, one with more than 8 (several tiles), K not a
# multiple of 8, and a held subset.
CASES = {
    "empty_one_and_many": ([0, 1, 11, 3, 0], 24, 48, None),
    "k_not_a_multiple_of_8": ([2, 0, 9, 1], 13, 16, None),
    "seventeen_rows_one_expert": ([17], 16, 32, None),
    "held_subset": ([4, 0, 10, 1, 6], 21, 16, [0, 2, 4]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_a_loop_of_term_matmul_ref(case):
    loads, K, N, held = CASES[case]
    gen = torch.Generator().manual_seed(len(loads) * 131 + K)
    E, P = len(loads), sum(loads)
    products = _packs(gen, E, K, N, products=2)
    gw = tg.group_weights(products, K)
    x = torch.randn(P, K, generator=gen)
    ends = torch.cumsum(torch.tensor(loads), 0)
    got = tg.term_matmul_grouped(x, ends, gw, held)
    assert got.shape == (2, P, N) and got.dtype == torch.float32
    start = 0
    for e, n in enumerate(loads):
        rows = slice(start, start + n)
        for g, ps in enumerate(products):
            if held is not None and e not in held:
                assert not got[g, rows].any()
                continue
            want = tm.term_matmul_ref(x[rows], ps[e], 1.0, quantize_x=False)
            assert torch.equal(got[g, rows], want), (e, g)
            w64 = tm.unpack_weight_u8s(ps[e], k=K).to(torch.float64)
            torch.testing.assert_close(
                got[g, rows].to(torch.float64), x[rows].double() @ w64,
                rtol=1e-5, atol=1e-5 * float(w64.abs().max()) * K)
        start += n


def test_plain_version_gathers_scales_and_scatters():
    """An expert layer's two calls: gate and up on rows gathered by the
    sort (pair j of row j // top_k), down written back in the pairs'
    order times their weights."""
    gen = torch.Generator().manual_seed(5)
    loads, K, N, top_k = [3, 0, 5, 4], 16, 32, 3
    E, P = len(loads), sum(loads)
    gate_up = tg.group_weights(_packs(gen, E, K, N, products=2), K)
    down = tg.group_weights(_packs(gen, E, N, K), N)
    x = torch.randn(P // top_k, K, generator=gen)
    order = torch.randperm(P, generator=gen)
    weight = torch.rand(P, generator=gen)
    ends = torch.cumsum(torch.tensor(loads), 0)
    h = tg.term_matmul_grouped(x, ends, gate_up, gather=order, top_k=top_k)
    xs = x[order // top_k]
    assert torch.equal(h, tg.term_matmul_grouped(xs, ends, gate_up))
    g = torch.nn.functional.silu(h[0]) * h[1]
    out = tg.term_matmul_grouped(g, ends, down, scatter=order, scale=weight)
    want = tg.term_matmul_grouped(g, ends, down)[0] * weight[order][:, None]
    assert torch.equal(out[0, order], want)


@pytest.mark.parametrize("fault", ["n_not_a_multiple_of_16", "k_too_short",
                                   "float_weights", "unequal_products",
                                   "too_many_experts", "not_contiguous",
                                   "not_16_byte_aligned"])
def test_group_weights_refuses_what_the_kernel_does_not_take(fault):
    gen = torch.Generator().manual_seed(1)
    K, N = 16, 16
    if fault == "n_not_a_multiple_of_16":
        products, N = _packs(gen, 2, K, 20), 20
    elif fault == "k_too_short":
        products, K = _packs(gen, 2, K, N), 24
    elif fault == "float_weights":
        products = [[torch.zeros(K, N)] * 2]
    elif fault == "unequal_products":
        products = _packs(gen, 2, K, N) + _packs(gen, 3, K, N)
    elif fault == "too_many_experts":
        products = [_packs(gen, 1, K, N)[0] * (tg.MAX_EXPERTS + 1)]
    elif fault == "not_contiguous":
        p = _packs(gen, 1, K, 2 * N)[0][0]
        products = [[tm.PackedWeight8(p.lo[:, ::2], p.signs[:, ::2],
                                      p.w_sf)]]
    else:  # contiguous planes 4 bytes past a 16-byte boundary
        p = _packs(gen, 1, K, N)[0][0]
        lo = torch.empty(p.lo.numel() + 16, dtype=torch.int8)
        off = (-lo.data_ptr()) % 16 + 4
        lo = lo[off:off + p.lo.numel()].view(p.lo.shape)
        lo.copy_(p.lo)
        products = [[tm.PackedWeight8(lo, p.signs, p.w_sf)]]
    assert tg.layout_error(products, K) is not None
    with pytest.raises(ValueError, match="term_matmul_grouped"):
        tg.group_weights(products, K)


def test_max_tiles_holds_every_split_of_the_pairs():
    gen = torch.Generator().manual_seed(2)
    for E in (1, 3, 8, 64, 256):
        for P in (1, 5, 64, 384, 1000):
            for _ in range(20):
                # A skewed split: most pairs on a few experts.
                w = torch.rand(E, generator=gen) ** 4
                idx = torch.multinomial(w, P, replacement=True,
                                        generator=gen)
                loads = torch.bincount(idx, minlength=E)
                tiles = int(((loads + tg.TILE - 1) // tg.TILE).sum())
                assert tiles <= tg.max_tiles(P, E) <= -(-P // 8) + E


def test_plan_splits_k_only_where_the_blocks_leave_the_card_short():
    # A decode step at batch 64 (384 pairs, 64 experts): gate and up in
    # one launch, 11 strips of 128 columns, unsplit; down 16 strips.
    p = tg.plan(384, 64, 1408, 2048, 2, 132)
    assert p.grid == (11, 104, 2) and p.splits == 1
    assert p.k_per_split == 2048
    p = tg.plan(384, 64, 2048, 1408, 1, 132)
    assert p.grid == (16, 104, 1) and p.splits == 1
    # Batch 1 (6 pairs): 6 tiles, K split over clusters to fill the card.
    p = tg.plan(6, 64, 1408, 2048, 2, 132)
    assert 1 < p.splits <= 8 and p.grid == (11 * p.splits, 6, 2)
    assert p.k_per_split % 8 == 0
    assert (p.splits - 1) * p.k_per_split < 2048 <= p.splits * p.k_per_split
    assert 11 * 6 * 2 * p.splits <= 132 * 4


def test_a_cpu_call_runs_the_plain_version_and_counts_no_launch():
    gen = torch.Generator().manual_seed(3)
    gw = tg.group_weights(_packs(gen, 3, 8, 16), 8)
    before = dict(tm.term_matmul.kernel_launches)
    out = tg.term_matmul_grouped(torch.randn(5, 8, generator=gen),
                                 torch.tensor([2, 2, 5]), gw)
    assert out.shape == (1, 5, 16)
    assert tm.term_matmul.kernel_launches == before
    assert before["grouped"] == 0


def _layer(seed=7):
    params = _model(seed=seed)
    qp, qcfg, qstate = dsv3.convert(params, TINY, SETTING, pack_fmt="u8s")
    ctx = dsv3.Context(qcfg, qstate)
    pre = "layers.1.mlp"

    def expert(e, rows):
        return dsv3._swiglu(ctx, qp, f"{pre}.experts.{e}", rows)

    return qp, pre, expert


@pytest.mark.parametrize("held", [None, [5, 0, 3, 1], [7, 2, 6, 4]],
                         ids=["every", "first_share", "second_share"])
def test_grouped_path_equals_the_per_expert_path(monkeypatch, held):
    qp, pre, expert = _layer()
    # Expert 2 is never selected; the rest take 1 to ~20 rows.
    qp[f"{pre}.gate"]["bias"][2] = -10.0
    x = torch.randn(24, 64, generator=torch.Generator().manual_seed(8))
    args = (x, qp[f"{pre}.gate"], expert, 3, 2.446)
    want, want_idx = moe.moe_apply(*args, held=held, layer="per_expert")
    monkeypatch.setattr(moe, "takes_grouped", lambda x, top_k: True)
    got, idx = moe.moe_apply(*args, held=held, layer="grouped",
                             grouped=qp[f"{pre}.experts"])
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    loads = torch.bincount(idx.reshape(-1), minlength=8)
    assert int(loads.max()) > tg.TILE  # an expert of several tiles


def test_grouped_calls_are_counted_as_the_per_expert_path_counts_them(
        monkeypatch):
    params = _model()
    qp, qcfg, qstate = dsv3.convert(params, TINY, SETTING, pack_fmt="u8s")
    B, T, steps = 3, 5, 2
    tokens = _tokens(B, T + steps)

    def serve():
        moe.moe_apply.counts.clear()
        cache = dsv3.init_cache(TINY, B, T + steps)
        out = [dsv3.prefill(qp, TINY, tokens[:, :T], cache, qcfg, qstate)]
        for pos in range(T, T + steps):
            out.append(dsv3.decode_step(qp, TINY, tokens[:, pos], pos, cache,
                                        qcfg, qstate))
        return torch.stack(out), {k: dict(v)
                                  for k, v in moe.moe_apply.counts.items()}

    want, want_counts = serve()
    # Decode-sized calls (3 rows x 3 slots) take the grouped path, the
    # prefill (15 rows) does not.
    monkeypatch.setattr(moe, "takes_grouped",
                        lambda x, top_k: x.shape[0] * top_k <= 9)
    got, counts = serve()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert set(counts) == set(want_counts) == {"layers.1.mlp", "layers.2.mlp"}
    for layer, c in counts.items():
        w = want_counts[layer]
        assert w["grouped"] == 0 and c["grouped"] == steps
        assert {k: v for k, v in c.items() if k != "grouped"} == {
            k: v for k, v in w.items() if k != "grouped"}
        assert c["calls"] == 1 + steps and c["tokens"] == (B * T + B * steps) * 3


@pytest.mark.parametrize("held", [None, [5, 0, 3, 1]],
                         ids=["every", "share"])
def test_n_grouped_calls_count_what_the_per_expert_path_counts(monkeypatch,
                                                               held):
    """Five calls of one layer on 1 to 24 rows: the grouped path's counts,
    kept on the device in a histogram a row count and folded on the read,
    equal the per-expert path's host counts, ``grouped`` aside."""
    qp, pre, expert = _layer()
    gen = torch.Generator().manual_seed(9)
    xs = [torch.randn(n, 64, generator=gen) for n in (24, 1, 24, 7, 13)]

    def counts(grouped):
        moe.moe_apply.counts.clear()
        for x in xs:
            moe.moe_apply(x, qp[f"{pre}.gate"], expert, 3, 2.446, held=held,
                          layer=pre, grouped=grouped)
        return dict(moe.moe_apply.counts[pre])

    want = counts(None)
    monkeypatch.setattr(moe, "takes_grouped", lambda x, top_k: True)
    got = counts(qp[f"{pre}.experts"])
    assert want["grouped"] == 0 and got["grouped"] == want["calls"] == 5
    assert {k: v for k, v in got.items() if k != "grouped"} == {
        k: v for k, v in want.items() if k != "grouped"}
    assert got["mma"] > 0 and got["stream"] > 0


@pytest.mark.parametrize("rows,on_card,grouped", [
    (64, True, True),      # the MoE cell's decode step: 384 pairs
    (4096, True, True),    # 24,576 pairs, the largest
    (4097, True, False),
    (8192, True, False),   # a prefill chunk of the MoE cell
    (64, False, False),    # rows on the CPU
])
def test_decode_sized_calls_on_the_card_take_the_grouped_path(rows, on_card,
                                                              grouped):
    x = types.SimpleNamespace(is_cuda=on_card, shape=(rows, 2048))
    assert moe.takes_grouped(x, 6) is grouped


@pytest.mark.parametrize("read", ["getitem", "get", "values", "items",
                                  "keys", "iter", "len", "contains"])
def test_pending_counts_are_folded_when_read(read):
    """A grouped call's counts wait on the device, in its layer's
    histogram of loads, until a read folds them in; ``clear()`` zeroes
    the histograms in place."""
    counts = moe.Counts()
    counts.add("a", [3, 0, 9])
    # Each call's experts' end rows: loads (0, 2, 5) on 5 rows, then
    # (1, 4, 4) of which experts 1 and 2 are held, on 4 rows.
    counts.count("a", torch.tensor([0, 2, 7]), None, 5)
    counts.count("b", torch.tensor([1, 5, 9]), [1, 2], 4)
    assert dict.__getitem__(counts, "a")["calls"] == 1  # nothing folded
    assert not dict.__contains__(counts, "b")
    hists = dict(counts._hists)
    assert [h.shape[0] for h in hists.values()] == [6, 5]
    seen = {"getitem": lambda: counts["b"], "get": lambda: counts.get("b"),
            "values": lambda: list(counts.values()),
            "items": lambda: dict(counts.items()),
            "keys": lambda: list(counts.keys()), "iter": lambda: list(counts),
            "len": lambda: len(counts), "contains": lambda: "b" in counts}
    seen[read]()
    assert not any(h.any() for h in hists.values())
    assert dict.__getitem__(counts, "a") == {
        "calls": 2, "tokens": 19, "max_load": 9, "stream": 3, "mma": 1,
        "grouped": 1}
    assert dict.__getitem__(counts, "b") == {
        "calls": 1, "tokens": 8, "max_load": 4, "stream": 2, "mma": 0,
        "grouped": 1}
    seen[read]()  # a second read folds nothing more
    assert dict.__getitem__(counts, "b")["calls"] == 1
    counts.count("c", torch.tensor([1]), None, 1)
    counts.clear()
    assert len(counts) == 0 and counts._hists.keys() == hists.keys() | {
        ("c", 1, 1, torch.device("cpu"))}
    assert all(h is counts._hists[k] for k, h in hists.items())


# ------------------------------------------------- an expert-parallel share


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_table_of_every_id_with_the_held_packs_alone(device):
    """An expert-parallel rank's table: the router's 256 ids, packs for
    its 64 experts (ids 64-127) alone.  The grouped product (the kernel
    on the card, the plain version on the CPU) gives each held expert's
    rows what ``term_matmul_ref`` gives them one expert at a time, zeros
    elsewhere; without ``held``, or with a ``held`` that names an expert
    without a pack, it refuses."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(41)
    E, K, N, held = 256, 40, 32, range(64, 128)
    packs = _packs(gen, len(held), K, N, products=2)
    products = [[None] * E for _ in packs]
    for ps, out in zip(packs, products):
        for e, p in zip(held, ps):
            out[e] = tm.PackedWeight8(*(t.to(device) for t in p))
    gw = tg.group_weights(products, K)
    assert gw.stored == tuple(held) and not gw.ptrs[:, :64].any()
    # 2,048 pairs (256 rows x 8 slots) over all 256 ids.
    loads = torch.bincount(torch.randint(0, E, (2048,), generator=gen),
                           minlength=E)
    x = torch.randn(2048, K, generator=gen)
    ends = torch.cumsum(loads, 0)
    got = tg.term_matmul_grouped(x.to(device), ends.to(device), gw,
                                 held).cpu()
    starts = (ends - loads).tolist()
    for e in range(E):
        rows = slice(starts[e], int(ends[e]))
        for g in range(2):
            if e not in held:
                assert not got[g, rows].any()
                continue
            want = tm.term_matmul_ref(x[rows], packs[g][e - 64], 1.0,
                                      quantize_x=False)
            torch.testing.assert_close(got[g, rows], want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    with pytest.raises(ValueError, match="held"):
        tg.term_matmul_grouped(x.to(device), ends.to(device), gw)
    for wrong in ([63, 64], [64, 256]):  # no pack; past the router's ids
        with pytest.raises(ValueError, match="no pack"):
            tg.term_matmul_grouped(x.to(device), ends.to(device), gw, wrong)


def test_a_held_share_of_256_router_ids_takes_the_grouped_path(monkeypatch):
    """A Kimi-Linear expert layer on rank 1 of 4 (experts 64-127 of a
    256-way router, top 8): its grouped table covers every id and its
    grouped path gives what the per-expert path gives."""
    from test_torch_port_kimi_linear import TINY as KIMI
    from tq_tpu_torch.models import kimi_linear as kimi

    cfg = {**KIMI, "num_hidden_layers": 2, "router_experts": 256,
           "num_experts": 64, "ep_rank": 1, "num_experts_per_token": 8,
           "linear_attn_config": {**KIMI["linear_attn_config"],
                                  "kda_layers": [1], "full_attn_layers": [2]}}
    qp, qcfg, qstate = kimi.convert(kimi.init(
        cfg, torch.Generator().manual_seed(12)), cfg, SETTING,
        pack_fmt="u8s")
    table = qp["layers.1.mlp.experts"]
    assert table.gate_up.ptrs.shape == (2, 256, 2)
    assert table.gate_up.stored == table.down.stored == tuple(range(64, 128))
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(13))
    scfg = kimi.shared_cfg(cfg)
    ctx = kimi.Context(qcfg, qstate)
    want = dsv3._ffn(qp, scfg, 1, x, ctx, slice(None), (32,))
    monkeypatch.setattr(moe, "takes_grouped", lambda x, top_k: True)
    moe.moe_apply.counts.clear()
    got = dsv3._ffn(qp, scfg, 1, x, ctx, slice(None), (32,))
    assert moe.moe_apply.counts["layers.1.mlp"]["grouped"] == 1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
