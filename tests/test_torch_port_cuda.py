"""The port's kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  They import
neither JAX nor the JAX package, so they run where only the port is
installed; the repo's conftest imports JAX, so on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from tq_tpu_torch.kernels import histogram as hist
from tq_tpu_torch.kernels import term_matmul as tm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(9, 650, 2600), (77, 300, 45),
                                   (128, 784, 512), (350, 650, 2600),
                                   (8192, 2048, 512)])
@pytest.mark.parametrize("bf16_bits,int8_terms", [((8, 3), 3), ((12, 5), 1)],
                         ids=["table", "computed"])
def test_mma_lp_kernel_on_the_card(cuda, M, K, N, bf16_bits, int8_terms):
    """Every bf16 variant and int8_int8 at M > 8 launches the mma_lp
    kernel and holds against the plain version: int8 bit for bit, bf16
    within rtol 1e-5, atol 1e-4 * max|ref|.  The kept values come from the
    kernel's table at up to 8 bits and are computed above (bf16 at 12
    bits); int8 with one term saturates +128 at 127."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(cuda)
    sf = torch.tensor(0.03, device=cuda)
    for variant, (mode, fmt, quantize_x) in tm.VARIANTS.items():
        if mode == "f32":
            continue
        q = torch.randint(-127, 128, (K, N), generator=gen)
        w_sf = torch.tensor(0.0123, device=cuda)
        if fmt in ("f32", "bf16"):
            w, w_sf = (q.to(torch.float32) * 0.001).to(
                getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[fmt])), None
        elif fmt == "packed8":
            w, w_sf = tm.pack_weight_u8s(q.to(torch.float32) * 0.0123,
                                         torch.tensor(0.0123), 8), None
        else:
            w = q.to(getattr(torch, fmt))
        w = (tm.PackedWeight8(*(t.to(cuda) for t in w)) if fmt == "packed8"
             else w.to(cuda))
        bits, terms = (7, int8_terms) if mode == "int8" else bf16_bits
        kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
                  quantize_x=quantize_x)
        before = tm.term_matmul.kernel_launches["mma_lp"]
        out = tm.term_matmul(x, w, sf, bits, terms, **kw)
        ref = tm.term_matmul_ref(x, w, sf, bits, terms, **kw)
        torch.cuda.synchronize()
        assert tm.term_matmul.kernel_launches["mma_lp"] == before + 1
        if mode == "int8":
            assert torch.equal(out, ref), variant
        else:
            torch.testing.assert_close(
                out, ref, rtol=1e-5, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(9, 650, 2600), (64, 650, 2600),
                                   (64, 650, 33278), (77, 300, 45)])
def test_mma_narrow_weights_on_the_card(cuda, M, K, N):
    """The f32 mode on int8, int16 (past TF32's 11 bits), bf16-stored and
    9-bit packed weights at M > 8, quantized and raw input, launches the
    mma kernel, holds against the plain version within rtol 1e-5, atol
    1e-4 * max|ref|, and equals the mma kernel on the same weights
    widened to float32, times w_sf, bit for bit where the two take one
    plan (tile and K split)."""
    index = cuda.index or 0

    def plan(fmt):
        return tm.plan(M, N, K, fmt, "f32", tm._sm_count(index), "mma",
                       tm._mma_clusters(index, "mma", "f32", fmt))

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(cuda)
    sf = torch.tensor(0.03, device=cuda)
    for variant, (mode, fmt, quantize_x) in tm.VARIANTS.items():
        if mode != "f32" or fmt == "f32":
            continue
        hi = {"int16": 20000, "packed8": 255}.get(fmt, 127)
        q = torch.randint(-hi, hi + 1, (K, N), generator=gen)
        w_sf = torch.tensor(0.0123)
        if fmt == "bf16":
            w, w_sf = (q.to(torch.float32) * 0.001).to(torch.bfloat16), None
            wide, scale = w.to(torch.float32), None
        elif fmt == "packed8":
            w = tm.pack_weight_u8s(q.to(torch.float32) * w_sf, w_sf, 8)
            w, w_sf, wide, scale = w, None, q.to(torch.float32), w.w_sf
        else:
            w, wide, scale = q.to(getattr(torch, fmt)), q.to(torch.float32), \
                w_sf
        w = (tm.PackedWeight8(*(t.to(cuda) for t in w)) if fmt == "packed8"
             else w.to(cuda))
        w_sf = None if w_sf is None else w_sf.to(cuda)
        kw = dict(w_sf=w_sf, quantize_x=quantize_x)
        before = tm.term_matmul.kernel_launches["mma"]
        out = tm.term_matmul(x, w, sf, 8, 3, **kw)
        ref = tm.term_matmul_ref(x, w, sf, 8, 3, **kw)
        widened = tm.launch(x, wide.to(cuda), sf, 8, 3,
                            quantize_x=quantize_x, kernel="mma")
        if scale is not None:
            widened = widened * scale.to(cuda)
        torch.cuda.synchronize()
        assert tm.term_matmul.kernel_launches["mma"] == before + 2, variant
        torch.testing.assert_close(
            out, ref, rtol=1e-5, atol=1e-4 * float(ref.abs().max()))
        if plan(fmt) == plan("f32"):
            assert torch.equal(out, widened), variant


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bits,group_size,terms",
                         [((784, 512), 1, 1, 1), ((784, 512), 4, 8, 6),
                          ((64, 784), 6, 1, 6)])
def test_term_reveal_st_on_the_card(cuda, shape, bits, group_size, terms):
    """The straight-through op's forward launches B1 (g = 1) or B2 once and
    equals the plain version bit for bit; its backward is the upstream
    gradient itself and a zero for sf, and launches nothing."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_quantize_ref
    from tq_tpu_torch.ops.term_reveal import term_reveal_st

    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(shape, generator=gen).to(cuda).requires_grad_(True)
    sf = (x.detach().abs().max() / 2 ** (bits - 1)).requires_grad_(True)
    up = torch.randn(shape, generator=gen).to(cuda)
    key = "elementwise" if group_size == 1 else "grouped"
    before = dict(tr_quantize.launches)
    y = term_reveal_st(x, sf, bits, group_size, terms, 0)
    gx, gsf = torch.autograd.grad(y, (x, sf), up)
    torch.cuda.synchronize()
    assert tr_quantize.launches[key] == before[key] + 1
    assert sum(tr_quantize.launches.values()) == sum(before.values()) + 1
    assert torch.equal(y, tr_quantize_ref(x.detach(), sf.detach(), bits,
                                          group_size, terms, 0))
    assert torch.equal(gx, up) and float(gsf) == 0.0


def _mlp_params(device):
    from tq_tpu_torch.models import mlp

    return mlp.init(torch.Generator().manual_seed(0), device=device)


def _mnist_batch():
    gen = torch.Generator().manual_seed(2)
    return torch.randn(64, 1, 28, 28, generator=gen), torch.randint(
        0, 10, (64,), generator=gen)


def _norm_gap(got, want) -> float:
    """Relative gap in norm.  A ReLU's gradient jumps at its kink, and
    float32 sum order can put a pre-activation within noise of 0 on the
    other side (seen on the card at batch 64), which moves that unit's
    gradient: the fc2 gradient off by 14% of its largest in one column."""
    return float((got.cpu() - want).norm() / want.norm())


@pytest.mark.cuda
def test_mlp_train_step_card_against_cpu(cuda):
    """Two Adadelta steps of the MLP trainer at dropout 0: losses within
    rtol 1e-4 of the CPU's, each weight's change within 5e-2 in norm."""
    from tq_tpu_torch.evals.train_mlp import make_optimizer, train_step

    x, y = _mnist_batch()
    out = {}
    for d in ("cpu", cuda):
        params = _mlp_params(d)
        opt, _ = make_optimizer(params)
        losses = [float(train_step(params, opt, x.to(d), y.to(d),
                                   dropout=False)) for _ in range(2)]
        out[str(d)] = losses, params
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc), rtol=1e-4,
                               atol=0)
    p0 = _mlp_params("cpu")
    for name in pc:
        assert _norm_gap(pg[name]["w"] - p0[name]["w"].cuda(),
                         pc[name]["w"] - p0[name]["w"]) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("setting", [(1, 1, 1, 6, 6), (4, 8, 6, 6, 6)])
def test_qat_step_card_against_cpu(cuda, setting):
    """One train_qat step from the same parameters: it launches B1 (g = 1)
    or B2 for every layer's weights, the loss within rtol 1e-4 of the
    CPU's, the gradients within 5e-2 in norm."""
    from tq_tpu_torch.evals.qat_mlp import qat_step
    from tq_tpu_torch.evals.train_mlp import trainable
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize

    x, y = _mnist_batch()
    key = "elementwise" if setting[1] == 1 else "grouped"
    out = {}
    for d in ("cpu", cuda):
        params = _mlp_params(d)
        opt = torch.optim.Adam(trainable(params), lr=1e-3)
        before = tr_quantize.launches[key]
        loss = float(qat_step(params, opt, x.to(d), y.to(d), *setting))
        if d == cuda:
            assert tr_quantize.launches[key] == before + 3
        out[str(d)] = loss, {n: params[n]["w"].grad.cpu() for n in params}
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for n in gc:
        assert _norm_gap(gg[n], gc[n]) <= 5e-2


@pytest.mark.cuda
def test_lstm_train_step_card_against_cpu(cuda):
    """Two chunks of the LM trainer's LSTM step (vocab 1000, width 64,
    batch 4, bptt 8, lr 20, clip 0.25, dropout 0) with the hidden state
    carried: losses, hidden state and parameters within rtol 1e-4 of the
    CPU's."""
    from tq_tpu_torch.evals.train_lstm import _train_step
    from tq_tpu_torch.models import lstm_lm

    gen = torch.Generator().manual_seed(3)
    stream = torch.randint(0, 1000, (17, 4), generator=gen)
    out = {}
    for d in ("cpu", cuda):
        params = lstm_lm.init(torch.Generator().manual_seed(0), vocab=1000,
                              emsize=64, nhid=64, device=d)
        hidden = lstm_lm.init_hidden(4, nhid=64, device=d)
        losses = []
        for i in (0, 8):
            loss, hidden = _train_step(
                params, stream[i:i + 8].to(d),
                stream[i + 1:i + 9].reshape(-1).to(d), hidden, None, 20.0,
                0.25, 0.0, "LSTM")
            losses.append(float(loss))
        out[str(d)] = losses, hidden, params
    (lc, hc, pc), (lg, hg, pg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc), rtol=1e-4,
                               atol=0)
    for a, b in zip(hg, hc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pg["encoder"]["w"].cpu(), pc["encoder"]["w"],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pg["rnn"][0]["w_hh"].cpu(),
                               pc["rnn"][0]["w_hh"], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,g,k", [(8, 1, 3), (9, 8, 12), (9, 32, 40),
                                      (4, 16, 14), (6, 5, 7)])
def test_tr_quantize_equals_native_oracle_on_the_card(cuda, bits, g, k):
    """B1 (g = 1) and B2 along the rows bit for bit against the native C++
    oracle (``utils/native.py``), with a short last group at g = 5."""
    import numpy as np

    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.utils.native import tr_reveal_native

    x = (np.random.default_rng(5).normal(size=(256, 1024)) * 3).astype(
        np.float32)
    got = tr_quantize(torch.as_tensor(x, device=cuda),
                      torch.tensor(0.04, device=cuda), bits, g, k, axis=-1)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tr_reveal_native(x, 0.04, bits, g, k))


@pytest.mark.cuda
def test_empirical_counts_card_equal_cpu(cuda):
    """The empirical profiler on a converted ResNet-18 at 64 px, batch 2:
    the card's captures counted on the card and on the CPU give the same
    report, and the layer4.1.conv1 pair map sums to its total."""
    from tq_tpu_torch.convert import convert_cnn, static_conv_layer_settings
    from tq_tpu_torch.layers.quantize import act_quantize
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.profilers import empirical

    params = resnet.init(torch.Generator().manual_seed(0), device=cuda)
    specs = resnet.conv_specs(64)
    qp, qc, qs = convert_cnn(resnet, params,
                             static_conv_layer_settings(specs, 9, 8, 12), 9,
                             3, image=64)
    qs = {k: {"sf": torch.tensor(0.05, device=cuda)} for k in qs}
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    captured = empirical.capture_activations(resnet, qp, qs, qc, x.to(cuda))
    card = empirical.captured_cost(captured, qp, qs, qc, specs, 2)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(cpu(v) for v in tree)
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    assert empirical.captured_cost(cpu(captured), cpu(qp), cpu(qs), qc,
                                   specs, 2) == card
    assert len(card) == 19
    xin, stride, padding, _ = captured["layer4.1.conv1"]
    sf, tr = qs["layer4.1.conv1"]["sf"], qc["layer4.1.conv1"]
    xq = act_quantize(xin, sf, tr.data_bits, tr.data_terms)
    w = qp["layer4.1.conv1"]
    pair_map = empirical.conv_term_pair_map(xq, w["w"], sf, w["w_sf"], 9, 9,
                                            stride, padding)
    assert int(pair_map.sum()) == card["layer4.1.conv1"]["pairs"]


@pytest.mark.cuda
def test_portable_lstm_step_on_the_card(cuda):
    """A u8s LSTM step (vocab 1000, width 64, sf 0.05) exported on the CPU
    for ("cpu", "cuda") and loaded on the card: within 1e-6 of the card's
    direct step, the streaming term_matmul kernel and B1 launched inside
    the loaded program; a closure on the card is refused for a portable
    artifact."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.utils.export import (export_lm_step, export_serving,
                                           load_serving)

    params = lstm_lm.init(torch.Generator().manual_seed(0), vocab=1000,
                          emsize=64, nhid=64, device=cuda)
    qp, qc, qs = lstm_lm.convert(params, 8, 8, 24, 8, 8)
    qs = {k: {**v, "sf": torch.tensor(0.05, device=cuda)}
          for k, v in qs.items()}
    qp = lstm_lm.pack(qp, qc, fmt="u8s")
    step = load_serving(export_lm_step(qp, qc, qs,
                                       platforms=("cpu", "cuda")))
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    hd = he = lstm_lm.init_hidden(1, nhid=64, device=cuda)
    for t in (3, 999, 0):
        tok = torch.tensor([[t]], device=cuda)
        logp_d, hd, _ = fwd(qp, qs, tok, hd)
        stream0 = tm.term_matmul.kernel_launches["stream"]
        b1 = tr_quantize.launches["elementwise"]
        logp_e, he = step(tok, he)
        torch.cuda.synchronize()
        assert tm.term_matmul.kernel_launches["stream"] > stream0
        assert tr_quantize.launches["elementwise"] > b1
        assert logp_e.is_cuda
        torch.testing.assert_close(logp_e, logp_d, rtol=0, atol=1e-6)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="traced from CPU tensors"):
        export_serving(lambda x: x * w, (torch.zeros(4),),
                       platforms=("cpu", "cuda"))


def _histogram_input(case, cuda):
    """The case's input on the card; views are taken there, so they keep
    their offset and strides."""
    gen = torch.Generator(device="cpu").manual_seed(21)
    if case == "relu_layer1":
        return torch.relu(torch.randn(64, 56, 56, 64, generator=gen) * 2
                          ).to(cuda)
    if case == "all_zero":
        return torch.zeros(64, 56, 56, 64, device=cuda)
    if case == "edges":
        edges = -50.0 + torch.arange(8193, dtype=torch.float32) * (100 / 8192)
        special = torch.tensor([float("nan"), float("inf"), float("-inf"),
                                -0.0, 50.000004, -50.000004, 1e9])
        return torch.cat([edges, torch.nextafter(edges, edges - 1),
                          special]).to(cuda)
    if case == "odd_offset_view":  # 12 bytes past an aligned address
        return (torch.randn(1_000_011, generator=gen) * 30).to(cuda)[
            3:1_000_006]
    if case == "strided_view":  # 1-D, not contiguous
        return (torch.randn(3_000_017, generator=gen) * 30).to(cuda)[1::3]
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["relu_layer1", "all_zero", "edges",
                                  "odd_offset_view", "strided_view"])
@pytest.mark.parametrize("num_bins", [8192, 1024, 16384])
def test_histogram_kernel_on_the_card(cuda, case, num_bins):
    """The histogram kernel equals its plain version on the card bit for
    bit, one launch a call, at the default bins, SMALL's 1,024 and the
    16,384 that need dynamic shared memory past 48 KB."""
    x = _histogram_input(case, cuda)
    before = hist.histogram.launches["histogram"]
    got = hist.histogram(x, num_bins, -50.0, 50.0)
    want = hist.histogram_ref(x, num_bins, -50.0, 50.0)
    torch.cuda.synchronize()
    assert hist.histogram.launches["histogram"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), hist.histogram_ref(x.cpu(), num_bins,
                                                     -50.0, 50.0))


def _grouped_case(case, cuda):
    """(x, ends, held, GroupedWeights) of a grouped-product case on the
    card: two products' experts, random 8-bit grids packed."""
    from tq_tpu_torch.kernels import term_matmul_grouped as tg

    gen = torch.Generator(device="cpu").manual_seed(31)
    if case == "decode":  # the MoE cell: 64 experts, 384 Zipf-like pairs
        K, N, held = 2048, 1408, None
        w = 1.0 / torch.arange(1, 65, dtype=torch.float32)
        loads = torch.bincount(torch.multinomial(w, 384, True, generator=gen),
                               minlength=64).tolist()
    else:
        loads, K, N, held = {
            "ragged": ([0, 1, 11, 3, 0, 17], 24, 48, None),
            "k_not_a_multiple_of_8": ([2, 0, 9, 1], 13, 16, [0, 2]),
            "few_pairs_k_split": ([1, 2, 0, 3], 1408, 2048, None),
        }[case]
    E = len(loads)
    products = [[tm.pack_weight_u8s(
        torch.randint(-255, 256, (K, N), generator=gen).to(torch.float32)
        * 0.001, torch.tensor(0.001), 8) for _ in range(E)] for _ in range(2)]
    products = [[tm.PackedWeight8(*(t.to(cuda) for t in p)) for p in ps]
                for ps in products]
    x = torch.randn(sum(loads), K, generator=gen).to(cuda)
    ends = torch.cumsum(torch.tensor(loads), 0).to(cuda)
    return x, ends, held, tg.group_weights(products, K)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode", "ragged", "k_not_a_multiple_of_8",
                                  "few_pairs_k_split"])
def test_grouped_kernel_on_the_card(cuda, case):
    """The grouped expert product holds against its plain version on the
    card within rtol 1e-5, atol 1e-5 * max|ref| (float32 FMAs summed in
    another order), one launch a call, in the held experts' rows."""
    from tq_tpu_torch.kernels import term_matmul_grouped as tg

    x, ends, held, gw = _grouped_case(case, cuda)
    before = tm.term_matmul.kernel_launches["grouped"]
    got = tg.term_matmul_grouped(x, ends, gw, held)
    want = tg.term_matmul_grouped_ref(x, ends, gw, held)
    torch.cuda.synchronize()
    assert tm.term_matmul.kernel_launches["grouped"] == before + 1
    if held is not None:
        starts = [0] + ends.tolist()[:-1]
        rows = torch.cat([torch.arange(a, b) for e, (a, b) in enumerate(
            zip(starts, ends.tolist())) if e in held])
        got, want = got[:, rows.to(cuda)], want[:, rows.to(cuda)]
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("held", [False, True], ids=["every", "held"])
def test_grouped_layer_launches_on_the_card(cuda, held):
    """An expert layer's two launches at the MoE cell's decode shapes
    (gate and up on rows gathered by a sort, down scattered back times
    the weights) hold against the plain version within rtol 1e-5, atol
    1e-5 * max|ref|."""
    from tq_tpu_torch.kernels import term_matmul_grouped as tg

    x, ends, _, gate_up = _grouped_case("decode", cuda)
    gen = torch.Generator(device="cpu").manual_seed(32)
    P, K, N = x.shape[0], 2048, 1408
    down = tg.group_weights([[tm.PackedWeight8(*(t.to(cuda) for t in
                                                 tm.pack_weight_u8s(
        torch.randint(-255, 256, (N, K), generator=gen).to(torch.float32)
        * 0.001, torch.tensor(0.001), 8))) for _ in range(64)]], N)
    rows = torch.randn(P // 6, K, generator=gen).to(cuda)
    order = torch.randperm(P, generator=gen).to(cuda)
    weight = torch.rand(P, generator=gen).to(cuda)
    mask = range(0, 64, 3) if held else None
    first = dict(gather=order, top_k=6)
    second = dict(scatter=order, scale=weight)
    h = tg.term_matmul_grouped(rows, ends, gate_up, mask, **first)
    want_h = tg.term_matmul_grouped_ref(rows, ends, gate_up, mask, **first)
    g = torch.nn.functional.silu(want_h[0]) * want_h[1]
    out = tg.term_matmul_grouped(g, ends, down, mask, **second)
    want = tg.term_matmul_grouped_ref(g, ends, down, mask, **second)
    torch.cuda.synchronize()
    for got, ref in ((h, want_h), (out, want)):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_grouped_kernel_refuses_what_it_does_not_take(cuda):
    from tq_tpu_torch.kernels import term_matmul_grouped as tg

    x, ends, _, gw = _grouped_case("ragged", cuda)
    with pytest.raises(TypeError, match="float32"):
        tg.term_matmul_grouped(x.double(), ends, gw)
    with pytest.raises(ValueError, match="ends"):
        tg.term_matmul_grouped(x, ends.cpu(), gw)
    with pytest.raises(ValueError, match="ends"):
        tg.term_matmul_grouped(x, ends.to(torch.int32), gw)
    with pytest.raises(ValueError, match="contiguous"):
        tg.term_matmul_grouped(torch.cat([x, x], 1)[:, ::2], ends, gw)
    with pytest.raises(ValueError, match="gather"):
        tg.term_matmul_grouped(x, ends, gw, gather=ends.to(torch.int32))
    with pytest.raises(ValueError, match="scale"):
        tg.term_matmul_grouped(x, ends, gw, scale=ends.float())
