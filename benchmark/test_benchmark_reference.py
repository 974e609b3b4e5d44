"""The plain references against the program at small sizes on the CPU.

The references import nothing of the program; this test imports both.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import generator
from benchmark.reference import calibration, lstm_lm, resnet18, term_reveal
from benchmark.reference.precision import round_tf32

ROOT = Path(__file__).resolve().parent.parent


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" /
                       f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,axis,group,bits,terms", [
    ((3, 3, 16, 8), 2, 8, 9, 12),
    ((21, 13), 0, 8, 8, 24),      # a padded last group
    ((13, 21), 1, 4, 6, 5),
])
def test_grouped_reveal_equals_the_program(shape, axis, group, bits, terms):
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_ref

    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    sf = term_reveal.weight_scale(w, bits)
    got = term_reveal.reveal_grouped(w, sf, bits, group, terms, axis)
    want = tr_quantize_ref(w, sf, bits, group, terms, axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,terms", [(9, 3), (8, 8), (5, 5), (9, 12)])
def test_elementwise_reveal_equals_the_program(bits, terms):
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_ref

    x = 3 * torch.randn(4096, generator=torch.Generator().manual_seed(2))
    sf = torch.tensor(0.0244140625)
    assert torch.equal(term_reveal.reveal_elementwise(x, sf, bits, terms),
                       tr_quantize_ref(x, sf, bits, 1, terms))


def test_calibration_grids_histogram_and_search_equal_the_program():
    from tq_tpu_torch.layers.quantize import (calibration_grids,
                                              histogram_update,
                                              mse_search_scale)

    (points, candidates), (want_points, want_candidates) = (
        calibration.grids(), calibration_grids())
    assert torch.equal(candidates, want_candidates)
    # XLA's vectorized loop rounds three of the top bins' points (near
    # +50, where no activation of these models falls) one ulp away.
    differ = (points != want_points).nonzero().flatten().tolist()
    assert differ == [8183, 8186, 8190]
    assert torch.equal(torch.nextafter(points[differ], want_points[differ]),
                       want_points[differ])
    x = 4 * torch.randn(100_000, generator=torch.Generator().manual_seed(3))
    x[:5] = torch.tensor([-50.0, 50.0, 60.0, -0.0, 0.0])
    hist = calibration.add_to_histogram(calibration.new_histogram(), x)
    assert torch.equal(hist, histogram_update(torch.zeros(8192), x))
    for bits, terms in ((9, 3), (8, 8), (5, 5)):
        assert torch.equal(calibration.search_scale(hist, bits, terms),
                           mse_search_scale(hist, bits, terms))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12,
                      -(1.0 + 2**-11)])
    assert round_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10,
                                      1.0 + 2**-10, -(1.0 + 2**-10)]


def test_resnet18_reference_follows_the_program():
    """Converted weights equal, scales equal, logits within float32
    rounding at 32 x 32 (too few elements for a rounding boundary to flip
    a quantized input here)."""
    from tq_tpu_torch.convert import (convert_cnn, finalize_cnn,
                                      make_cnn_apply,
                                      static_conv_layer_settings)
    from tq_tpu_torch.models import resnet

    cfg = {**_cfg("resnet18-tr"), "image": 32}
    tr = cfg["tr"]
    params = resnet18.make_params(cfg, generator(4, "cpu", 1), "cpu")
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    settings = static_conv_layer_settings(resnet.conv_specs(32), 9, 8, 12)
    qp, qc, qs = convert_cnn(resnet, params, settings, 9, 3, image=32)
    weights = resnet18.convert(params, cfg, 9, 8, 12)
    assert set(weights) == set(qc)
    for name, w in weights.items():
        assert torch.equal(w, qp[name]["w"]), name
    _, qs = make_cnn_apply(resnet, qc, track=True)(qp, qs, x)
    qs = finalize_cnn(qs, qc)
    hists, scales = resnet18.calibrate(params, weights, cfg, [x], 9, 3)
    for name in weights:
        assert torch.equal(scales[name], qs[name]["sf"]), name
        moved = (hists[name] - qs[name]["hist"]).abs().sum()
        assert moved <= 2, name
    logits, _ = make_cnn_apply(resnet, qc, track=False)(qp, qs, x)
    want = resnet18.forward(params, weights, x, cfg, tr["data_bits"],
                            tr["data_terms"], scales=scales)
    assert float((logits - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_lstm_reference_follows_the_program():
    """The serving model at emsize 32 and 300 words: converted weights and
    the scale equal, teacher-forced log-probs within float32 rounding of
    the step the samplers call."""
    from tq_tpu_torch.evals.generate import serving_model
    from tq_tpu_torch.kernels.term_matmul import unpack_weight_u8s
    from tq_tpu_torch.models import lstm_lm as port

    cfg = {**_cfg("lstm650-tr"), "vocab": 300, "emsize": 32, "nhid": 32}
    params = lstm_lm.make_params(cfg, generator(6, "cpu", 1), "cpu")
    stream = lstm_lm.zipf_stream(cfg, generator(6, "cpu", 2), "cpu")
    qp, qc, qs = serving_model(params, (8, 8, 24, 8, 8), pack_fmt="u8s",
                               calib_stream=stream, cell="LSTM")
    conv = lstm_lm.convert(params, cfg)
    assert torch.equal(unpack_weight_u8s(qp["decoder"]["w"], k=32),
                       conv["decoder"])
    for key in ("w_ih", "w_hh"):
        assert torch.equal(unpack_weight_u8s(qp["rnn"][0][key], k=32),
                           conv[key])
    sf = lstm_lm.calibrate(params, conv, cfg, stream)
    assert torch.equal(sf, qs["rnn"]["sf"])
    inputs = torch.randint(0, 300, (12, 3),
                           generator=torch.Generator().manual_seed(7))
    step = port.make_quantized_apply(qc, track=False)
    hidden = port.init_hidden(3, nhid=32)
    h, c = lstm_lm.zero_state(cfg, 3, "cpu")
    for t in range(inputs.shape[0]):
        logp, hidden, _ = step(qp, qs, inputs[t:t + 1], hidden)
        want, h, c = lstm_lm.step(params, conv, sf, cfg, inputs[t], h, c)
        assert float((logp - want).abs().max()) <= 1e-5
        assert float((hidden[0] - h).abs().max()) <= 1e-6


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_gumbel_draws_the_sampler_tokens(temperature):
    """The reference's noise, drawn again from a request's seed, picks
    each token ``sample_quantized`` served from the log-probabilities of
    the step it calls."""
    from tq_tpu_torch.evals.generate import sample_quantized, serving_model
    from tq_tpu_torch.models import lstm_lm as port

    cfg = {**_cfg("lstm650-tr"), "vocab": 300, "emsize": 32, "nhid": 32}
    params = lstm_lm.make_params(cfg, generator(8, "cpu", 1), "cpu")
    stream = lstm_lm.zipf_stream(cfg, generator(8, "cpu", 2), "cpu")
    qp, qc, qs = serving_model(params, (8, 8, 24, 8, 8), pack_fmt="u8s",
                               calib_stream=stream, cell="LSTM")
    seed = 2**40 + 3
    served = sample_quantized(qp, qc, qs, 300, words=20,
                              temperature=temperature, seed=seed)
    noise = lstm_lm.gumbel(seed, 20, 300, "cpu")
    step = port.make_quantized_apply(qc, track=False)
    hidden = port.init_hidden(1, nhid=32)
    first = int(np.random.default_rng(seed).integers(0, 300))
    for t, tok in enumerate([first] + served[:-1]):
        logp, hidden, _ = step(qp, qs, torch.tensor([[tok]]), hidden)
        score = logp[0].double() / temperature + noise[t]
        assert int(score.argmax()) == served[t], t
