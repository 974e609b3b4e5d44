"""Each cell's check on the CPU at a small size, with the cell's own
limits: a sound run comes out correct; the control (the reference at
TF32 in the program's place) and a run with the timed path broken
underneath come out not correct.  The harness's look for a chip is
skipped; the rest of a run is driven as the benchmark drives it.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run as bench

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The LSTM LM at its published widths over a narrower vocabulary: a
# random model any narrower hardly reads its hidden state, and its
# log-probabilities have too few near-ties for the control to move a
# served token.
LM_SMALL = {"vocab": 4000}


def _small(workload: str):
    """The cell at a size a CPU test holds: ResNet-18's published widths
    at 32 x 32, the LSTM LM's over a vocabulary of 4,000."""
    _, cfg, traffic, e2e, layer = bench.cell_spec(MANIFEST, workload)
    if cfg["model"] == "resnet18":
        cfg["image"] = 32
        traffic.update(batch=4, pool_images=8, calib_images=8,
                       calib_batches=2, check_settings=1,
                       grid=traffic.get("grid", [])[:3])
    else:
        cfg.update(LM_SMALL)
        traffic.update(batch=4, steps=6, tokens=30, check_rows=2)
    return cfg, traffic, e2e


def drive(workload: str, control: bool = False, seconds: float = 0.5):
    cfg, traffic, e2e = _small(workload)
    limits = json.loads((ROOT / "benchmark" / "limits" /
                         f"{workload}.json").read_text())
    result, _, _ = bench.run_cell(workload, cfg, traffic, e2e, [], limits,
                                  SEED, seconds, False, torch.device("cpu"),
                                  control=control)
    return result


CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = drive(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result = drive(workload, control=True)
    assert not result["correct"], result["checks"]


# ------------------------------------------------- faults in the timed path


def _break_cnn_apply(monkeypatch, fault: str):
    from tq_tpu_torch import convert

    real = convert.make_cnn_apply

    def make(model, qcfg, track, **kw):
        fwd = real(model, qcfg, track, **kw)

        def broken(qparams, qstate, x):
            if fault == "state_unchanged" and track:
                return fwd(qparams, qstate, x)[0], qstate
            if fault == "half_batch" and track:
                return fwd(qparams, qstate, x[:len(x) // 2])
            if fault == "half_batch" and not track:
                half = fwd(qparams, qstate, x[:len(x) // 2])[0]
                return torch.cat([half, half]), qstate
            logits, qs = fwd(qparams, qstate, x)
            if fault == "answer_altered" and not track:
                logits = logits.clone()
                logits[0, 0] += logits.abs().max()
            return logits, qs

        return broken

    monkeypatch.setattr(convert, "make_cnn_apply", make)


def _break_scale(monkeypatch):
    from tq_tpu_torch import convert

    real = convert.finalize_cnn

    def finalize(qstate, qcfg):
        out = real(qstate, qcfg)
        name = next(iter(out))
        out[name] = {**out[name], "sf": out[name]["sf"] * 2}
        return out

    monkeypatch.setattr(convert, "finalize_cnn", finalize)


def _break_lm_step(monkeypatch, fault: str):
    from tq_tpu_torch.models import lstm_lm

    real = lstm_lm.make_quantized_apply

    def make(qcfg, track):
        fwd = real(qcfg, track)

        def broken(qparams, qstate, tokens, hidden):
            if track:
                return fwd(qparams, qstate, tokens, hidden)
            if fault == "half_batch" and tokens.shape[1] > 1:
                half = tokens.shape[1] // 2
                logp, new, qs = fwd(qparams, qstate, tokens[:, :half],
                                    tuple(h[:, :half] for h in hidden))
                return (torch.cat([logp, logp]),
                        tuple(torch.cat([h, h], dim=1) for h in new), qs)
            logp, new, qs = fwd(qparams, qstate, tokens, hidden)
            if fault == "state_unchanged":
                return logp, hidden, qs
            if fault == "token_altered":
                logp = logp.clone()
                logp[0] = torch.roll(logp[0], 1)
            if fault == "decoder_columns":
                # A block of the decoder's columns off by a little, below
                # any served token's reach.
                logp = logp.clone()
                logp[:, 1000:1064] -= 1e-3
            return logp, new, qs

        return broken

    monkeypatch.setattr(lstm_lm, "make_quantized_apply", make)


def _break_sampler(monkeypatch, fault: str):
    """Faults of ``sample_quantized``'s own loop: a token altered after
    it is drawn, or the carried state never advanced."""
    from tq_tpu_torch.evals import generate

    real = generate._sample_scan

    def scan(fwd, hidden0, *args):
        if fault == "carry_unchanged":
            return real(lambda tok, hidden: (fwd(tok, hidden)[0], hidden),
                        hidden0, *args)
        tokens = real(fwd, hidden0, *args)
        tokens[3] = (tokens[3] + 1) % args[0]
        return tokens

    monkeypatch.setattr(generate, "_sample_scan", scan)


FAULTS = [
    ("resnet18-tr-eval-b64", "state_unchanged"),
    ("resnet18-tr-eval-b64", "half_batch"),
    ("resnet18-tr-eval-b64", "answer_altered"),
    ("resnet18-tr-calib", "state_unchanged"),
    ("resnet18-tr-calib", "half_batch"),
    ("resnet18-tr-calib", "answer_altered"),
    ("lstm650-tr-gen-b64", "state_unchanged"),
    ("lstm650-tr-gen-b64", "half_batch"),
    ("lstm650-tr-gen-b64", "token_altered"),
    ("lstm650-tr-gen-b64", "decoder_columns"),
    ("lstm650-tr-gen-b1", "state_unchanged"),
    ("lstm650-tr-gen-b1", "token_altered"),
    ("lstm650-tr-gen-b1", "decoder_columns"),
    ("lstm650-tr-gen-b1", "sampled_token_altered"),
    ("lstm650-tr-gen-b1", "carry_unchanged"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    if workload.startswith("resnet18"):
        if workload.endswith("calib") and fault == "answer_altered":
            _break_scale(monkeypatch)
        else:
            _break_cnn_apply(monkeypatch, fault)
    elif fault in ("sampled_token_altered", "carry_unchanged"):
        _break_sampler(monkeypatch, fault)
    else:
        _break_lm_step(monkeypatch, fault)
    result = drive(workload)
    assert not result["correct"], result["checks"]
