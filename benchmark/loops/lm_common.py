"""Set-up and the check shared by the language-model loops."""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import generator


def reference(cfg):
    return importlib.import_module(f"benchmark.reference.{cfg['model']}")


def serving_model(run):
    """The seeded model and calibration stream, and the program's serving
    model built from them (``evals/generate.py::serving_model``):
    (params, stream, (qparams, qcfg, qstate))."""
    from tq_tpu_torch.evals.generate import serving_model as build

    cfg, dev = run.cfg, run.device
    ref = reference(cfg)
    params = ref.make_params(cfg, generator(run.seed, dev, 1), dev)
    stream = ref.zipf_stream(cfg, generator(run.seed, dev, 2), dev)
    tr, srv = cfg["tr"], cfg["serving"]
    setting = (tr["weight_bits"], tr["group_size"], tr["weight_terms"],
               tr["data_bits"], tr["data_terms"])
    served = build(params, setting, pack_fmt=srv["pack"],
                   calib_stream=stream,
                   calib_chunks=cfg["calibration"]["chunks"], cell="LSTM",
                   quantize_decoder_input=srv["quantize_decoder_input"])
    return params, stream, served


def check(run, params, stream, parts, control: bool = False) -> dict:
    """``logp_gap``, ``row_gap`` and ``state_gap`` of the sampled
    requests, each step followed from the program's own state
    (``reference.follow``); infinite where no request was kept.

    ``parts``: requests, each (prompts (R,), served tokens (T, R), the
    program's log-probabilities (T, R, vocab), its states after each
    step, the sampler's noise (T, R, vocab) or None where greedy), put
    side by side.  With ``control`` the reference at TF32 takes the
    program's place: fed the same tokens from its own states, the token
    it puts first each step."""
    names = ("logp_gap", "row_gap", "state_gap")
    if not parts:
        return dict.fromkeys(names, float("inf"))
    prompts, served, rows, states, noise = joined(parts)
    cfg = run.cfg
    ref = reference(cfg)
    inputs = torch.cat([prompts[None], served[:-1]])
    conv = ref.convert(params, cfg)
    sf = ref.calibrate(params, conv, cfg, stream)
    if control:
        c_sf = ref.calibrate(params, conv, cfg, stream, tf32=True)
        h, c = ref.zero_state(cfg, inputs.shape[1], inputs.device)
        rows, states, firsts = [], [], []
        for t in range(inputs.shape[0]):
            logp, h, c = ref.step(params, conv, c_sf, cfg, inputs[t], h, c,
                                  tf32=True)
            score = logp if noise is None else logp.double() + noise[t]
            rows.append(logp)
            states.append((h, c))
            firsts.append(score.argmax(-1))
        served = torch.stack(firsts)
    gaps = ref.follow(params, conv, sf, cfg, inputs, served, rows, states,
                      noise)
    return dict(zip(names, gaps))


def joined(parts):
    """Requests of several parts side by side."""
    prompts, served, rows, states, noise = zip(*parts)
    return (torch.cat(prompts), torch.cat(served, dim=1),
            torch.cat(rows, dim=1),
            [(torch.cat([s[t][0] for s in states], dim=1),
              torch.cat([s[t][1] for s in states], dim=1))
             for t in range(len(states[0]))],
            None if noise[0] is None else torch.cat(noise, dim=1))
