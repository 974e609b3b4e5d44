"""Interactive generation for one client: requests one after another at
batch 1.

Set-up builds the program's serving model (converted, calibrated on the
seeded stream, packed) and serves one request.  Each unit is one request
of ``tokens`` tokens through ``evals/generate.py::sample_quantized``,
sampled at ``temperature`` under a seed derived from the run's and the
request's index, ending when they are on the host.  Checked: a sample of
the window's requests.  Once the window has closed, the sampler's step
(``make_quantized_apply`` on the same serving model) is fed each of
their served tokens in turn, and the reference follows each step from
the state that gives: the whole row of log-probabilities, the state, and
the served token's score, which has to be the best once the sampler's
noise, drawn again from the request's seed, is added.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import Reservoir, sub_seed
from benchmark.loops.lm_common import check, reference, serving_model


class Loop:
    rows = 1

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.units = self.steps = self.attempted = self.failed = 0
        self.latencies: list[float] = []

    def setup(self) -> None:
        from tq_tpu_torch.evals.generate import sample_quantized

        self.params, self.stream, self.served = serving_model(self.run)
        self._sample = sample_quantized
        self._request(sub_seed(self.run.seed, 6, 2**32))
        self.kept = Reservoir(self.traffic["check_requests"], self.run.seed)

    def _first(self, seed: int) -> int:
        """The request's first token, drawn as the sampler draws it."""
        return int(np.random.default_rng(seed).integers(0, self.cfg["vocab"]))

    def _request(self, seed: int) -> list[int]:
        return self._sample(*self.served, self.cfg["vocab"],
                            words=self.traffic["tokens"],
                            temperature=self.traffic["temperature"],
                            seed=seed)

    def unit(self) -> None:
        seed = sub_seed(self.run.seed, 6, self.units)
        keep = self.kept.wants()
        t0 = time.perf_counter()
        tokens = self._request(seed)
        self.latencies.append(time.perf_counter() - t0)
        if keep:
            self.kept.put((seed, tokens))
        self.units += 1
        self.steps += self.traffic["tokens"]
        self.attempted += 1

    def drain(self) -> None:
        self.run.spans.sync()

    def end_to_end(self, seconds: float) -> dict:
        lat = np.asarray(self.latencies) * 1e3
        return {"tokens_per_s": (self.units * self.traffic["tokens"]
                                 / seconds, "tokens/s"),
                "request_ms_p95": (float(np.percentile(lat, 95)), "ms")}

    def _replay(self, seed: int, tokens: list[int]):
        """The sampler's step fed the request's first token and its served
        tokens but the last: (log-probabilities (T, 1, vocab), the state
        after each step)."""
        from tq_tpu_torch.models import lstm_lm

        qparams, qcfg, qstate = self.served
        step = lstm_lm.make_quantized_apply(qcfg, track=False)
        dev, cfg = self.run.device, self.cfg
        inputs = torch.tensor([self._first(seed)] + tokens[:-1],
                              device=dev).view(-1, 1, 1)
        hidden = lstm_lm.init_hidden(1, nhid=cfg["nhid"],
                                     nlayers=cfg["nlayers"], device=dev)
        rows, states = [], []
        for tok in inputs:
            logp, hidden, _ = step(qparams, qstate, tok, hidden)
            rows.append(logp)
            states.append(hidden)
        return torch.stack(rows), states

    def release(self) -> None:
        """Replays the sampled requests, then frees the serving model."""
        self.replayed = [(seed, tokens, *self._replay(seed, tokens))
                         for seed, tokens in self.kept.items]
        del self.served

    def readings(self, control: bool = False) -> dict:
        """``logp_gap``, ``row_gap`` and ``state_gap``
        (``lm_common.check``) of the sampled requests."""
        dev, cfg = self.run.device, self.cfg
        ref = reference(cfg)
        parts = [(torch.tensor([self._first(seed)], device=dev),
                  torch.tensor(tokens, device=dev).view(-1, 1), rows,
                  states,
                  self.traffic["temperature"]
                  * ref.gumbel(seed, len(tokens), cfg["vocab"],
                               dev)[:, None])
                 for seed, tokens, rows, states in self.replayed]
        return check(self.run, self.params, self.stream, parts, control)
