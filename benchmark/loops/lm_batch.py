"""Offline batch generation: waves of greedy requests through
``parallel/serving.py::BatchRunner`` on a one-rank mesh.

Set-up builds the program's serving model (converted, calibrated on the
seeded stream, packed) and a one-rank process group and mesh
(``parallel/mesh.py::local_mesh``).  Each unit is one wave: ``batch``
requests, each one seeded first token, submitted to the runner, whose
forward runs ``steps`` greedy steps of ``make_quantized_apply`` at the
whole batch; ``harvest`` brings every token to the host.  Checked: a
sample of the window's requests, each step followed from the program's
own state by the reference: the served token's log-probability, the
whole row of log-probabilities and the state.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness import Reservoir, sub_seed
from benchmark.loops.lm_common import check, serving_model


class Greedy:
    """Greedy generation through the program's step
    (``models/lstm_lm.py::make_quantized_apply``), the whole batch a step,
    as the samplers call it.  With ``record`` (a slice of the rows, a
    list) copies of those rows' log-probabilities and new states are kept
    each step for the check."""

    def __init__(self, run, served):
        from tq_tpu_torch.models import lstm_lm

        self._qparams, qcfg, self._qstate = served
        self._step = lstm_lm.make_quantized_apply(qcfg, track=False)
        self._hidden = lstm_lm.init_hidden
        self.run = run

    def __call__(self, first: torch.Tensor, steps: int, record=None):
        """(rows, steps) tokens after each row's ``first`` token."""
        cfg = self.run.cfg
        tok = first.view(1, -1)
        hidden = self._hidden(tok.shape[1], nhid=cfg["nhid"],
                              nlayers=cfg["nlayers"], device=first.device)
        out = []
        for _ in range(steps):
            with self.run.spans("step", sync=False):
                logp, hidden, _ = self._step(self._qparams, self._qstate,
                                             tok, hidden)
                tok = logp.argmax(-1).view(1, -1)
            if record is not None:
                rows, kept = record
                kept.append((logp[rows].clone(), hidden[0][:, rows].clone(),
                             hidden[1][:, rows].clone()))
            out.append(tok)
        return torch.cat(out).T


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.rows = self.traffic["batch"]
        self.units = self.steps = self.attempted = self.failed = 0
        self._record = None

    def setup(self) -> None:
        from tq_tpu_torch.parallel.mesh import local_mesh
        from tq_tpu_torch.parallel.serving import BatchRunner

        dev = self.run.device
        self.params, self.stream, served = serving_model(self.run)
        self.greedy = Greedy(self.run, served)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0)
        self.runner = BatchRunner(self._generate, local_mesh(device=dev.type),
                                  self.rows)
        self._wave(np.zeros(self.rows, dtype=np.int64))
        self.kept = Reservoir(self.traffic["check_waves"], self.run.seed)

    def _generate(self, first: torch.Tensor) -> torch.Tensor:
        return self.greedy(first, self.traffic["steps"], self._record)

    def _wave(self, first: np.ndarray) -> np.ndarray:
        ids = [self.runner.submit(t) for t in first]
        got = self.runner.harvest()
        return np.stack([got[i] for i in ids])

    def unit(self) -> None:
        rng = np.random.default_rng(sub_seed(self.run.seed, 5, self.units))
        first = rng.integers(0, self.cfg["vocab"], self.rows, dtype=np.int64)
        if self.kept.wants():
            every = self.rows // self.traffic["check_rows"]
            rows = slice(int(rng.integers(0, every)), None, every)
            self._record = (rows, [])
        tokens = self._wave(first)
        if self._record is not None:
            self.kept.put((first, tokens, rows, self._record[1]))
            self._record = None
        self.units += 1
        self.steps += self.traffic["steps"]
        self.attempted += self.rows

    def drain(self) -> None:
        self.run.spans.sync()

    def end_to_end(self, seconds: float) -> dict:
        tokens = self.units * self.rows * self.traffic["steps"]
        return {"tokens_per_s": (tokens / seconds, "tokens/s")}

    def release(self) -> None:
        del self.greedy, self.runner
        dist.destroy_process_group()

    def readings(self, control: bool = False) -> dict:
        """``logp_gap``, ``row_gap`` and ``state_gap``
        (``lm_common.check``) of ``check_rows`` requests of each sampled
        wave, spread evenly over it from a first drawn from the seed."""
        dev = self.run.device
        parts = [(torch.as_tensor(first[rows], device=dev),
                  torch.as_tensor(tokens[rows].T, device=dev),
                  torch.stack([logp for logp, _, _ in kept]),
                  [(h, c) for _, h, c in kept], None)
                 for first, tokens, rows, kept in self.kept.items]
        return check(self.run, self.params, self.stream, parts, control)
