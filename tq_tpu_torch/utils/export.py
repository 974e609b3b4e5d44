"""Serialization of quantized serving programs with ``torch.export``.

Port of ``tq_tpu.utils.export``.  The reference exports its trained LM to
ONNX as the deployable artifact (``--onnx-export``); the JAX package
serializes the jitted step to StableHLO.  Here the step is traced by
``torch.export`` and saved with ``torch.export.save``: the (packed)
weights and calibrated scales are the program's constants, and the
kernels are calls of the operators ``tq::term_matmul`` and
``tq::tr_quantize`` (registered by :mod:`tq_tpu_torch.kernels`), whose
CUDA implementations launch the kernels and whose CPU implementations are
their plain versions.  Loading needs no model-building code, only
``tq_tpu_torch.kernels`` imported so that those operators exist; this
module imports it.

A program holds its constants on the device it was exported on: there is
no counterpart of the JAX package's multi-platform lowering
(``platforms=``), which is refused (ROADMAP).

Two artifact shapes, as in the JAX package: a recurrent step
``fn(tok, hidden) -> (logp, hidden)`` (:func:`export_lm_step`) and the
Transformer's KV-cache step ``fn(tok, pos, cache) -> (logp, cache)``
(``evals/generate.py``), both through :func:`export_serving`.
"""

from __future__ import annotations

import io
from pathlib import Path

import torch
from torch.utils._pytree import tree_map

import tq_tpu_torch.kernels  # noqa: F401  (registers the operators)

__all__ = ["export_serving", "load_serving", "export_lm_step",
           "check_platforms"]


def check_platforms(platforms) -> None:
    """Refuse ``platforms=``: a ``torch.export`` program holds its
    constants on one device, so one artifact for several has no
    counterpart here."""
    if platforms is not None:
        raise ValueError(
            f"platforms={platforms!r}: a torch.export program holds its "
            "constants on the device it was exported on, so there is no "
            "multi-platform artifact (ROADMAP: --export-platforms); export "
            "on the device that serves it")


class _Program(torch.nn.Module):
    """``fn`` as a module: the tensors ``fn`` closes over (weights,
    scales) become the exported program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serving(fn, example_args, path: str | Path | None = None,
                   platforms=None) -> bytes:
    """Trace ``fn`` at ``example_args``' shapes and dtypes with
    ``torch.export`` and save it; returns the saved bytes and also writes
    them to ``path``.

    ``fn``: a callable whose closure (weights, scales, configs) becomes
    the program's constants; ``example_args``: a tuple of tensors (or
    dicts / tuples of them) fixing the input signature.
    """
    check_platforms(platforms)
    # Inputs that share a tensor (an LSTM's zero (h, c)) would be traced
    # as one input: give each its own.
    args = tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor)
                    else a, tuple(example_args))
    with torch.no_grad():
        program = torch.export.export(_Program(fn), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(data)
    return data


def load_serving(src: str | Path | bytes):
    """bytes / file -> the program as a callable; inputs must match the
    exported signature (a mismatched shape or dtype raises)."""
    f = io.BytesIO(src) if isinstance(src, bytes) else Path(src)
    return torch.export.load(f).module()


def export_lm_step(qparams, qcfg, qstate, path: str | Path | None = None,
                   batch: int = 1, nhid: int | None = None,
                   platforms=None) -> bytes:
    """Export the quantized recurrent-LM serving step
    ``step(tok (1, B) int64, hidden) -> (logp, hidden)`` with the
    (optionally packed) weights and calibrated scales as constants, on the
    weights' device.  Tokens are int64, the port's index type."""
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8
    from tq_tpu_torch.layers.lstm import GATE_MULT
    from tq_tpu_torch.models import lstm_lm

    check_platforms(platforms)
    cell = qcfg.get("cell", "LSTM")
    fwd = lstm_lm.make_quantized_apply(qcfg, track=False)

    def step(tok, hidden):
        logp, hidden, _ = fwd(qparams, qstate, tok, hidden)
        return logp, hidden

    if nhid is None:
        w_hh = qparams["rnn"][0]["w_hh"]
        n = (w_hh.lo.shape[1] if isinstance(w_hh, PackedWeight8)
             else w_hh.shape[1])
        nhid = n // GATE_MULT[cell]
    device = qparams["encoder"]["w"].device
    hidden0 = lstm_lm.init_hidden(batch, nhid=nhid,
                                  nlayers=len(qparams["rnn"]), cell=cell,
                                  device=device)
    tok0 = torch.zeros((1, batch), dtype=torch.int64, device=device)
    return export_serving(step, (tok0, hidden0), path)
