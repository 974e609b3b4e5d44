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

By default a program holds its constants on the device it was exported
on, and loads there.  ``platforms=`` (any of ``"cpu"`` and ``"cuda"``)
makes one artifact for several devices, the counterpart of the JAX
package's multi-platform lowering: the step is traced from CPU tensors
(the quantizers and products trace to the operators on either device, so
the graph is the one the card would trace), the platforms are recorded
in the saved file, and :func:`load_serving` moves the program to the
device it is asked for (``torch.export.passes.move_to_device_pass``:
constants, state and every node's ``device``), where the operators
launch that device's kernels.  :func:`serving_platforms` reads them back.

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
           "check_platforms", "serving_platforms", "to_cpu", "PLATFORMS"]

PLATFORMS = ("cpu", "cuda")
# The saved file's record of the platforms a portable artifact serves.
_PLATFORMS_FILE = "tq_platforms"


def check_platforms(platforms) -> tuple[str, ...] | None:
    """``platforms`` as a tuple of device types, or None for the
    single-device artifact; refuses an empty list and any name but
    ``"cpu"`` and ``"cuda"`` (a TPU is the JAX package's)."""
    if platforms is None:
        return None
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if not platforms or unknown:
        raise ValueError(f"platforms={platforms!r}: want a non-empty subset "
                         f"of {PLATFORMS} (unknown: {unknown})")
    return tuple(dict.fromkeys(platforms))


def to_cpu(tree):
    """The tensors of ``tree`` (dicts, lists, tuples, ``PackedWeight8``)
    copied to the CPU; other leaves kept."""
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                    tree)


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
    dicts / tuples of them) fixing the input signature.  ``platforms``:
    e.g. ``("cpu", "cuda")`` for one artifact that loads on either (see
    the module's docstring); ``fn`` must then close over CPU tensors
    only (:func:`to_cpu`), and the example arguments are traced on the
    CPU.
    """
    platforms = check_platforms(platforms)
    # Inputs that share a tensor (an LSTM's zero (h, c)) would be traced
    # as one input: give each its own.
    args = tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor)
                    else a, tuple(example_args))
    if platforms is None:
        with torch.no_grad():
            program = torch.export.export(_Program(fn), args)
        extra = {}
    else:
        refusal = (f"platforms={platforms}: a portable artifact is traced "
                   "from CPU tensors; build the step from to_cpu(...) of "
                   "its weights")
        try:
            with torch.no_grad():
                program = torch.export.export(_Program(fn), to_cpu(args))
        except RuntimeError as e:  # a closure on another device
            if "device" in str(e):
                raise ValueError(f"{refusal} ({e})") from e
            raise
        off = {str(t.device) for t in [*program.state_dict.values(),
                                       *program.constants.values()]
               if t.device.type != "cpu"}
        if off:
            raise ValueError(f"{refusal} (constants on {sorted(off)})")
        extra = {_PLATFORMS_FILE: ",".join(platforms)}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files=extra)
    data = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(data)
    return data


def _load(src):
    """(ExportedProgram, recorded platforms or None)."""
    extra = {_PLATFORMS_FILE: ""}
    f = io.BytesIO(src) if isinstance(src, bytes) else Path(src)
    program = torch.export.load(f, extra_files=extra)
    recorded = extra[_PLATFORMS_FILE]
    if isinstance(recorded, bytes):
        recorded = recorded.decode()
    return program, (tuple(recorded.split(",")) if recorded else None)


def serving_platforms(src: str | Path | bytes) -> tuple[str, ...]:
    """The device types an artifact serves (the JAX package's
    ``Exported.platforms``): the recorded platforms of a portable one,
    else the device it was traced on (its inputs' and constants')."""
    program, platforms = _load(src)
    if platforms is not None:
        return platforms
    return tuple(sorted({n.meta["val"].device.type
                         for n in program.graph.nodes
                         if n.op == "placeholder"
                         and isinstance(n.meta.get("val"), torch.Tensor)}))


def load_serving(src: str | Path | bytes, device=None):
    """bytes / file -> the program as a callable; inputs must match the
    exported signature (a mismatched shape or dtype raises).

    A portable artifact (exported with ``platforms=``) is moved to
    ``device``, which must be one of its platforms; by default the card
    if it serves one (``"cuda"``), else its one platform.  Loading on
    ``"cuda"`` with no card raises.  A single-device artifact loads where
    it was exported, and refuses ``device``.
    """
    program, platforms = _load(src)
    if platforms is None:
        if device is not None:
            raise ValueError(
                f"device={device!r}: this artifact holds its constants on "
                "the device it was exported on; export it with platforms= "
                "to load it on another")
        return program.module()
    if device is None:
        device = "cuda" if "cuda" in platforms else platforms[0]
    device = torch.device(device)
    if device.type not in platforms:
        raise ValueError(f"device {device}: the artifact serves "
                         f"{platforms} only")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device (load with "
                               "device='cpu' for the plain versions)")
        if device.index is None:  # the nodes' device checks compare indices
            device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module()


def export_lm_step(qparams, qcfg, qstate, path: str | Path | None = None,
                   batch: int = 1, nhid: int | None = None,
                   platforms=None) -> bytes:
    """Export the quantized recurrent-LM serving step
    ``step(tok (1, B) int64, hidden) -> (logp, hidden)`` with the
    (optionally packed) weights and calibrated scales as constants, on the
    weights' device, or, with ``platforms``, from CPU copies of them as
    an artifact for those devices.  Tokens are int64, the port's index
    type."""
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8
    from tq_tpu_torch.layers.lstm import GATE_MULT
    from tq_tpu_torch.models import lstm_lm

    platforms = check_platforms(platforms)
    if platforms is not None:
        qparams, qstate = to_cpu(qparams), to_cpu(qstate)
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
    return export_serving(step, (tok0, hidden0), path, platforms)
