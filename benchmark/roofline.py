"""The chip's peaks and the least time a piece of work can take on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W power limit).  Work is counted from a configuration's shapes
(``benchmark/work/<model>.py``), not from the kernels that run it: each
input byte read once, each output byte written once, two operations a
multiply-add.  The float32 TR configurations count a product at the TF32
tensor-core rate: the program computes its float32 products on the
tensor cores (three TF32 products each, or one for weights that TF32
holds exactly), and an exact faster route must not read above 100%.
"""

from __future__ import annotations

import importlib

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "tf32": 495e12,
    "fp32": 67e12,   # CUDA cores, beside the TF32 divisor in PERF.md
    "bf16": 989e12,
    "int8": 1979e12,
}


def least_seconds(ops: float, nbytes: float, peak: str) -> float:
    """The larger of operations at the ``peak`` rate and bytes at the HBM
    rate."""
    return max(ops / PEAK_OPS_PER_S[peak], nbytes / HBM_BYTES_PER_S)


def matmul(m: int, k: int, n: int, w_bytes: float, x_bytes: float = 4,
           out_bytes: float = 4) -> tuple[float, float]:
    """(operations, bytes) of an (m, k) x (k, n) product: ``w_bytes`` per
    weight, ``x_bytes`` per input, ``out_bytes`` per output."""
    return 2.0 * m * k * n, k * n * w_bytes + m * k * x_bytes + m * n * out_bytes


def work(cfg):
    """The work counts of ``cfg``'s model (``benchmark/work/<model>.py``)."""
    return importlib.import_module(f"benchmark.work.{cfg['model']}")


def share(least: float, seconds: float) -> float | None:
    """``least`` over ``seconds`` in %; None where nothing was timed."""
    if seconds <= 0:
        return None
    return 100.0 * least / seconds


def step_mfu(run, rows: int) -> float | None:
    """The model step's least time over its measured time (the traced
    run's untraced lead), in %."""
    steps, seconds = run.lead_steps, run.lead_seconds
    if not steps:
        return None
    ops, nbytes = work(run.cfg).step(run.cfg, rows)
    return share(least_seconds(ops, nbytes, run.cfg["peak"]),
                 seconds / steps)


def kernel_roofline(run, kernel: str, patterns, rows: int) -> float | None:
    """The least time of ``kernel``'s work in the traced window's steps
    over the summed device time of the kernels named by ``patterns``, in
    %; None where none ran."""
    seconds, count = run.trace.kernel_seconds(patterns)
    if not count or not run.trace_steps:
        return None
    ops, nbytes = work(run.cfg).kernel(run.cfg, kernel, rows)
    least = least_seconds(ops * run.trace_steps, nbytes * run.trace_steps,
                          run.cfg["peak"])
    return share(least, seconds)
