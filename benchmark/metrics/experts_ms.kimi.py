"""Device milliseconds a decode step spends in the expert layers'
experts (the port's ``tq.moe.experts`` spans, timed by CUDA events):
their sum over the traced part's steps."""

from benchmark.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "tq.moe.experts")
