"""Device milliseconds a decode step spends in the KDA layers between
their input products and ``o_proj`` (the port's ``tq.kda.recur`` spans,
timed by CUDA events: the convolution, the features, the recurrence and
the gated norm): their sum over the traced part's steps."""

from benchmark.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "tq.kda.recur")
