"""Device milliseconds a setting spends in the calibration histograms'
updates (the port's ``tq.calib.histogram`` spans, timed by CUDA events):
their sum over the traced part's settings."""

from benchmark.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "tq.calib.histogram")
