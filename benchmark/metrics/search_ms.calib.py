"""Milliseconds of a setting's calibration: the tracked forwards that
fill the histograms and the scale search (finalize_cnn), ended by a
synchronize, the mean of the traced run's last part."""


def read(run):
    return run.spans.mean_ms("search")
