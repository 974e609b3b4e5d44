"""Milliseconds of a setting's conversion (convert_cnn), ended by a
synchronize, the mean of the traced run's last part."""


def read(run):
    return run.spans.mean_ms("convert")
