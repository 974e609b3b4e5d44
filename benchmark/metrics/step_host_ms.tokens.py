"""Host milliseconds of one model step call (its launches), the mean of
the traced run's last part."""


def read(run):
    return run.spans.mean_ms("step")
