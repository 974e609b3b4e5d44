"""% of the traced window in which no kernel ran on the device."""


def read(run):
    return run.trace.idle_share()
