"""% of the traced window in which the device idled while the host was
under none of the port's ``tq.*`` spans: the caller's own time."""

from benchmark.spans import idle_outside


def read(run):
    return idle_outside(run.trace)
