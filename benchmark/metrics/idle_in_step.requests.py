"""% of the traced window in which the device idled while the host was
inside a model step (the port's ``tq.lstm.step`` spans)."""

from benchmark.spans import idle_in


def read(run):
    return idle_in(run.trace, "tq.lstm.step")
