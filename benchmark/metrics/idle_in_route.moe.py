"""% of the traced window in which the device idled while the host was
routing (the port's ``tq.moe.route`` spans: the router, the sort and the
experts' counts copied to the host)."""

from benchmark.spans import idle_in


def read(run):
    return idle_in(run.trace, "tq.moe.route")
