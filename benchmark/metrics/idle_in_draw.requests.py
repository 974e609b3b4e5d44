"""% of the traced window in which the device idled while the host was
inside the sampler's draw of a token (the port's ``tq.sampler.draw``
spans)."""

from benchmark.spans import idle_in


def read(run):
    return idle_in(run.trace, "tq.sampler.draw")
