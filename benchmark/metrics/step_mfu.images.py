"""The model step's least time on the chip (its operations at the
configuration's peak, or its bytes at the HBM rate, whichever is longer)
over its measured time, in %."""

from benchmark.roofline import step_mfu


def read(run):
    return step_mfu(run, run.loop.rows)
