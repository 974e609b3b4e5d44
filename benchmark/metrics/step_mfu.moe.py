"""The decode step's least time on the chip (its operations at the
configuration's peak, or its bytes at the HBM rate, whichever is longer,
attending over the traffic's mean number of cache entries) over its
measured time, in %."""

from benchmark.roofline import least_seconds, share
from benchmark.work import deepseek_v3 as work


def read(run):
    if not run.lead_steps:
        return None
    ops, nbytes = work.step(run.cfg, run.loop.rows,
                            work.mean_positions(run.traffic))
    return share(least_seconds(ops, nbytes, run.cfg["peak"]),
                 run.lead_seconds / run.lead_steps)
