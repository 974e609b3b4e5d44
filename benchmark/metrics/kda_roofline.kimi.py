"""The KDA layers' least work a decode step between their products (the
recurrence's state and the convolution tails read and written once, with
their inputs and outputs: ``work.kernel(cfg, "kda", rows)``) at the
chip's rates, over the device time of the ``tq.kda.recur`` spans a step,
in %.  The work is counted from the shapes, whatever kernels compute it.
The spans' time (CUDA events on the stream) is the kernels' inside them
plus any idle between those kernels, so the share reads at most the
kernels' own: the harness's trace keeps no link from a kernel to the
span that launched it.  Before a change to KDA claims a gain on this
share, a benchmark change has to make it read the kernels' time alone
(the trace's ``gpu_user_annotation`` ranges or the kernels' correlation
ids), so that less idle inside the spans is not read as a kernel nearer
its bound."""

from benchmark.roofline import least_seconds, share
from benchmark.spans import device_ms_per_step
from benchmark.work import kimi_linear as work


def read(run):
    ms = device_ms_per_step(run, "tq.kda.recur")
    if not ms:
        return None
    ops, nbytes = work.kernel(run.cfg, "kda", run.loop.rows)
    return share(least_seconds(ops, nbytes, run.cfg["peak"]), ms * 1e-3)
