"""Milliseconds a request waits in ``BatchRunner``'s queue, from its
submission to its batch's launch: the runner's ``counts``, the mean over
the run's requests."""


def read(run):
    counts = getattr(getattr(run.loop, "runner", None), "counts", None)
    if not counts or not counts["requests"]:
        return None
    return counts["queue_wait_ns"] / counts["requests"] / 1e6
