"""Every TR product of a decode step (the attention's projections, the
routed experts on their rows, the shared experts, the dense layer and
lm_head): their least time over the summed device time of term_matmul's
kernels (streaming, mma), in %."""

from benchmark.roofline import kernel_roofline

KERNELS = ("term_matmul",)


def read(run):
    return kernel_roofline(run, "term_matmul", KERNELS, run.loop.rows)
