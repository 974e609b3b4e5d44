"""Every TR product of a decode step (KDA's and MLA's projections, the
held experts on their rows, the shared expert, the dense layer and
lm_head): their least time over the summed device time of the kernels
named term_matmul* (streaming, mma, the grouped expert product), in %."""

from benchmark.roofline import kernel_roofline

KERNELS = ("term_matmul",)


def read(run):
    return kernel_roofline(run, "term_matmul", KERNELS, run.loop.rows)
