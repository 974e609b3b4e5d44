"""Every TR product of a step (the quantized layer's two products and the
decoder): their least time over the summed device time of term_matmul's
kernels (streaming, mma, mma_lp, tiled), in %."""

from benchmark.roofline import kernel_roofline

KERNELS = ("term_matmul",)


def read(run):
    return kernel_roofline(run, "term_matmul", KERNELS, run.loop.rows)
