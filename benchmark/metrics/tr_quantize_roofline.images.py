"""B1 on the converted convs' inputs: the least time of its bytes over
its kernels' summed device time, in %."""

from benchmark.roofline import kernel_roofline

# The element-wise term-reveal kernel of csrc/tr_quantize.cu.
KERNELS = ("tr_elementwise_kernel",)


def read(run):
    return kernel_roofline(run, "tr_quantize", KERNELS, run.loop.rows)
