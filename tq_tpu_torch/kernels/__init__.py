"""The hand-written kernels' wrappers.  Importing this package registers
the operators ``tq::term_matmul`` and ``tq::tr_quantize``, which a program
saved by :mod:`tq_tpu_torch.utils.export` calls."""

from tq_tpu_torch.kernels import term_matmul, tr_quantize  # noqa: F401
