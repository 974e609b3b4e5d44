"""PyTorch/CUDA port of ``tq_tpu`` for NVIDIA Hopper (H100, sm_90a).

The module layout and names follow ``tq_tpu`` so each function has an
obvious counterpart there; public functions keep its tensor layouts
(dense weights ``(in, out)``, grouped along axis 0).  Hand-written CUDA
kernels live in ``csrc/`` and are compiled with ``nvcc`` and loaded on
first use with a CUDA tensor, so importing this package needs neither a
GPU nor a CUDA toolkit.  On CPU tensors every kernel wrapper runs its
plain PyTorch version.
"""
