"""Group-wise term revealing (the core TR op) on tensors.

Port of ``tq_tpu.ops.term_reveal``.  Uniform-quantize magnitudes onto a
``bits``-bit grid, HESE-encode each value into signed power-of-two terms,
keep the ``num_keep_terms`` largest terms per group of ``group_size``
consecutive elements along ``axis`` (ties broken toward the lower element
index), drop the rest and dequantize.  A term at (element e, plane p)
survives iff

    #terms in the group at planes > p  +  #terms at plane p in elements < e
        <  budget

('serial' counts the planes < p instead).  Trailing groups are zero-padded.

``sf`` is a float32 0-d tensor on ``x``'s device: on CUDA, PyTorch divides
by a host scalar as a multiplication by its reciprocal, which is not the
correctly rounded ``|x| / sf`` the grid is defined by.
"""

from __future__ import annotations

import torch

from tq_tpu_torch.ops.hese import hese_digit_planes, num_planes

__all__ = ["as_scale", "uniform_quantize", "term_reveal",
           "term_reveal_elementwise", "term_reveal_elementwise_int",
           "term_reveal_st"]


def as_scale(sf, device) -> torch.Tensor:
    """``sf`` as a float32 0-d tensor on ``device``: ``sf`` itself when it
    is one (no new tensor on a kernel's per-call path)."""
    if (isinstance(sf, torch.Tensor) and sf.dtype == torch.float32
            and sf.dim() == 0 and sf.device == device):
        return sf
    return torch.as_tensor(sf, dtype=torch.float32, device=device).reshape(())


def uniform_quantize(x: torch.Tensor, sf, bits: int):
    """``(q, sign)``: int32 ``min(floor(|x|/sf + 0.5), 2**bits - 1)`` and
    sign in {-1.0, +1.0} (sign(0) == +1)."""
    sf = as_scale(sf, x.device)
    mag = torch.floor(x.abs() / sf + 0.5)
    q = torch.clamp(mag, 0, 2**bits - 1).to(torch.int32)
    sign = torch.where(x < 0, -1.0, 1.0).to(x.dtype)
    return q, sign


def _select_topk_planes(planes, budget: int, keep_mode: str = "largest"):
    """Zero all but ``budget`` terms per group of int32 ``(..., g, T)``
    digit planes."""
    absd = planes.abs()
    cnt = absd.sum(dim=-2, keepdim=True)  # per-plane group count
    if keep_mode == "largest":
        before = cnt.flip(-1).cumsum(-1).flip(-1) - cnt  # planes p' > p
    elif keep_mode == "serial":
        before = cnt.cumsum(-1) - cnt  # planes p' < p
    else:
        raise ValueError(f"unknown keep_mode {keep_mode!r}")
    within = absd.cumsum(-2) - absd  # exclusive rank over the group
    keep = (before + within < budget) & (absd > 0)
    return torch.where(keep, planes, torch.zeros_like(planes))


def term_reveal(x: torch.Tensor, sf, bits: int, group_size: int = 1,
                num_keep_terms: int = 8, axis: int = 1,
                keep_mode: str = "largest") -> torch.Tensor:
    """Fake-quantize ``x`` by group-wise top-alpha term revealing."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    orig_shape = x.shape
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    pad = (-n) % group_size
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    grouped = xm.reshape(xm.shape[:-1] + (-1, group_size))

    q, sign = uniform_quantize(grouped, sf, bits)
    kept = _select_topk_planes(hese_digit_planes(q, bits), num_keep_terms,
                               keep_mode)
    pow2 = 1 << torch.arange(num_planes(bits), dtype=torch.int32,
                             device=x.device)
    outq = (kept * pow2).sum(dim=-1)
    out = sign * outq.to(x.dtype) * as_scale(sf, x.device)

    out = out.reshape(xm.shape)
    if pad:
        out = out[..., :n]
    return torch.movedim(out, -1, axis).reshape(orig_shape)


def term_reveal_elementwise(x: torch.Tensor, sf, bits: int,
                            num_keep_terms: int) -> torch.Tensor:
    """``term_reveal(x, sf, bits, 1, k)`` as loop-free element-wise int32
    math (no digit-plane tensor): the plain version of the
    ``tr_quantize`` element-wise kernel."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_ref

    return tr_quantize_ref(x, sf, bits, 1, num_keep_terms)


def term_reveal_elementwise_int(x: torch.Tensor, sf, bits: int,
                                num_keep_terms: int) -> torch.Tensor:
    """:func:`term_reveal_elementwise` without the dequantization: the
    signed int32 ``+-q_kept``."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int_ref

    return tr_quantize_int_ref(x, sf, bits, num_keep_terms)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``tr_quantize`` (on CUDA the element-wise kernel at
    ``group_size == 1``, the grouped kernel above it; on the CPU their
    plain version).  Backward: the upstream gradient unchanged for ``x``,
    zero for ``sf``; it launches nothing."""

    @staticmethod
    def forward(ctx, x, sf, bits, group_size, num_keep_terms, axis):
        from tq_tpu_torch.kernels.tr_quantize import tr_quantize

        return tr_quantize(x, sf, bits, group_size, num_keep_terms, axis)

    @staticmethod
    def backward(ctx, grad):
        # sf's zero only where autograd asks for it: None is autograd's
        # zero and costs no launch.
        g_sf = torch.zeros((), device=grad.device) \
            if ctx.needs_input_grad[1] else None
        return grad, g_sf, None, None, None, None


def term_reveal_st(x: torch.Tensor, sf, bits: int, group_size: int = 1,
                   num_keep_terms: int = 8, axis: int = 1) -> torch.Tensor:
    """:func:`term_reveal` with a straight-through gradient (d out / d x
    is the identity, ``sf`` gets none), for quantization-aware training.

    ``sf``: a float32 0-d tensor on ``x``'s device (the kernel reads it
    from device memory, so a scale computed on the device costs no host
    sync); anything else is converted by :func:`as_scale`.
    """
    return _StraightThrough.apply(x, as_scale(sf, x.device), bits,
                                  group_size, num_keep_terms, axis)
