"""Fused activation term-reveal + matmul: CUDA kernel and its plain version.

Port of ``tq_tpu.kernels.term_matmul`` in its f32 mode with float32
weights: ``tr_quantize(x, sf, bits, 1, k) @ w``, with the activation tile
term-revealed as it is loaded, so the quantized activations never reach
device memory.

* On a CUDA tensor :func:`term_matmul` launches ``csrc/term_matmul.cu``
  (a tiled float32 SGEMM on CUDA cores, no TF32) and raises on what the
  kernel does not take.
* On a CPU tensor it runs :func:`term_matmul_ref`, the plain version.

The bf16 and int8 modes, integer and 9-bit packed weights and the
raw-input mode (``quantize_x=False``) are not ported yet (ROADMAP B3, B4)
and raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import torch

from tq_tpu_torch.kernels import _build
from tq_tpu_torch.kernels.tr_quantize import MAX_BITS, tr_quantize_ref
from tq_tpu_torch.ops.term_reveal import as_scale

__all__ = ["term_matmul", "term_matmul_ref"]

_TILE, _K_STEP = 64, 16  # the kernel's output tile and K step (kBM/kBN, kBK)


def term_matmul_ref(x: torch.Tensor, w: torch.Tensor, sf, bits: int = 8,
                    num_keep_terms: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`term_matmul` (f32 mode)."""
    return torch.matmul(tr_quantize_ref(x, sf, bits, 1, num_keep_terms), w)


def _check(x: torch.Tensor, w, bf16: bool, int8: bool, w_sf,
           quantize_x: bool) -> None:
    if bf16 or int8:
        raise NotImplementedError(
            "term_matmul: the bf16 and int8 modes are not ported yet "
            "(ROADMAP B3)")
    if not quantize_x:
        raise NotImplementedError(
            "term_matmul: quantize_x=False (raw-input mode) is not ported "
            "yet (ROADMAP B4)")
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            "term_matmul: packed 9-bit weights are not ported yet "
            "(ROADMAP B4)")
    if not w.dtype.is_floating_point:
        raise NotImplementedError(
            "term_matmul: integer weights are not ported yet (ROADMAP B3)")
    if w_sf is not None:
        raise ValueError("w_sf is only meaningful for integer weights")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"term_matmul takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def term_matmul(x: torch.Tensor, w, sf, bits: int = 8,
                num_keep_terms: int = 8, bf16: bool = False,
                int8: bool = False, interpret: bool | None = None,
                bm: int = 1024, bk: int = 2048, bn: int = 512, w_sf=None,
                pipeline: bool = True, bsub: int | None = None,
                quantize_x: bool = True) -> torch.Tensor:
    """``tr_quantize(x, sf, bits, 1, num_keep_terms) @ w`` in one kernel.

    Keeps the JAX signature.  ``interpret``, ``bm``, ``bk``, ``bn``,
    ``pipeline`` and ``bsub`` only tune TPU tiles and are ignored.
    Returns (M, N) float32.
    """
    del interpret, bm, bk, bn, pipeline, bsub
    _check(x, w, bf16, int8, w_sf, quantize_x)
    if not x.is_cuda:
        return term_matmul_ref(x, w, sf, bits, num_keep_terms)

    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"term_matmul kernel takes float32, got {x.dtype} "
                        f"and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"term_matmul kernel takes 1 <= bits <= {MAX_BITS}, "
                         f"got {bits}")
    M, K = x.shape
    N = w.shape[1]
    if max(M, N, K) >= 2**31 or -(-M // 64) > 65535:
        raise ValueError(f"term_matmul kernel: shape {(M, K, N)} too large")
    x, w = x.contiguous(), w.contiguous()
    sf = as_scale(sf, x.device).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel():
        splits, k_per_split = _split_k(M, N, K, x.device)
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        _build.check(_build.load().tq_term_matmul_f32(
            x.data_ptr(), w.data_ptr(), sf.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, M, N, K, bits,
            min(num_keep_terms, MAX_BITS + 1), 1.0, splits, k_per_split,
            torch.cuda.current_stream(x.device).cuda_stream),
            "tq_term_matmul_f32")
        term_matmul.launches["f32"] += 1
    return out


def _split_k(M: int, N: int, K: int, device) -> tuple[int, int]:
    """(splits, k_per_split): split K so that the kernel's 64x64 output
    tiles give about two blocks per SM; a multiple of the K step (16)."""
    tiles = -(-M // _TILE) * -(-N // _TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k_steps = -(-K // _K_STEP)
    splits = max(1, min(k_steps, -(-2 * sms // tiles)))
    k_per_split = max(1, -(-k_steps // splits)) * _K_STEP
    return max(1, -(-K // k_per_split)), k_per_split


term_matmul.launches = {"f32": 0}
