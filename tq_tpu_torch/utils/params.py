"""Carry a JAX-package parameter tree over to the port."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree, device):
    """A JAX-package parameter tree of numpy arrays (what
    ``tq_tpu.utils.checkpoint.load_params`` returns, or ``jax.device_get``
    of live params) as the port's parameters: the same nesting, every
    leaf a tensor on ``device`` with its layout and dtype kept (dense
    weights stay (in, out); bfloat16 leaves stay bfloat16).  A
    ``PackedWeight8`` node (either package's, or one loaded from a
    checkpoint) becomes the port's
    :class:`~tq_tpu_torch.kernels.term_matmul.PackedWeight8`; tensors
    already in the port's tree move to ``device``."""
    if hasattr(tree, "_fields"):  # NamedTuple node
        if type(tree).__name__ != "PackedWeight8":
            raise KeyError(f"unknown parameter namedtuple type "
                           f"{type(tree).__name__!r}")
        from tq_tpu_torch.kernels.term_matmul import PackedWeight8

        return PackedWeight8(*(params_from_jax(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(arr, device=device)
