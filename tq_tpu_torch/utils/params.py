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
    weights stay (in, out))."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if tree is None:
        return None
    return torch.as_tensor(np.array(tree), device=device)
