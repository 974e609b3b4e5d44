"""Load the MNIST MLP checkpoint (the loading half of
``tq_tpu.evals.train_mlp``).  Training is not ported yet: with no
checkpoint on disk :func:`load_or_train` raises."""

from __future__ import annotations

from pathlib import Path

from tq_tpu_torch.utils.checkpoint import load_params
from tq_tpu_torch.utils.params import params_from_jax

__all__ = ["load_or_train"]


def load_or_train(path: str = "pretrained/mnist_mlp.npz", device="cuda"):
    """The MLP's parameters from the npz checkpoint at ``path``, as
    tensors on ``device``."""
    if not Path(path).exists():
        raise FileNotFoundError(
            f"no MLP checkpoint at {path}; training is not ported yet, "
            "train with `python -m tq_tpu.evals.train_mlp` (JAX package)")
    return params_from_jax(load_params(path), device)
