"""Deterministic synthetic stand-ins for MNIST, ImageNet and Wikitext-2
(no downloads).

Numpy copies of ``tq_tpu.data.synthetic``'s ``synthetic_mnist``,
``synthetic_imagenet_batch`` and ``synthetic_tokens``: the same seed gives
byte-identical arrays, so the two packages evaluate on the same data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_mnist", "synthetic_imagenet_batch", "synthetic_tokens"]


def synthetic_mnist(num_train: int = 60000, num_test: int = 10000,
                    seed: int = 1234):
    """MNIST-shaped 10-class data an MLP can learn to high accuracy.

    Each class is a smooth random 28x28 template; samples are
    template * brightness + pixel noise, normalized with the MNIST
    statistics (0.1307, 0.3081).  Returns ((x_train, y_train),
    (x_test, y_test)) as float32 NCHW / int32.
    """
    rng = np.random.default_rng(seed)
    freq = rng.normal(size=(10, 7, 7))
    templates = np.kron(freq, np.ones((4, 4)))  # (10, 28, 28)
    templates = (templates - templates.min()) / np.ptp(templates)

    def make(n, split_seed):
        r = np.random.default_rng(split_seed)
        y = r.integers(0, 10, size=n).astype(np.int32)
        bright = r.uniform(0.6, 1.0, size=(n, 1, 1)).astype(np.float32)
        x = templates[y] * bright + r.normal(0, 0.25, (n, 28, 28))
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        x = (x - 0.1307) / 0.3081
        return x[:, None, :, :], y

    return make(num_train, seed + 1), make(num_test, seed + 2)


def synthetic_imagenet_batch(batch: int, size: int = 224, seed: int = 0):
    """Normalized NHWC float32 image batch with int32 labels in [0, 1000)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 1000, size=batch).astype(np.int32)
    return x, y


def synthetic_tokens(vocab: int = 33278, length: int = 200000,
                     seed: int = 7) -> np.ndarray:
    """Zipf-distributed int32 token stream with Wikitext-2's vocab size."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(vocab, size=length, p=p).astype(np.int32)
