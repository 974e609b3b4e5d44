"""MNIST loader: real idx files when available, synthetic fallback.

A numpy copy of ``tq_tpu.data.mnist``: the raw idx(.gz) files are parsed
from ``data_dir`` or ``$TQ_DATA_DIR/MNIST/raw``; with no data on disk the
loader falls back to :func:`tq_tpu_torch.data.synthetic.synthetic_mnist`.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from tq_tpu_torch.data.synthetic import synthetic_mnist

__all__ = ["load_mnist", "read_idx"]

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def read_idx(path: Path) -> np.ndarray:
    """Parse an idx file (optionally gzipped)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"bad idx magic in {path}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {
            0x08: np.uint8,
            0x09: np.int8,
            0x0B: np.int16,
            0x0C: np.int32,
            0x0D: np.float32,
            0x0E: np.float64,
        }[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def _find(root: Path, stem: str) -> Path | None:
    for cand in (root / stem, root / (stem + ".gz")):
        if cand.exists():
            return cand
    return None


def _normalize(x: np.ndarray) -> np.ndarray:
    return ((x - 0.1307) / 0.3081)[:, None, :, :]


def load_mnist(data_dir: str | None = None):
    """((x_train, y_train), (x_test, y_test), source); NCHW float32,
    normalized; ``source`` is 'real' or 'synthetic'."""
    roots = []
    if data_dir:
        roots += [Path(data_dir), Path(data_dir) / "MNIST" / "raw"]
    env = os.environ.get("TQ_DATA_DIR")
    if env:
        roots += [Path(env) / "MNIST" / "raw", Path(env)]
    for root in roots:
        paths = {k: _find(root, v) for k, v in _FILES.items()}
        if all(paths.values()):
            xtr = read_idx(paths["train_images"]).astype(np.float32) / 255.0
            xte = read_idx(paths["test_images"]).astype(np.float32) / 255.0
            return (
                (_normalize(xtr),
                 read_idx(paths["train_labels"]).astype(np.int32)),
                (_normalize(xte),
                 read_idx(paths["test_labels"]).astype(np.int32)),
                "real",
            )
    train, test = synthetic_mnist()
    return train, test, "synthetic"
