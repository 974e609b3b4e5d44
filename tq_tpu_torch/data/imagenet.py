"""ImageNet validation loader, NHWC float32 batches.

Port of ``tq_tpu.data.imagenet``.  Layout: ``<root>/imagenet/val/<wnid>/
*.JPEG`` (ImageFolder: class index = sorted wnid order).  Transforms:
resize the shorter side to 256 and center-crop 224, bilinear (CNNs), or
resize to the image size and center-crop, bicubic (EfficientNet); then
normalize with the ImageNet statistics.  PIL is imported only when an
image is decoded, so the synthetic path never needs it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

__all__ = ["find_imagenet_val", "iter_imagenet_val", "load_image"]


def find_imagenet_val(data_dir: str | None = None) -> Path | None:
    """The first of ``data_dir``, ``data_dir/imagenet/val``,
    ``$TQ_DATA_DIR/imagenet/val`` and ``$TQ_DATA_DIR`` that holds class
    directories, else None."""
    roots = []
    if data_dir:
        roots += [Path(data_dir), Path(data_dir) / "imagenet" / "val"]
    env = os.environ.get("TQ_DATA_DIR")
    if env:
        roots += [Path(env) / "imagenet" / "val", Path(env)]
    for root in roots:
        if root.is_dir() and any(p.is_dir() for p in root.iterdir()):
            return root
    return None


def load_image(path, image_size: int = 224,
               bicubic: bool = False) -> np.ndarray:
    """Resize shorter side -> center crop -> normalize; HWC float32."""
    from PIL import Image

    resample = Image.BICUBIC if bicubic else Image.BILINEAR
    img = Image.open(path).convert("RGB")
    w, h = img.size
    short = 256 if not bicubic else image_size
    if w < h:
        nw, nh = short, round(h * short / w)
    else:
        nw, nh = round(w * short / h), short
    img = img.resize((nw, nh), resample)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    x = np.asarray(img, np.float32) / 255.0
    return (x - MEAN) / STD


def iter_imagenet_val(root: Path, batch_size: int = 64,
                      image_size: int = 224, bicubic: bool = False,
                      limit: int | None = None):
    """Yield (x_NHWC, y) batches in deterministic ImageFolder order."""
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for f in sorted((root / c).iterdir()):
            if f.suffix.lower() in (".jpeg", ".jpg", ".png"):
                samples.append((f, cls_idx[c]))
    if limit:
        samples = samples[:limit]
    for i in range(0, len(samples), batch_size):
        chunk = samples[i:i + batch_size]
        x = np.stack([load_image(p, image_size, bicubic) for p, _ in chunk])
        y = np.array([label for _, label in chunk], np.int32)
        yield x, y
