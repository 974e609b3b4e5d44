"""Flat-npz checkpointing for parameter/state trees.

Port of the npz half of ``tq_tpu.utils.checkpoint``, in the same file
format, so a checkpoint written by either package loads in the other:
every tree of arrays round-trips through a flat ``.npz`` keyed by
'/'-joined paths (no pickled code).  A packed-weight container
(:class:`~tq_tpu_torch.kernels.term_matmul.PackedWeight8`) keeps its type
through a ``'#nt'`` marker leaf holding the class name.  Leaves come back
as numpy arrays; :func:`tq_tpu_torch.utils.params.params_from_jax` puts
them on a device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["save_params", "load_params", "flatten_tree", "unflatten_tree"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _namedtuple_class(name: str):
    """The NamedTuple node types a checkpoint may hold, resolved by name
    (no pickled code)."""
    if name == "PackedWeight8":
        from tq_tpu_torch.kernels.term_matmul import PackedWeight8

        return PackedWeight8
    raise KeyError(f"unknown checkpointed namedtuple type {name!r}")


def flatten_tree(tree, prefix=""):
    """Tree -> {'path/to/leaf': np.ndarray}.  Lists use numeric keys; a
    None leaf is kept as a '#none' marker and a NamedTuple node as a
    '#nt' leaf naming its class."""
    out = {}
    if hasattr(tree, "_fields"):  # NamedTuple node
        out[f"{prefix}#nt"] = np.asarray(type(tree).__name__)
        for k in tree._fields:
            out.update(flatten_tree(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = _to_numpy(tree)
    return out


def unflatten_tree(flat: dict):
    """Inverse of :func:`flatten_tree` (dicts whose keys are 0..n-1 come
    back as lists, '#nt' nodes as their NamedTuple class; an unknown class
    name raises ``KeyError``)."""
    root: dict = {}
    for path, val in flat.items():
        if path.endswith("#none"):
            path, val = path[: -len("#none")], None
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if "#nt" in node:
            cls = _namedtuple_class(str(node.pop("#nt")))
            return cls(**node)
        if node and all(k.isdigit() for k in node):
            idxs = sorted(int(k) for k in node)
            if idxs == list(range(len(idxs))):
                return [node[str(i)] for i in idxs]
        return node

    return listify(root)


# The meta names save_params writes itself (read back by load_params).
RESERVED_META = frozenset({"store_dtype"})


def save_params(path: str | Path, tree, store_dtype=None, meta=None):
    """Save a tree of tensors or arrays.

    ``store_dtype=np.float16`` narrows float leaves on disk and
    :func:`load_params` widens them back to float32; a
    ``__meta__/store_dtype`` marker records which convention applies.
    ``meta``: optional {str: str} side channel, read back with
    ``load_params(with_meta=True)``; a name in :data:`RESERVED_META`
    raises ``ValueError``.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = flatten_tree(tree)
    if any(k == "__meta__" or k.startswith("__meta__/") for k in flat):
        # load_params diverts these keys into the meta dict, which would
        # strip the branch from the round-tripped tree.
        raise ValueError(
            "param tree uses the reserved '__meta__' key; rename the "
            "branch or pass the data via the meta= argument")
    reserved = RESERVED_META & set(meta or {})
    if reserved:
        # load_params reads this marker to decide how to widen floats: a
        # user value under its name would silently change that.
        raise ValueError(
            f"meta uses the reserved name(s) {sorted(reserved)}; save_params "
            "writes them itself")
    if store_dtype is not None:
        flat = {k: (v.astype(store_dtype)
                    if np.issubdtype(v.dtype, np.floating) else v)
                for k, v in flat.items()}
    flat["__meta__/store_dtype"] = np.asarray(
        np.dtype(store_dtype).name if store_dtype is not None else "none")
    for k, v in (meta or {}).items():
        flat[f"__meta__/{k}"] = np.asarray(str(v))
    np.savez(path, **flat)


def load_params(path: str | Path, with_meta: bool = False):
    """Load a :func:`save_params` checkpoint as a tree of numpy arrays.

    Narrowed floats widen back to float32; genuinely float16 leaves
    (marker 'none') keep their dtype; files without the marker widen
    float16.  ``with_meta=True`` also returns the ``meta`` dict."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = {k[len("__meta__/"):]: str(z[k])
                for k in z.files if k.startswith("__meta__/")}
        narrowed = meta.get("store_dtype", "float16")
        flat = {k: (z[k].astype(np.float32)
                    if z[k].dtype == np.float16 and narrowed == "float16"
                    else z[k])
                for k in z.files if not k.startswith("__meta__/")}
    tree = unflatten_tree(flat)
    return (tree, meta) if with_meta else tree
