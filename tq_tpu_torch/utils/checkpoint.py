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

__all__ = ["save_params", "load_params", "flatten_tree", "unflatten_tree",
           "save_params_orbax", "load_params_orbax"]


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


def flatten_tree(tree, prefix="", leaf=_to_numpy):
    """Tree -> {'path/to/leaf': np.ndarray} (``leaf`` maps each leaf;
    default: to numpy).  Lists use numeric keys; a None leaf is kept as a
    '#none' marker and a NamedTuple node as a '#nt' leaf naming its
    class."""
    out = {}
    if hasattr(tree, "_fields"):  # NamedTuple node
        out[f"{prefix}#nt"] = np.asarray(type(tree).__name__)
        for k in tree._fields:
            out.update(flatten_tree(getattr(tree, k), f"{prefix}{k}/", leaf))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/", leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/", leaf))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = leaf(tree)
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


def _dcp_leaves(tree, mesh, specs):
    """``tree``'s tensors by path for ``torch.distributed.checkpoint``:
    with ``mesh``, each leaf a DTensor over this rank's shard (its
    placements from ``specs`` by
    :func:`~tq_tpu_torch.parallel.sharding.spec_of`, as ``shard_pytree``
    cut it: a dimension named there is ``Shard``, the rest ``Replicate``);
    the markers of :func:`flatten_tree` as strings."""
    from tq_tpu_torch.parallel.sharding import spec_of

    flat = flatten_tree(tree, leaf=torch.as_tensor)
    out = {}
    for path, v in flat.items():
        if path.endswith("#nt") or path.endswith("#none"):
            out[path] = str(v)
        elif mesh is None:
            out[path] = v
        else:
            out[path] = _as_dtensor(v, mesh, spec_of(specs, path))
    return out


def _as_dtensor(t, mesh, spec):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    for i, dim in enumerate(spec):
        if dim is not None:
            placements[mesh.mesh_dim_names.index(dim)] = Shard(i)
    return DTensor.from_local(t, mesh, placements, run_check=False)


def save_params_orbax(path: str | Path, tree, mesh=None, specs=None):
    """The sharded checkpoint, on ``torch.distributed.checkpoint`` (the
    JAX package's pair of this name writes with orbax, a JAX library).

    Without ``mesh``: the tree's tensors, written by one process.  With
    ``mesh`` and ``specs``: ``tree`` holds this rank's shards (as
    :func:`~tq_tpu_torch.parallel.sharding.shard_pytree` gives them) and
    every rank calls this; each writes its own shards, a replicated leaf
    once.
    """
    import torch.distributed.checkpoint as dcp

    dcp.save(_dcp_leaves(tree, mesh, specs),
             checkpoint_id=str(Path(path).resolve()))


def load_params_orbax(path: str | Path, like=None, mesh=None, specs=None):
    """Read a :func:`save_params_orbax` checkpoint.

    ``like``: a tree of the result's structure, shapes and dtypes (with
    ``mesh`` and ``specs``: this rank's shards), into whose copy the
    stored values are read; each rank reads only its shards.  Without
    ``like``, one process reads the whole tree (nested dicts and lists,
    NamedTuple nodes restored) as CPU tensors.
    """
    import torch.distributed.checkpoint as dcp

    path = str(Path(path).resolve())
    if like is None:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        state = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                     if hasattr(m, "size") else "")
                 for k, m in meta.items()}
    else:
        state = _dcp_leaves(_tree_clone(like), mesh, specs)
    dcp.load(state, checkpoint_id=path)
    flat = {k: (v.to_local() if hasattr(v, "to_local") else v)
            for k, v in state.items()}
    return unflatten_tree(flat)


def _tree_clone(tree):
    """A copy of a tree of tensors (NamedTuple, dict, list nodes kept)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_clone(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_clone(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree
