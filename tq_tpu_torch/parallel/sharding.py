"""Sharding rules: which tensor dimension goes to which mesh dimension.

Port of ``tq_tpu.parallel.sharding``.  A spec is a tuple with one entry
per tensor dimension, a mesh dimension's name or None, as a JAX
``PartitionSpec`` is: ``(None, "model")`` splits a (K, N) weight's
columns over the 'model' ranks, ``()`` replicates.  Dense stacks follow
the two-matmul pattern: odd layers shard the output features, even layers
the input features, so the pair needs one sum over 'model' and the
activations stay sharded in between.  Batches shard on 'data'.

Where the JAX package places global arrays with ``NamedSharding`` and
GSPMD keeps each device's part, here :func:`shard_pytree` gives each rank
only its local shard, copied contiguous once, on the mesh's device.
"""

from __future__ import annotations

import torch

from tq_tpu_torch.parallel._compat import axis_index, axis_size, device

__all__ = ["P", "mlp_param_specs", "batch_spec", "cnn_param_specs",
           "shard", "shard_batch", "shard_pytree", "spec_of"]


def P(*dims) -> tuple:
    """A spec: one mesh dimension name (or None) per tensor dimension."""
    return tuple(dims)


def mlp_param_specs(layer_names=("fc1", "fc2", "fc3")) -> dict:
    """Megatron-style specs for the MLP parameter tree.

    fc1 column-parallel (shard out features), fc2 row-parallel (shard in
    features, output summed over 'model'), the final logits layer
    replicated.  Leaves without a spec ('w_sf') are replicated.
    """
    specs = {}
    for i, name in enumerate(layer_names):
        last = i == len(layer_names) - 1
        if last:
            w, b = P(None, None), P(None)
        elif i % 2 == 0:
            w, b = P(None, "model"), P("model")
        else:
            w, b = P("model", None), P(None)
        specs[name] = {"w": w, "b": b}
    return specs


def batch_spec() -> tuple:
    """Leading-axis batch sharding over the 'data' mesh axis."""
    return P("data")


def cnn_param_specs(params) -> dict:
    """TP specs for a CNN param tree: conv kernels (HWIO) shard their
    output channels over 'model', dense layers their output features;
    BN / biases / scalars replicate.  The forward that runs on these
    shards is :func:`~tq_tpu_torch.parallel.tp.make_tp_cnn_apply`."""
    specs = {}
    for name, leaves in params.items():
        if not isinstance(leaves, dict):
            continue
        entry = {}
        for key, leaf in leaves.items():
            ndim = getattr(leaf, "ndim", 0)
            if key == "w" and ndim == 4:
                entry[key] = P(None, None, None, "model")
            elif key == "w" and ndim == 2:
                entry[key] = P(None, "model")
            else:
                entry[key] = P()
        specs[name] = entry
    return specs


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the global tensor ``t`` under ``spec`` (None
    or ``()`` replicates), contiguous, on the mesh's device.  A dimension
    must divide evenly over its mesh dimension."""
    t = torch.as_tensor(t)
    for i, dim in enumerate(spec or ()):
        if dim is None:
            continue
        n = axis_size(mesh, dim)
        if t.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(t.shape)} does not "
                             f"divide over the {n} ranks of '{dim}'")
        size = t.shape[i] // n
        t = t.narrow(i, axis_index(mesh, dim) * size, size)
    return t.to(device(mesh)).contiguous()


def shard_batch(x, mesh, axis: int = 0) -> torch.Tensor:
    """This rank's rows of ``x`` along ``axis`` over 'data', or all of
    ``x`` (replicated) when the batch does not divide the axis, e.g. a
    tail batch.  Time-major LM streams are (T, B): ``axis=1``."""
    x = torch.as_tensor(x)
    if x.shape[axis] % axis_size(mesh, "data") == 0:
        return shard(x, P(*([None] * axis + ["data"])), mesh)
    return shard(x, (), mesh)


def spec_of(specs, path) -> tuple:
    """The spec of the leaf at ``path`` (its keys from the root, or the
    'a/b' string of a checkpoint) under ``specs``, which may be a prefix
    tree: () (replicated) where none names it.  A
    :class:`~tq_tpu_torch.kernels.term_matmul.PackedWeight8` takes the
    spec of its own path: its ``lo`` and ``signs`` planes split under it,
    its ``w_sf`` replicates."""
    if isinstance(path, str):
        path = path.split("/")
    spec = specs
    for i, key in enumerate(path):
        if isinstance(spec, dict) and key in spec:
            spec = spec[key]
        elif (isinstance(spec, tuple) and i == len(path) - 1
              and key in ("lo", "signs")):
            return spec
        else:
            return ()
    return spec if isinstance(spec, tuple) else ()


def shard_pytree(tree, specs, mesh, _path=()):
    """Each rank's shards of ``tree`` under per-leaf specs
    (:func:`spec_of`: leaves without a spec, e.g. scalar 'w_sf' or
    histogram state, are replicated; a PackedWeight8's planes split under
    its path's spec)."""
    if hasattr(tree, "_fields"):  # NamedTuple node: PackedWeight8
        return type(tree)(*(shard_pytree(v, specs, mesh, _path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: shard_pytree(v, specs, mesh, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_pytree(v, specs, mesh, _path + (i,))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    try:
        return shard(tree, spec_of(specs, _path), mesh)
    except ValueError as e:  # name the leaf that does not divide
        raise ValueError(f"{'/'.join(map(str, _path))}: {e}") from None
