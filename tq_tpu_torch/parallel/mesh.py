"""Device-mesh construction for data- and tensor-parallel execution.

Port of ``tq_tpu.parallel.mesh``.  The JAX package builds one
``jax.sharding.Mesh`` over a single controller's devices with the named
axes ``'data'`` (batch sharding) and ``'model'`` (weight sharding).  Here
every device is one process: the mesh's "devices" are the ranks of the
default process group (started by :mod:`~tq_tpu_torch.parallel.launch`,
:func:`~tq_tpu_torch.parallel.multihost.initialize` or ``torchrun``),
laid out as a ``torch.distributed.device_mesh.DeviceMesh`` of shape
``(n_data, n_model)`` with the same axis names.  Its collectives are
explicit (:mod:`~tq_tpu_torch.parallel._compat`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tq_tpu_torch.utils.device import resolve_device

__all__ = ["make_mesh", "local_mesh", "mesh_over"]


def _world(devices) -> list[int]:
    if devices is not None:
        return list(devices)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with "
            "tq_tpu_torch.parallel.launch.run, multihost.initialize or "
            "torchrun before building a mesh")
    return list(range(dist.get_world_size()))


def mesh_over(ranks, shape: tuple[int, int], names: tuple[str, str],
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the first
    ``shape[0] * shape[1]`` of ``ranks``, on ``device``'s type (raises if
    it names CUDA and there is none)."""
    device = resolve_device(device)
    grid = torch.tensor(ranks[: shape[0] * shape[1]]).reshape(shape)
    return DeviceMesh(device.type, grid, mesh_dim_names=names)


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device="cuda") -> DeviceMesh:
    """Build a ('data', 'model') mesh over the given ranks (default: every
    rank of the default group), on ``device`` ("cuda" unless the caller
    asks for "cpu"; raises without a GPU).

    With ``n_data=None`` the data axis absorbs every rank not used by the
    model axis.  A mesh smaller than the world leaves the other ranks out
    (as the JAX package leaves devices out).
    """
    resolve_device(device)
    ranks = _world(devices)
    n = len(ranks)
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {n}"
        )
    return mesh_over(ranks, (n_data, n_model), ("data", "model"), device)


def local_mesh(max_devices: int | None = None, device="cuda") -> DeviceMesh:
    """A pure data-parallel mesh over the ranks (one rank: a 1x1 mesh).

    Every entry point works unchanged from 1 rank to many.
    """
    resolve_device(device)
    ranks = _world(None)
    if max_devices is not None:
        ranks = ranks[:max_devices]
    return make_mesh(n_data=len(ranks), n_model=1, devices=ranks,
                     device=device)
