"""Multi-process initialization and per-rank data feeding.

Port of ``tq_tpu.parallel.multihost``.  The JAX package joins hosts with
``jax.distributed.initialize`` and a global mesh over every host's
devices, each host feeding its local part of the batch.  Here a process
is one device: :func:`initialize` joins the default process group,
:func:`global_mesh` lays every rank out as ('data', 'model'), and each
rank feeds the rows of its data index (:func:`host_local_batch`).  One
process without a group is the degenerate case of
:func:`scaling_report`'s counts.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from tq_tpu_torch.parallel._compat import axis_size, device
from tq_tpu_torch.parallel.launch import backend_for, local_world_size
from tq_tpu_torch.parallel.mesh import make_mesh

__all__ = ["initialize", "global_mesh", "host_local_batch", "scaling_report"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """``torch.distributed.init_process_group`` when ``num_processes > 1``
    (a no-op otherwise, as the JAX wrapper is single-host), over
    :func:`~tq_tpu_torch.parallel.launch.backend_for`: NCCL when this
    host has a card for each of its processes
    (:func:`~tq_tpu_torch.parallel.launch.local_world_size`), else gloo.
    ``coordinator_address``: ``host:port`` (TCP), any init-method URL
    (``file://...``), or None: ``env://``, the rendezvous ``torchrun``
    sets up (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``),
    the port's counterpart of JAX's cluster discovery.  ``process_id``
    None leaves the rank to the rendezvous."""
    if num_processes is None or num_processes <= 1:
        return
    backend = backend_for("cuda" if torch.cuda.is_available() else "cpu",
                          local_world_size(num_processes))
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    given = {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend, init_method=url,
                            **{k: v for k, v in given.items()
                               if v is not None})


def global_mesh(n_model: int = 1, device="cuda"):
    """('data', 'model') mesh over every rank of every process; 'model'
    takes consecutive ranks (one host's cards when ranks are numbered by
    host), 'data' spans the rest."""
    return make_mesh(None, n_model, device=device)


def host_local_batch(mesh, x_local) -> torch.Tensor:
    """This rank's part of the global 'data'-sharded batch: ``x_local``,
    the rows of this rank's data index, on its device.  Gathered over
    'data' in rank order they are the global batch."""
    return torch.as_tensor(x_local).to(device(mesh))


def scaling_report(step_fn, make_batch, mesh, iters: int = 10) -> dict:
    """Throughput (global items/s) of ``step_fn`` on this rank's part of
    the batch, timed on the host clock ending in a synchronize; used to
    compare 1-device, 1-host and N-host runs."""
    x = host_local_batch(mesh, make_batch())

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    step_fn(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(x)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {
        "items_per_s": x.shape[0] * axis_size(mesh, "data") / dt,
        "n_devices": mesh.size(),
        "n_processes": dist.get_world_size() if dist.is_initialized() else 1,
    }
