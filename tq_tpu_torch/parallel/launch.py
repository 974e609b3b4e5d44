"""Run a function on N local ranks of one process group.

The JAX package has one controller over many devices (in tests, eight
virtual CPU devices from ``--xla_force_host_platform_device_count=8``).
Here each rank is a process: :func:`run` spawns ``world`` of them (the
``spawn`` start method), joins them into one group over a ``file://``
rendezvous in a fresh temporary directory (no port to race for when
several test workers launch at once), calls ``fn(*args)`` in each and
returns rank 0's result.  Every rank turns TF32 off and takes its share
of the CPU cores for torch's threads; a CUDA rank takes card ``rank %
device_count``.  The CUDA kernels are built in the calling
process first, so that the ranks load the library and never race to
compile it.

The ranks are killed when ``timeout`` seconds pass or when one of them
fails, and :func:`run` raises: a hung rendezvous or collective costs one
call, not the caller's whole time.  ``fn`` and ``args`` are pickled (a
module-level function and plain data).

:func:`run_ranks` is the entry of a script that runs either way: under
``torchrun`` (which starts the ranks and sets ``RANK`` and
``WORLD_SIZE``) it joins torchrun's group, else it starts ``--world``
ranks through :func:`run`.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run", "run_ranks", "backend_for", "local_world_size"]


def backend_for(device, local_world: int) -> str:
    """NCCL for CUDA ranks each on a card of its own, else gloo (the CPU,
    or more ranks on this host than it has cards).  ``local_world``: the
    ranks on this host (:func:`local_world_size`)."""
    if torch.device(device).type == "cuda" and (
            local_world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def local_world_size(world: int) -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` where a launcher
    (``torchrun``) set it, else ``world`` (every rank here)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _in_group(fn, args, backend, local_rank, local_world, **init):
    """``fn(*args)`` as one rank: TF32 off, this rank's share of the
    host's CPU cores for torch's threads, card ``local_rank %
    device_count``, the group joined (``init``: ``init_process_group``'s
    keywords) and left again."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, **init)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, backend, init_file, timeout, fn, args, results):
    try:
        out = _in_group(fn, args, backend, rank, world,
                        init_method=f"file://{init_file}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _failures(results, world: int, rank: int, value: str,
              grace: float = 2.0) -> str:
    """The failing ranks' tracebacks: the first, and whatever others
    arrive within ``grace`` seconds (a rank whose peer died fails too, and
    its report may come first)."""
    failed = [(rank, value)]
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            r, status, v = results.get(
                timeout=max(0.01, end - time.monotonic()))
        except queue_mod.Empty:
            break
        if status == "error":
            failed.append((r, v))
    return "\n".join(f"rank {r} of {world} failed:\n{v}" for r, v in failed)


def run(fn, world: int, args=(), backend: str = "gloo",
        timeout: float = 600.0):
    """``fn(*args)`` on ``world`` new ranks joined over ``backend``
    ("gloo" or "nccl"); rank 0's return value.  Raises
    ``RuntimeError`` (with the failing rank's traceback) if a rank fails
    and ``TimeoutError`` after ``timeout`` seconds; either way every rank
    is gone when it returns."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if torch.cuda.is_available():
        from tq_tpu_torch.kernels import _build

        _build.load()
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tq_launch_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, os.path.join(tmp, "rdv"),
                               timeout, fn, args, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        done, out = set(), None
        while len(done) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - done)} of "
                        f"{world} still running after {timeout} s")
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} and no result")
                continue
            if status == "error":
                raise RuntimeError(_failures(results, world, rank, value))
            done.add(rank)
            if rank == 0:
                out = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _under_torchrun() -> bool:
    """Whether ``torchrun`` (or another ``env://`` launcher) started this
    process as one rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def run_ranks(fn, args=(), world: int = 1, device="cuda",
              timeout: float = 600.0):
    """``fn(*args)`` on every rank, over :func:`backend_for` ``device``;
    rank 0's result (None on the other ranks of a torchrun group).  Under
    ``torchrun`` this process is one rank of its group (``env://``);
    otherwise :func:`run` starts ``world`` ranks here."""
    if _under_torchrun():
        local = local_world_size(int(os.environ["WORLD_SIZE"]))
        out = _in_group(fn, args, backend_for(device, local),
                        int(os.environ.get("LOCAL_RANK", 0)), local,
                        init_method="env://")
        return out if int(os.environ["RANK"]) == 0 else None
    return run(fn, world, args, backend_for(device, world), timeout)
