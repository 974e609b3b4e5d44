"""The collectives of the ``parallel`` package on ``torch.distributed``.

Port of ``tq_tpu.parallel._compat``, the one module that knows the
backends.  The JAX package's ``shard_map`` bodies name their collectives
(``psum``, ``ppermute``, ``axis_index``) and GSPMD inserts the rest; here
each is an explicit operation over one dimension of a
``torch.distributed.device_mesh.DeviceMesh`` (``"data"``, ``"model"`` or
``"stage"``), on the process group of that dimension.

* NCCL takes CUDA tensors.  Over a group of one rank nothing is sent.
* gloo takes CPU tensors; its CUDA support depends on the operation and
  the build (its point-to-point operations take none), so every gloo
  operation on a CUDA tensor is staged through pinned host memory: the
  tensor is copied out, the operation runs on the copy and the result is
  copied back.  :data:`staged` counts the bytes copied each way.  Staging
  moves bytes only: a staged ``psum`` gathers the parts and sums them on
  the card, so no product or reduction of a CUDA mesh runs on the CPU.

``ppermute`` and ``psum`` have differentiable forms for the pipeline and
the tensor-parallel layers (:class:`PPermute`, :class:`ReduceForward`,
:class:`ReduceBackward`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["psum", "ppermute", "ppermute_start", "all_gather", "axis_index",
           "axis_size", "device", "staged", "PPermute", "ReduceForward",
           "ReduceBackward"]

# Bytes copied between a CUDA tensor and pinned host memory for gloo, each
# direction (``to_host``, ``to_device``), and the operations staged.
staged = {"to_host": 0, "to_device": 0, "ops": 0}


def axis_size(mesh, dim: str) -> int:
    """Ranks along mesh dimension ``dim``."""
    return mesh[dim].size()


def axis_index(mesh, dim: str) -> int:
    """This rank's index along mesh dimension ``dim``
    (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(dim)


def device(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    staged["to_host"] += t.numel() * t.element_size()
    return host


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    staged["to_device"] += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=False)


def psum(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Sum of ``x`` over mesh dimension ``dim``, on every rank of it
    (``jax.lax.psum``); ``x`` is not changed."""
    if axis_size(mesh, dim) == 1:
        return x
    group = mesh.get_group(dim)
    if _staged(x, group):
        # gloo moves the copies; the sum runs on the card, in rank order.
        return all_gather(x[None], mesh, dim).sum(dim=0)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, mesh, dim: str, axis: int = 0
               ) -> torch.Tensor:
    """The shards of every rank along mesh dimension ``dim``, concatenated
    in rank order along tensor axis ``axis``; every shard has ``x``'s
    shape."""
    n = axis_size(mesh, dim)
    if n == 1:
        return x
    group = mesh.get_group(dim)
    src = x.detach().contiguous()
    if _staged(src, group):
        staged["ops"] += 1
        host = _to_host(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return _to_device(torch.cat(parts, dim=axis), x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis)


class _Pending:
    """A ``ppermute`` in flight: :meth:`wait` returns what arrived.  Holds
    the send buffer until then."""

    def __init__(self, works, send, recv, out):
        self._works, self._send = works, send
        self._recv, self._out = recv, out

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._send = None
        if self._recv is None:
            return self._out
        if self._recv.device != self._out.device:  # staged through the host
            return _to_device(self._recv, self._out)
        return self._recv


def ppermute_start(x: torch.Tensor, mesh, dim: str, perm) -> _Pending:
    """Start ``jax.lax.ppermute``: send ``x`` along the (source, dest)
    pairs ``perm`` of indices on mesh dimension ``dim``; a rank that is no
    pair's destination receives zeros.  The sends and receives are
    asynchronous; the result's :meth:`~_Pending.wait` finishes them."""
    n = axis_size(mesh, dim)
    me = axis_index(mesh, dim)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1 or any(
            not 0 <= i < n for pair in perm for i in pair):
        raise ValueError(f"ppermute: {perm} is not a permutation of "
                         f"indices 0..{n - 1}")
    zeros = torch.zeros_like(x)
    if n == 1:
        return _Pending([], None, None, x.detach() if src else zeros)
    group = mesh.get_group(dim)
    send = x.detach().contiguous()
    if _staged(send, group):
        staged["ops"] += 1
        send = _to_host(send)
    recv = torch.empty_like(send) if src else None
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src[0]), group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, send, recv, zeros)


def ppermute(x: torch.Tensor, mesh, dim: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: :func:`ppermute_start` and wait."""
    return ppermute_start(x, mesh, dim, perm).wait()


class PPermute(torch.autograd.Function):
    """Differentiable :func:`ppermute`: the forward sends along ``perm``,
    the backward sends the gradient the other way (the inverse pairs), as
    JAX's transpose of ``ppermute`` does."""

    @staticmethod
    def forward(ctx, x, mesh, dim, perm):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.inverse = [(d, s) for s, d in perm]
        return ppermute(x, mesh, dim, perm)

    @staticmethod
    def backward(ctx, grad):
        return ppermute(grad, ctx.mesh, ctx.dim, ctx.inverse), None, None, None


class ReduceForward(torch.autograd.Function):
    """:func:`psum` in the forward, the identity in the backward: the sum
    of partial results (a row-parallel product, the pipeline's drain
    buffer) whose replicated result every rank differentiates alone, so
    each rank's own partial takes the gradient of the one result."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        out = psum(x, mesh, dim)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class ReduceBackward(torch.autograd.Function):
    """The identity in the forward, :func:`psum` of the gradient in the
    backward: a replicated input that each rank feeds to its own shard of
    a column-parallel product."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.dim), None, None
