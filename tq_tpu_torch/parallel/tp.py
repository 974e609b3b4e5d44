"""Tensor-parallel term matmul: the fused kernel on each rank's shard.

Port of ``tq_tpu.parallel.tp``.  Weights are sharded over the 'model'
mesh dimension and every rank runs the port's ``term_matmul`` on its own
shard (the streaming kernel for M <= 8, above it ``mma`` in the f32 mode
and ``mma_lp`` in the bf16 and int8 modes), with explicit collectives
around it where the JAX package's ``shard_map`` bodies have them:

  * column-parallel: w sharded on output features, no communication
    (activations replicated in, outputs stay sharded);
  * row-parallel: w sharded on input features, x sharded to match, one
    sum over 'model' after the local product.

Every function takes this rank's shards (see
:func:`~tq_tpu_torch.parallel.sharding.shard`) and returns this rank's
part of the result, as the JAX ``out_specs`` say: N-sharded for the
column-parallel layouts and the ring, replicated for row-parallel.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tq_tpu_torch.kernels.term_matmul import PackedWeight8, term_matmul
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.parallel._compat import (all_gather, axis_index, axis_size,
                                           psum, ppermute_start)

__all__ = ["tp_term_matmul_col", "tp_term_matmul_row",
           "tp_term_matmul_overlap", "tp_term_matmul_col_packed",
           "TPQuantCtx", "make_tp_cnn_apply"]


def _local_mm(x, w, sf, bits, num_keep_terms, w_sf, int8, bf16):
    """The per-shard product; threads ``w_sf`` only for integer weights
    (1.0 when it is None, as the JAX package's ``_wsf_scalar``)."""
    w_is_int = not (w.dtype.is_floating_point or w.dtype.is_complex)
    return term_matmul(x, w, sf, bits, num_keep_terms, int8=int8, bf16=bf16,
                       w_sf=(1.0 if w_sf is None else w_sf) if w_is_int
                       else None)


def tp_term_matmul_col(x, w, sf, bits: int, num_keep_terms: int, mesh,
                       w_sf=None, int8: bool = False, bf16: bool = False):
    """Column-parallel: ``w`` is this rank's (K, N/n) column shard and
    ``x`` (M, K) replicated; returns this rank's (M, N/n) output columns.

    Zero collectives; the activation quantization is recomputed on every
    rank (cheap next to the product, and it keeps the kernel fused).
    """
    del mesh  # no collective: the shard is the whole of this rank's work
    return _local_mm(x, w, sf, bits, num_keep_terms, w_sf, int8, bf16)


def tp_term_matmul_col_packed(x, wp: PackedWeight8, sf, bits: int,
                              num_keep_terms: int, mesh, bf16: bool = True,
                              quantize_x: bool = True):
    """Column-parallel product over this rank's N-shard of a 9-bit pack.

    ``wp``'s ``lo`` and ``signs`` planes are this rank's columns (see
    :func:`~tq_tpu_torch.parallel.sharding.shard_pytree`), its ``w_sf``
    replicated: each rank streams 1/n of the 1.125-bytes-a-weight planes
    and decodes them in the kernel.  Zero collectives; returns this
    rank's (M, N/n) columns.  ``quantize_x=False`` serves raw-input
    layers (the reference layer's forward) the same way.
    """
    del mesh
    return term_matmul(x, wp, sf, bits, num_keep_terms, bf16=bf16,
                       quantize_x=quantize_x)


def tp_term_matmul_overlap(x, w, sf, bits: int, num_keep_terms: int, mesh,
                           w_sf=None, int8: bool = False, bf16: bool = False):
    """Collective matmul: a ring all-gather of x overlapped with compute.

    ``x`` is this rank's (M, K/n) block of columns, ``w`` its (K, N/n)
    output columns with every K row.  Instead of gathering x up front,
    the K-blocks travel a ring: each step multiplies the block it holds
    against the matching rows of ``w`` while the block is already on its
    way to the next rank (asynchronous sends and receives, started
    before the product and finished after it).  Returns this rank's (M,
    N/n) output columns.
    """
    n = axis_size(mesh, "model")
    me = axis_index(mesh, "model")
    kn = x.shape[1]  # K / n
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    ring = [(i, (i - 1) % n) for i in range(n)]
    blk = x
    for step in range(n):
        src = (me + step) % n  # owner of the block currently held
        pending = (ppermute_start(blk, mesh, "model", ring)
                   if step < n - 1 else None)
        acc = acc + _local_mm(blk, w[src * kn:(src + 1) * kn], sf, bits,
                              num_keep_terms, w_sf, int8, bf16)
        if pending is not None:
            blk = pending.wait()
    return acc


def tp_term_matmul_row(x, w, sf, bits: int, num_keep_terms: int, mesh,
                       w_sf=None, int8: bool = False, bf16: bool = False):
    """Row-parallel: ``w`` is this rank's (K/n, N) row shard and ``x`` its
    (M, K/n) block of columns; one sum over 'model' returns the (M, N)
    result on every rank.

    Activations are quantized per element, so quantizing each K-shard
    alone is exactly the unsharded quantization; only the K sum is taken
    in another order.
    """
    part = _local_mm(x, w, sf, bits, num_keep_terms, w_sf, int8, bf16)
    return psum(part, mesh, "model")


@dataclasses.dataclass
class TPQuantCtx(QuantCtx):
    """A QuantCtx whose convs and dense layers run column-parallel over
    the 'model' dimension of ``mesh``: the CNN forward of the JAX
    package's GSPMD partitioning under ``cnn_param_specs``, with the
    collectives written out.

    Each site gets this rank's shard of the weight (output channels of an
    HWIO kernel, output features of an (in, out) one, as
    :func:`~tq_tpu_torch.parallel.sharding.shard_pytree` cuts them) and
    the replicated input: a converted conv reveals the whole input (B1),
    then multiplies it by the shard; the rank's slice of the replicated
    bias is added and the output channels are gathered over 'model' in
    rank order, so BN, the activations, residual adds and pools see whole
    tensors and the model's own code runs unchanged.  A grouped conv
    reads the input channels of this rank's groups (``groups`` must
    divide over 'model'; a depthwise conv's channels do when its width
    does).  Weights are term-revealed whole before they are sharded:
    groups run along the input-channel axis, so a shard of output
    channels never splits one.
    """

    mesh: object = None

    def _slice(self, t: torch.Tensor | None, n_out: int):
        if t is None:
            return None
        me = axis_index(self.mesh, "model")
        return t[me * n_out:(me + 1) * n_out]

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1,
             x_channels=None):
        n = axis_size(self.mesh, "model")
        if groups > 1:
            if groups % n:
                raise ValueError(f"{name}: {groups} groups do not divide "
                                 f"over the {n} ranks of 'model'")
            width = x.shape[-1] // n
            me = axis_index(self.mesh, "model")
            x_channels = slice(me * width, (me + 1) * width)
            groups //= n
        y = super().conv(name, {**params, "b": None}, x, stride, padding,
                         groups, x_channels)
        b = self._slice(params.get("b"), y.shape[-1])
        if b is not None:
            y = y + b.to(y.dtype)
        return all_gather(y, self.mesh, "model", axis=3)

    def dense(self, name, params, x):
        y = super().dense(name, {**params, "b": None}, x)
        b = self._slice(params.get("b"), y.shape[-1])
        if b is not None:
            y = y + b.to(y.dtype)
        return all_gather(y, self.mesh, "model", axis=y.ndim - 1)


def make_tp_cnn_apply(model_mod, qcfg, mesh):
    """The quantized-eval CNN forward of
    :func:`~tq_tpu_torch.convert.cnn.make_cnn_apply` (float32, no
    calibration), tensor-parallel over the 'model' dimension of ``mesh``
    (:class:`TPQuantCtx`): ``f(qparams, qstate, x) -> (logits,
    new_qstate)`` on this rank's shards, ``shard_pytree(qparams,
    cnn_param_specs(qparams), mesh)``, and this rank's rows of the batch
    (``shard_batch``); the logits are this rank's rows, whole.  No model
    module changes."""
    from tq_tpu_torch.convert.cnn import make_cnn_apply

    return make_cnn_apply(model_mod, qcfg, track=False,
                          context=functools.partial(TPQuantCtx, mesh=mesh))
