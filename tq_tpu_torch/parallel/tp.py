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

import torch

from tq_tpu_torch.kernels.term_matmul import PackedWeight8, term_matmul
from tq_tpu_torch.parallel._compat import (axis_index, axis_size, psum,
                                           ppermute_start)

__all__ = ["tp_term_matmul_col", "tp_term_matmul_row",
           "tp_term_matmul_overlap", "tp_term_matmul_col_packed"]


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
