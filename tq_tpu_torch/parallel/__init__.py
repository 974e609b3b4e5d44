"""Data, tensor and pipeline parallelism on ``torch.distributed``: port of
``tq_tpu.parallel``.  Each device is one rank of the default process
group (:mod:`~tq_tpu_torch.parallel.launch`,
:func:`~tq_tpu_torch.parallel.multihost.initialize` or ``torchrun``)."""

from tq_tpu_torch.parallel.mesh import make_mesh, local_mesh
from tq_tpu_torch.parallel.pp import (
    make_pipeline_mesh,
    make_tr_block_fn,
    pipeline_apply,
)
from tq_tpu_torch.parallel.sharding import (
    mlp_param_specs,
    batch_spec,
    shard_pytree,
)

__all__ = [
    "make_mesh",
    "local_mesh",
    "make_pipeline_mesh",
    "make_tr_block_fn",
    "pipeline_apply",
    "mlp_param_specs",
    "batch_spec",
    "shard_pytree",
]
