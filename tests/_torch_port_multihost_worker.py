"""Worker process for the port's two-process ``multihost`` test.

Usage: python _torch_port_multihost_worker.py <rank> <world> <init_url>

The port's counterpart of ``_multihost_worker.py``: each OS process joins
the group through ``tq_tpu_torch.parallel.multihost.initialize`` (gloo on
the CPU), builds ``global_mesh``, feeds its own rows with
``host_local_batch`` (different values on each process), term-reveals
them and sums over 'data'.  It prints a JSON line the parent asserts on:
the global sum can only be right if the collective crossed processes.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tq_tpu_torch.kernels.tr_quantize import tr_quantize  # noqa: E402
from tq_tpu_torch.parallel import _compat  # noqa: E402
from tq_tpu_torch.parallel.multihost import (  # noqa: E402
    global_mesh,
    host_local_batch,
    initialize,
)

rank, world, url = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
initialize(url, world, rank)
mesh = global_mesh(n_model=1, device="cpu")
local = np.full((8 // world, 16), float(rank + 1), np.float32)
x = host_local_batch(mesh, local)
total = _compat.psum(tr_quantize(x, 0.25, 6, 1, 2).sum(), mesh, "data")
# Half the rows are 1.0 and half 2.0: quantized at sf 0.25 they stay
# exact, so the global sum is analytic.
print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                  "mesh": list(mesh.shape), "psum": float(total),
                  "expect": float(16 * (4 * 1.0 + 4 * 2.0))}), flush=True)
dist.destroy_process_group()
