"""Progress meters and top-k accuracy (equivalent of the reference's
util.py:83-133).

Port of ``tq_tpu.utils.meters``.
"""

from __future__ import annotations

import torch

__all__ = ["AverageMeter", "ProgressMeter", "accuracy"]


def accuracy(output, target, topk=(1,)):
    """Top-k accuracies in percent (util.py:124-133).

    ``output``: (N, C) scores; ``target``: (N,) labels, tensors (on any
    device, the same one) or arrays.  Returns one float per k, computed in
    float32 as the JAX package does; the counts stay on the device until
    the one fetch at the end.
    """
    output, target = torch.as_tensor(output), torch.as_tensor(target)
    target = target.to(output.device)
    maxk = max(topk)
    n = output.shape[0]
    # The top-maxk predictions per row, descending score, ties to the
    # higher index as the JAX package's reversed stable argsort.
    order = torch.argsort(output.flip(1), dim=1, descending=True,
                          stable=True)
    pred = (output.shape[1] - 1 - order)[:, :maxk]
    correct = pred == target[:, None]
    counts = torch.stack([correct[:, :k].sum() for k in topk])
    return (100.0 * counts.to(torch.float32) / n).tolist()


class AverageMeter:
    """Running average of a scalar (util.py:83-104)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            **self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        line = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        line += [str(m) for m in self.meters]
        print("\t".join(line))
