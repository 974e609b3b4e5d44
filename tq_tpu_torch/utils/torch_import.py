"""Torch / torchvision checkpoints as the port's parameter trees.

Port of ``tq_tpu.utils.torch_import``.  A ``state_dict`` (or anything with
``.items()`` of name -> tensor or array) becomes the flat-name tree the
functional models use, as float32 numpy arrays (put them on a device with
:func:`tq_tpu_torch.utils.params.params_from_jax`):

  conv    OIHW  ->  HWIO  (transpose 2, 3, 1, 0)
  linear  (out, in) -> (in, out)
  bn      weight/bias/running_mean/running_var -> scale/bias/mean/var
  lstm    weight_ih_l{k}: (4H, in) -> (in, 4H)   (gate order i, f, g, o)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["from_state_dict", "load_torch_checkpoint"]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _t(a: np.ndarray, axes=None) -> np.ndarray:
    """``a`` transposed, as a C-contiguous copy."""
    return np.ascontiguousarray(np.transpose(a, axes))


def from_state_dict(state_dict, rename=None) -> dict:
    """A torch ``state_dict`` as a flat {module: {leaf: array}} tree.

    ``rename``: optional callable mapping torch module prefixes to layer
    names.  ``num_batches_tracked`` buffers are dropped.
    """
    modules: dict[str, dict] = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = key.rpartition(".")
        modules.setdefault(prefix, {})[leaf] = _np(val)

    out = {}
    for prefix, leaves in modules.items():
        name = rename(prefix) if rename else prefix
        if "running_mean" in leaves:  # batch norm
            mean = leaves["running_mean"]
            out[name] = {"scale": leaves.get("weight", np.ones_like(mean)),
                         "bias": leaves.get("bias", np.zeros_like(mean)),
                         "mean": mean, "var": leaves["running_var"]}
        elif any(k.startswith("weight_ih_l") for k in leaves):
            # torch's nn.LSTM keeps every layer in one module
            n_layers = sum(1 for k in leaves if k.startswith("weight_ih_l"))
            out[name] = [{"w_ih": _t(leaves[f"weight_ih_l{i}"]),
                          "w_hh": _t(leaves[f"weight_hh_l{i}"]),
                          "b_ih": leaves[f"bias_ih_l{i}"],
                          "b_hh": leaves[f"bias_hh_l{i}"]}
                         for i in range(n_layers)]
        elif "weight" in leaves and leaves["weight"].ndim == 4:  # conv
            p = {"w": _t(leaves["weight"], (2, 3, 1, 0))}
            if "bias" in leaves:
                p["b"] = leaves["bias"]
            out[name] = p
        elif "weight" in leaves and leaves["weight"].ndim == 2:  # linear
            p = {"w": _t(leaves["weight"])}
            if "bias" in leaves:
                p["b"] = leaves["bias"]
            out[name] = p
        elif "weight" in leaves:  # 1-D affine (layer norm without stats)
            out[name] = {"scale": leaves["weight"],
                         "bias": leaves.get("bias",
                                            np.zeros_like(leaves["weight"]))}
        else:
            out[name] = leaves
    return out


def load_torch_checkpoint(path: str | Path, rename=None) -> dict:
    """Load a ``.pt``/``.pth`` file (a state_dict, or a whole pickled
    module, whose class must be importable) as :func:`from_state_dict`
    does."""
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return from_state_dict(obj, rename=rename)
