"""Declarative run configuration.

Port of ``tq_tpu.config``: the same JSON schema, the same dataclasses and
the same validation.  The reference's configuration is scattered:
per-script argparse flags, shell-level parallel lists (``--wb --wt ...``
zipped), hardcoded sweep grids, and an APB register map on the hardware
side whose field widths bound the legal space (group_size 5 bits,
group_budget 7 bits, data_terms 4 bits — ``systolic_dla_top.v:56-65``).
Here one dataclass tree covers workload, sweep settings, calibration and
mesh, loadable from JSON, and validation enforces the hardware
register-field bounds, so a config that runs is also one the reference
accelerator could be programmed with (override with ``allow_oversize``).

``mesh`` is parsed and validated; the sweeps run on one device, as the
JAX package's ``run`` does.

    python -m tq_tpu_torch.config cfg.json [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

from tq_tpu_torch.layers.quantize import CalibConfig

__all__ = ["Setting", "MeshConfig", "RunConfig", "load_config"]

# Hardware register-field bounds (reg_define.v / systolic_dla_top.v).
MAX_GROUP_SIZE = 31     # group_size[4:0]
MAX_GROUP_BUDGET = 127  # group_budget[6:0]
MAX_DATA_TERMS = 15     # data_terms[3:0]


@dataclasses.dataclass(frozen=True)
class Setting:
    """One sweep point: the reference's (wb, wt, db, dt, gs) 5-tuple."""

    weight_bits: int
    weight_terms: int
    data_bits: int
    data_terms: int
    group_size: int

    def validate(self, allow_oversize: bool = False):
        if self.group_size < 1 or self.weight_terms < 0:
            raise ValueError(f"invalid setting {self}")
        if allow_oversize:
            return self
        if self.group_size > MAX_GROUP_SIZE:
            raise ValueError(
                f"group_size {self.group_size} exceeds the hardware "
                f"register field (<= {MAX_GROUP_SIZE})")
        if self.weight_terms > MAX_GROUP_BUDGET:
            raise ValueError(
                f"weight_terms {self.weight_terms} exceeds the hardware "
                f"group budget field (<= {MAX_GROUP_BUDGET})")
        if self.data_terms > MAX_DATA_TERMS:
            raise ValueError(
                f"data_terms {self.data_terms} exceeds the hardware "
                f"register field (<= {MAX_DATA_TERMS})")
        return self


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    n_data: int | None = None  # None: all remaining devices
    n_model: int = 1


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One sweep run: workload + settings + calibration + mesh."""

    workload: str  # 'mlp' | 'cnn' | 'lstm' | 'group_size'
    settings: Sequence[Setting] = ()
    arch: str = "resnet18"  # cnn/group_size only
    checkpoint: str | None = None
    data_dir: str | None = None
    out_file: str | None = None
    batch_size: int = 64
    calib: CalibConfig = CalibConfig()
    mesh: MeshConfig = MeshConfig()
    allow_oversize: bool = False

    def validate(self):
        for s in self.settings:
            s.validate(self.allow_oversize)
        if self.workload not in ("mlp", "cnn", "lstm", "group_size"):
            raise ValueError(f"unknown workload {self.workload!r}")
        return self


def _from_dict(cls, d):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
        if k == "settings":
            v = tuple(Setting(**s) if isinstance(s, dict) else Setting(*s)
                      for s in v)
        elif k == "calib" and isinstance(v, dict):
            v = CalibConfig(**v)
        elif k == "mesh" and isinstance(v, dict):
            v = MeshConfig(**v)
        kw[k] = v
    return cls(**kw)


def load_config(path: str | Path) -> RunConfig:
    with open(path) as fp:
        return _from_dict(RunConfig, json.load(fp)).validate()


def run(cfg: RunConfig, device="cuda"):
    """Dispatch a validated config to the matching sweep driver, on
    ``device`` (raises for ``cuda`` without a CUDA device)."""
    cfg.validate()

    def cols(attr):
        return [getattr(s, attr) for s in cfg.settings]

    if cfg.workload == "mlp":
        from tq_tpu_torch.evals.mlp import run_sweep

        return run_sweep(
            cols("weight_bits"), cols("weight_terms"), cols("data_bits"),
            cols("data_terms"), cols("group_size"), cfg.out_file,
            checkpoint=cfg.checkpoint or "pretrained/mnist_mlp.npz",
            data_dir=cfg.data_dir, device=device)
    if cfg.workload == "lstm":
        from tq_tpu_torch.evals.lstm import run_sweep

        return run_sweep(
            cols("weight_bits"), cols("weight_terms"), cols("data_bits"),
            cols("data_terms"), cols("group_size"), cfg.out_file,
            checkpoint=cfg.checkpoint, data_dir=cfg.data_dir, device=device)
    if cfg.workload == "cnn":
        from tq_tpu_torch.evals.cnn import run_sweep

        return run_sweep(cfg.arch, cfg.checkpoint, cfg.data_dir,
                         cfg.out_file, cfg.batch_size, device=device)
    from tq_tpu_torch.evals.group_size import run_grid

    return run_grid(cfg.arch, cfg.checkpoint, cfg.data_dir, cfg.out_file,
                    cfg.batch_size, device=device)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Run a declarative sweep config")
    ap.add_argument("config", help="path to a RunConfig JSON")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    run(load_config(a.config), device=a.device)


if __name__ == "__main__":
    main()
