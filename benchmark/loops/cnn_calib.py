"""The part of a CNN sweep setting before its eval: conversion and
calibration, setting after setting.

Each unit is one setting of the traffic's grid, in its order and round
again, from a setting that the seed picks (so that runs on different
seeds time every setting, where one window ends before the grid does):
the seeded model converted at it (``convert_cnn``), tracked forwards
(``make_cnn_apply(track=True)``) over ``calib_batches`` seeded batches
held on the device, then the scale search (``finalize_cnn``), and a
synchronize, which ends the setting.  Checked, for a sample of the
window's settings: the converted weights and the scales exactly, and the
histograms against the reference's.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import Reservoir, generator, sub_seed, worst


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['model']}")
        self.rows = self.traffic["batch"]
        self.grid = [tuple(s) for s in self.traffic["grid"]]
        self.start = sub_seed(run.seed, 9) % len(self.grid)
        self.units = self.steps = self.attempted = self.failed = 0

    def setup(self) -> None:
        from tq_tpu_torch.convert import (convert_cnn, finalize_cnn,
                                          make_cnn_apply,
                                          static_conv_layer_settings)
        from tq_tpu_torch.evals.cnn import get_model

        self._convert_cnn, self._finalize = convert_cnn, finalize_cnn
        self._apply, self._settings = make_cnn_apply, static_conv_layer_settings
        cfg, dev = self.cfg, self.run.device
        self.model = get_model(cfg["arch"])
        self.specs = self.model.conv_specs(cfg["image"])
        self.params = self.ref.make_params(
            cfg, generator(self.run.seed, dev, 1), dev)
        n = self.traffic["calib_batches"] * self.rows
        self.calib = torch.randn(
            n, cfg["image"], cfg["image"], cfg["channels"],
            generator=generator(self.run.seed, dev, 3), device=dev)
        # Both weight bodies (group of one and grouped), the tracked
        # forward and the search.
        for setting in {s[1] > 1: s for s in self.grid}.values():
            self._setting(setting, self.calib[:self.rows])
        self.run.spans.sync()
        self.kept = Reservoir(self.traffic["check_settings"], self.run.seed)

    def _setting(self, setting, images):
        wb, gs, wt, db, dt = setting
        with self.run.spans("convert"):
            qp, qcfg, qs = self._convert_cnn(
                self.model, self.params,
                self._settings(self.specs, wb, gs, wt), db, dt,
                image=self.cfg["image"])
        with self.run.spans("search"):
            track = self._apply(self.model, qcfg, track=True)
            for x in images.split(self.rows):
                _, qs = track(qp, qs, x)
            qs = self._finalize(qs, qcfg)
        return qp, qs

    def unit(self) -> None:
        i = (self.start + self.units) % len(self.grid)
        qp, qs = self._setting(self.grid[i], self.calib)
        self.run.spans.sync()
        if self.kept.wants():
            self.kept.put((i, {k: qp[k]["w"] for k in qs},
                           {k: v["hist"] for k, v in qs.items()},
                           {k: v["sf"] for k, v in qs.items()}))
        self.units += 1
        self.steps += 1
        self.attempted += 1

    def drain(self) -> None:
        self.run.spans.sync()

    def end_to_end(self, seconds: float) -> dict:
        return {"calib_s": (seconds / self.units if self.units else
                            float("inf"), "s")}

    def release(self) -> None:
        pass  # a unit's state is gone when the next begins

    def readings(self, control: bool = False) -> dict:
        """For the sampled settings: ``weight_mismatch``, converted weight
        elements that differ from the reference's; ``scale_mismatch``,
        layers whose scale does; ``hist_moved``, the most that one
        layer's histogram differs from the reference's, as a share of
        its counts."""
        cfg = self.cfg
        batches = self.calib.split(self.rows)
        weight_mis = scale_mis = 0
        moved = 0.0
        for i, weights, hists, scales in self.kept.items:
            wb, gs, wt, db, dt = self.grid[i]
            want_w = self.ref.convert(self.params, cfg, wb, gs, wt)
            want_h, want_s = self.ref.calibrate(self.params, want_w, cfg,
                                                batches, db, dt)
            if control:
                weights = want_w  # the conversion takes no product
                hists, scales = self.ref.calibrate(self.params, want_w, cfg,
                                                   batches, db, dt,
                                                   tf32=True)
            for name, w in want_w.items():
                weight_mis += int((weights[name] != w).sum())
                scale_mis += int(scales[name] != want_s[name])
                h = want_h[name]
                moved = max(moved, worst((hists[name] - h).abs().sum()
                                         / h.sum()))
        return {"weight_mismatch": weight_mis, "scale_mismatch": scale_mis,
                "hist_moved": moved}
