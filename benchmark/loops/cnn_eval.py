"""The eval loop of a CNN sweep setting, calibrated once in set-up.

Set-up converts the seeded model at the configuration's TR setting
(``convert_cnn``), calibrates it on ``calib_images`` seeded images in
batches (``make_cnn_apply(track=True)``, ``finalize_cnn``) and warms
the eval forward.  Each unit is one batch of a pool of seeded images
held on the device, cycled through ``make_cnn_apply(track=False)``.
Checked: a sample of the window's batches, followed layer by layer by
the reference (its own conversion and calibration) from the program's
own activations, which those batches keep: the eval forward takes a
context that records each conv's and the classifier's input while a
sampled batch runs (``make_cnn_apply``'s ``context``, a ``QuantCtx``
that computes what the default one does).
"""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import Reservoir, generator


def recording_context(store: list):
    """A ``QuantCtx`` class that keeps each conv's and the classifier's
    input in the dict ``store[0]``, under the layer's name, while
    ``store[0]`` is a dict (and nothing while it is None)."""
    from tq_tpu_torch.layers.qctx import QuantCtx

    class Recording(QuantCtx):
        def conv(self, name, params, x, *args, **kw):
            if store[0] is not None:
                store[0][name] = x
            return super().conv(name, params, x, *args, **kw)

        def dense(self, name, params, x):
            if store[0] is not None:
                store[0][name] = x
            return super().dense(name, params, x)

    return Recording


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['model']}")
        self.rows = self.traffic["batch"]
        self.units = self.steps = self.attempted = self.failed = 0

    def _images(self, n: int, tag: int) -> torch.Tensor:
        c = self.cfg
        return torch.randn(n, c["image"], c["image"], c["channels"],
                           generator=generator(self.run.seed,
                                               self.run.device, tag),
                           device=self.run.device)

    def setup(self) -> None:
        from tq_tpu_torch.convert import (convert_cnn, finalize_cnn,
                                          make_cnn_apply,
                                          static_conv_layer_settings)
        from tq_tpu_torch.evals.cnn import get_model

        cfg, tr, dev = self.cfg, self.cfg["tr"], self.run.device
        model = get_model(cfg["arch"])
        self.params = self.ref.make_params(
            cfg, generator(self.run.seed, dev, 1), dev)
        self.pool = self._images(self.traffic["pool_images"], 2)
        self.calib = self._images(self.traffic["calib_images"], 3)
        settings = static_conv_layer_settings(
            model.conv_specs(cfg["image"]), tr["weight_bits"],
            tr["group_size"], tr["weight_terms"])
        qp, qcfg, qs = convert_cnn(model, self.params, settings,
                                   tr["data_bits"], tr["data_terms"],
                                   image=cfg["image"])
        track = make_cnn_apply(model, qcfg, track=True)
        for x in self.calib.split(self.rows):
            _, qs = track(qp, qs, x)
        self.qparams, self.qstate = qp, finalize_cnn(qs, qcfg)
        self._store = [None]
        self.forward = make_cnn_apply(
            model, qcfg, track=False,
            context=recording_context(self._store))
        self.forward(self.qparams, self.qstate, self.pool[:self.rows])
        self.kept = Reservoir(self.traffic["check_batches"], self.run.seed)

    def unit(self) -> None:
        b = self.units % (self.pool.shape[0] // self.rows)
        x = self.pool[b * self.rows:(b + 1) * self.rows]
        keep = self.kept.wants()
        self._store[0] = {} if keep else None
        logits, _ = self.forward(self.qparams, self.qstate, x)
        if keep:
            self.kept.put((b, self._store[0], logits))
        self.units += 1
        self.steps += 1
        self.attempted += 1

    def drain(self) -> None:
        self.run.spans.sync()

    def end_to_end(self, seconds: float) -> dict:
        return {"images_per_s": (self.units * self.rows / seconds,
                                 "images/s")}

    def release(self) -> None:
        del self.qparams, self.qstate, self.forward

    def readings(self, control: bool = False) -> dict:
        """``layer_gap`` and ``logit_gap`` of the sampled batches
        (``reference.follow``): the widest gap of a layer's output, and of
        the logits, from the reference's step from the program's own
        activations, as a share of the reference's largest magnitude.
        With ``control`` the reference at TF32, with its own calibration,
        takes the program's place."""
        cfg, tr = self.cfg, self.cfg["tr"]
        db, dt = tr["data_bits"], tr["data_terms"]
        weights = self.ref.convert(self.params, cfg, tr["weight_bits"],
                                   tr["group_size"], tr["weight_terms"])
        batches = self.calib.split(self.rows)
        _, scales = self.ref.calibrate(self.params, weights, cfg, batches,
                                       db, dt)
        if control:
            _, c_scales = self.ref.calibrate(self.params, weights, cfg,
                                             batches, db, dt, tf32=True)
        layer = logit = 0.0
        for b, record, logits in self.kept.items:
            x = self.pool[b * self.rows:(b + 1) * self.rows]
            if control:
                record = {}
                logits = self.ref.forward(self.params, weights, x, cfg, db,
                                          dt, scales=c_scales, tf32=True,
                                          record=record)
            gaps = self.ref.follow(self.params, weights, cfg, x, record,
                                   logits, db, dt, scales)
            layer, logit = max(layer, gaps[0]), max(logit, gaps[1])
        return {"layer_gap": layer, "logit_gap": logit}
