"""Example: TR-quantize a ResNet-18 and run calibrated inference.

Port of the repository's ``examples/quantize_resnet18.py``.  Walks the
full production path: load (or init) params -> per-layer setting policy
-> efficiency profile -> conversion -> two-phase calibration -> quantized
inference, and the bf16 serving mode against it.  Synthetic images fill
in when no ImageNet or checkpoint is available.

Usage:
    python -m tq_tpu_torch.examples.quantize_resnet18 [--checkpoint resnet18.pt]
        [--val-dir /data] [--image 224] [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tq_tpu_torch.convert import (convert_cnn, finalize_cnn, make_cnn_apply,
                                  static_conv_layer_settings)
from tq_tpu_torch.models import resnet
from tq_tpu_torch.profilers import cnn_cost, param_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--val-dir", default=None)
    ap.add_argument("--wb", type=int, default=9)
    ap.add_argument("--gs", type=int, default=8)
    ap.add_argument("--wt", type=int, default=12)
    ap.add_argument("--dt", type=int, default=3)
    ap.add_argument("--image", type=int, default=224,
                    help="input resolution (small values for smoke runs)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    from tq_tpu_torch.evals.cnn import _batches, load_params

    m, params = load_params("resnet18", args.checkpoint, device=args.device)
    device = params["conv1"]["w"].device

    # 1. Policy: stem/depthwise/SE exempt, everything else at the sweep
    #    setting (here the reference's headline TR point).
    specs = resnet.conv_specs(args.image)
    settings = static_conv_layer_settings(specs, args.wb, args.gs, args.wt)

    # 2. Efficiency profile: pure arithmetic, no forward needed.
    tmacs, avg_terms = cnn_cost(specs, settings, 9, args.dt)
    print(f"term-pair MACs/img: {tmacs:,}  avg terms/value: {avg_terms}")
    print(f"params: {param_count(params):,}")

    # 3. Convert (weights term-revealed once, grouped along input chans).
    qparams, qcfg, qstate = convert_cnn(m, params, settings, 9, args.dt,
                                        image=args.image)

    # 4. Phase 1: calibration (activation histograms).
    track = make_cnn_apply(m, qcfg, track=True)
    if args.val_dir:
        for x, _ in _batches("resnet18", args.val_dir, 32, n_synth=64):
            _, qstate = track(qparams, qstate, torch.as_tensor(x,
                                                               device=device))
            break  # ~5% of val in real runs
    else:
        x = np.random.default_rng(1).normal(
            size=(args.batch, args.image, args.image, 3))
        _, qstate = track(qparams, qstate, torch.as_tensor(
            x, dtype=torch.float32, device=device))
    qstate = finalize_cnn(qstate, qcfg)  # MSE scale search per layer

    # 5. Phase 2: quantized inference.  The parity path keeps float32
    #    tensors (the reference's fake-quant structure);
    #    compute_dtype=torch.bfloat16 is the serving mode: every
    #    inter-layer tensor moves at 2 bytes, about twice the images/s
    #    on the card (PERF.md), same top-1.
    infer = make_cnn_apply(m, qcfg, track=False)
    serve = make_cnn_apply(m, qcfg, track=False,
                           compute_dtype=torch.bfloat16)
    x = torch.as_tensor(
        np.random.default_rng(0).normal(
            size=(args.batch, args.image, args.image, 3)),
        dtype=torch.float32, device=device)
    logits, _ = infer(qparams, qstate, x)
    slogits, _ = serve(qparams, qstate, x)
    print("logits:", tuple(logits.shape), "top-1:",
          logits.argmax(-1).tolist())
    print("serving-mode top-1 agrees:",
          bool((slogits.argmax(-1) == logits.argmax(-1)).all()))


if __name__ == "__main__":
    main()
