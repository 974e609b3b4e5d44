#!/usr/bin/env python3
"""Device time of one checkout's ``term_matmul`` at the eval and serving
shapes.

    python3 scripts/time_term_matmul.py --root DIR

Imports ``tq_tpu_torch`` from the checkout DIR (any commit of the port;
its kernels are built there at first use) and times ``term_matmul`` by
CUDA-graph replay (``chip_smoke.device_ms``):

* the f32 mode on float32 weights at the eval shapes (SHAPES), on seeded
  inputs like those of ``chip_smoke.py``'s ``kernels`` phase (bits 4, 2
  terms);
* the six M = 1 serving rows at the decoder shape (1, 650, 33278), warm,
  on weights made as in phase ``term_matmul_modes``, and the same calls'
  eager time (``chip_smoke.eager_ms``: back to back from Python, the
  wrapper's host cost included);
* with ``--modes``, instead of both: the bf16 and int8 modes at M > 8,
  ``chip_smoke.MMA_LP_CELLS`` ((128, 784, 512), (350, 650, 2600) and
  ``bench.py``'s (8192, 2048, 512)), bits 8 (int8: 7) and 3 terms, on
  weights made as in phase ``term_matmul_modes``;
* with ``--narrow``, instead: the f32 mode's eight variants on int8,
  int16, bf16-stored and 9-bit packed weights (``chip_smoke.
  NARROW_VARIANTS``) at ``chip_smoke.NARROW_CELLS`` ((64, 650, 33278),
  the batch-64 serving step's decoder, and (128, 784, 512)), bits 8 and
  3 terms (on the ``mma`` kernel, in a checkout whose route gives them
  to it).

Each call takes whatever kernel the checkout's route gives it.  To
compare two commits on one card, run it once per checkout in the order
parent, change, change, parent.  Prints one JSON line: the checkout, the
card's ``nvidia-smi`` name and power limit, and ms per call by shape and
by serving row.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(128, 784, 512), (128, 512, 512), (128, 512, 10), (16, 784, 512),
          (350, 650, 2600)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True,
                    help="checkout whose tq_tpu_torch is timed")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--modes", action="store_true",
                       help="time the bf16 and int8 modes at M > 8 instead")
    group.add_argument("--narrow", action="store_true",
                       help="time the f32 mode on the narrow weight "
                            "formats at M > 8 instead")
    args = ap.parse_args()
    root = args.root.resolve()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import (MMA_LP_CELLS, NARROW_CELLS, NARROW_VARIANTS,
                            TERM_MATMUL_ROWS, VOCAB, _tm_weights, device_ms,
                            eager_ms, nvidia_smi_line)

    sys.path.insert(0, str(root))
    import tq_tpu_torch
    from tq_tpu_torch.kernels.term_matmul import VARIANTS, term_matmul

    if Path(tq_tpu_torch.__file__).resolve().parent.parent != root:
        sys.exit(f"tq_tpu_torch imported from {tq_tpu_torch.__file__}, "
                 f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.modes or args.narrow:
        cells = MMA_LP_CELLS if args.modes else [
            (M, K, N, NARROW_VARIANTS) for M, K, N in NARROW_CELLS]
        print(json.dumps({"root": str(root), "card": nvidia_smi_line(),
                          "modes_ms": _modes_ms(torch, term_matmul, VARIANTS,
                                                cells, _tm_weights,
                                                device_ms)}), flush=True)
        return
    gen = torch.Generator(device="cpu").manual_seed(0)
    ms = {}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen).relu().to(dev)
        w = (torch.randn(K, N, generator=gen) * 0.05).to(dev)
        sf = torch.tensor(0.2, device=dev)
        ms[f"{M}x{K}x{N}"] = device_ms(
            torch, lambda: term_matmul(x, w, sf, 4, 2))
    serving, serving_eager = {}, {}
    wgen = torch.Generator(device=dev).manual_seed(1)
    for variant in TERM_MATMUL_ROWS.values():
        mode, fmt, quantize_x = VARIANTS[variant]
        w, w_sf, _ = _tm_weights(torch, fmt, 650, VOCAB, wgen, dev)
        x = torch.randn(1, 650, generator=wgen, device=dev)
        sf = torch.tensor(0.03, device=dev)
        bits, terms = (7, 3) if mode == "int8" else (8, 3)

        def call():
            return term_matmul(x, w, sf, bits, terms, bf16=mode == "bf16",
                               int8=mode == "int8", w_sf=w_sf,
                               quantize_x=quantize_x)

        serving[variant] = device_ms(torch, call)
        serving_eager[variant] = eager_ms(torch, call)
    print(json.dumps({"root": str(root), "card": nvidia_smi_line(),
                      "ms": ms, "serving_1x650x33278_ms": serving,
                      "serving_1x650x33278_eager_ms": serving_eager}),
          flush=True)


def _modes_ms(torch, term_matmul, variants, cells, make_weights,
              device_ms) -> dict:
    """ms per call of each (variant, shape) of ``cells``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    ms = {}
    for M, K, N, names in cells:
        for variant in names:
            mode, fmt, quantize_x = variants[variant]
            w, w_sf, _ = make_weights(torch, fmt, K, N, gen, dev)
            x = torch.randn(M, K, generator=gen, device=dev)
            sf = torch.tensor(0.03, device=dev)
            bits = 7 if mode == "int8" else 8

            def call():
                return term_matmul(x, w, sf, bits, 3, bf16=mode == "bf16",
                                   int8=mode == "int8", w_sf=w_sf,
                                   quantize_x=quantize_x)

            ms[f"{variant} {M}x{K}x{N}"] = device_ms(torch, call)
            del x, w
    return ms


if __name__ == "__main__":
    main()
