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
  wrapper's host cost included).

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
    root = ap.parse_args().root.resolve()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import (TERM_MATMUL_ROWS, VOCAB, _tm_weights, device_ms,
                            eager_ms, nvidia_smi_line)

    sys.path.insert(0, str(root))
    import tq_tpu_torch
    from tq_tpu_torch.kernels.term_matmul import VARIANTS, term_matmul

    if Path(tq_tpu_torch.__file__).resolve().parent.parent != root:
        sys.exit(f"tq_tpu_torch imported from {tq_tpu_torch.__file__}, "
                 f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
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


if __name__ == "__main__":
    main()
