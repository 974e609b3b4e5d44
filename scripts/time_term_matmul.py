#!/usr/bin/env python3
"""Device time of one checkout's f32 ``term_matmul`` at the eval shapes.

    python3 scripts/time_term_matmul.py --root DIR

Imports ``tq_tpu_torch`` from the checkout DIR (any commit of the port;
its kernels are built there at first use) and times ``term_matmul`` on
seeded inputs like those of ``chip_smoke.py``'s ``kernels`` phase (bits
4, 2 terms), by CUDA-graph replay (``chip_smoke.device_ms``).  To compare two commits on one card,
run it once per checkout in the order parent, change, change, parent.
Prints one JSON line: the checkout, the card's ``nvidia-smi`` name and
power limit, and ms per call at each (M, K, N).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(128, 784, 512), (350, 650, 2600)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True,
                    help="checkout whose tq_tpu_torch is timed")
    root = ap.parse_args().root.resolve()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import device_ms, nvidia_smi_line

    sys.path.insert(0, str(root))
    import tq_tpu_torch
    from tq_tpu_torch.kernels.term_matmul import term_matmul

    if Path(tq_tpu_torch.__file__).resolve().parent.parent != root:
        sys.exit(f"tq_tpu_torch imported from {tq_tpu_torch.__file__}, "
                 f"not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    ms = {}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen).relu().to(dev)
        w = (torch.randn(K, N, generator=gen) * 0.05).to(dev)
        sf = torch.tensor(0.2, device=dev)
        ms[f"{M}x{K}x{N}"] = device_ms(
            torch, lambda: term_matmul(x, w, sf, 4, 2))
    print(json.dumps({"root": str(root), "card": nvidia_smi_line(),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
