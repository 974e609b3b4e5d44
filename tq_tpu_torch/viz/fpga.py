"""FPGA latency/energy improvement bars (reference visualize/fpga_results.py).

Port of ``tq_tpu.viz.fpga``.  The numbers are the reference paper's
hardcoded measurements on a Xilinx VC707 (fpga_results.py:8-10):
normalized TR-over-QT improvement factors, kept verbatim as the
hardware-evaluation record.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tq_tpu_torch.viz import pyplot

NETWORKS = ["MLP", "VGG-16", "ResNet-18", "MobileNet-v2", "EffNet-b0", "LSTM"]
LATENCY_X = [6.2, 10.8, 8.8, 7.3, 8.1, 3.3]
ENERGY_X = [4.1, 7.0, 5.9, 4.6, 5.2, 2.1]


def plot(out_file="figures/fpga_results.pdf"):
    plt = pyplot()
    x = np.arange(len(NETWORKS))
    fig, ax = plt.subplots(figsize=(5.2, 3.0))
    ax.bar(x - 0.2, LATENCY_X, 0.4, label="Latency improvement")
    ax.bar(x + 0.2, ENERGY_X, 0.4, label="Energy-eff. improvement")
    ax.set_xticks(x)
    ax.set_xticklabels(NETWORKS, rotation=30, ha="right")
    ax.set_ylabel("TR / QT (x)")
    ax.legend(fontsize=8)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="figures/fpga_results.pdf")
    a = ap.parse_args(argv)
    print(plot(a.out))


if __name__ == "__main__":
    main()
