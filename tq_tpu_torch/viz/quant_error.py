"""Per-layer weight quantization error bars (reference visualize/quant_error.py).

Port of ``tq_tpu.viz.quant_error``.  For every quantizable conv layer of
a model, computes the relative L2 error ||w - TR(w)|| / ||w|| live (the
reference recomputes quantization the same way, quant_error.py:58-88) at
a UQ setting and a TR setting, and draws grouped bars over layer index.
The weights are term-revealed by ``quantize_weight``: the ``tr_quantize``
kernels on the card.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tq_tpu_torch.layers.common import TRParams, quantize_weight


def layer_errors(m, params, settings):
    """[(layer_name, rel_err)] for each non-exempt conv under ``settings``
    (weight_bits, group_size, weight_terms), on the weights' device."""
    out = []
    tr = TRParams(*settings)
    for i, spec in enumerate(m.conv_specs()):
        if i == 0 or spec.groups > 1 or spec.is_se:
            continue
        w = params[spec.name]["w"]
        wq, _ = quantize_weight(w, tr, axis=2)
        # Norms in float64: the error does not depend on the device's
        # order of summation (the JAX package's float32 norms agree
        # within 1e-6).
        err = (torch.linalg.norm((w - wq).double())
               / torch.linalg.norm(w.double()))
        out.append((spec.name, err))
    # One fetch for the whole model.
    errs = torch.stack([e for _, e in out]).tolist() if out else []
    return [(name, e) for (name, _), e in zip(out, errs)]


def plot(arch="resnet18", checkpoint=None, uq=(8, 1, 8), tr=(9, 8, 12),
         out_file="figures/quant_error.pdf", device="cuda"):
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.viz import pyplot

    m, params = load_params(arch, checkpoint, device=device)
    e_uq = layer_errors(m, params, uq)
    e_tr = layer_errors(m, params, tr)
    plt = pyplot()
    x = np.arange(len(e_uq))
    fig, ax = plt.subplots(figsize=(6.4, 3.0))
    ax.bar(x - 0.2, [e for _, e in e_uq], 0.4, label=f"UQ {uq[0]}-bit")
    ax.bar(x + 0.2, [e for _, e in e_tr], 0.4,
           label=f"TR wb={tr[0]} g={tr[1]} wt={tr[2]}")
    ax.set_xlabel("conv layer index")
    ax.set_ylabel("relative weight error")
    ax.set_title(arch)
    ax.legend(fontsize=8)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-a", "--arch", default="resnet18")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="figures/quant_error.pdf")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    print(plot(a.arch, a.checkpoint, out_file=a.out, device=a.device))


if __name__ == "__main__":
    main()
