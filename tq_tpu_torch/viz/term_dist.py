"""Per-group term-count distribution (reference visualize/term_group_dist.py).

Port of ``tq_tpu.viz.term_dist``.  The reference splices Tracker modules
in front of TR layers to capture live activations, then convolves
bit-plane expansions to count term pairs per group
(term_group_dist.py:19-45, 101-110).  Here the weight-side statistic is
a direct computation: uniform-quantize a weight tensor, HESE-encode
(``hese_terms_count``), sum term counts over each group of ``g`` input
channels, and histogram — the distribution whose long tail top-alpha
truncation cuts.  The activation-side panel captures a converted
model's inputs with :mod:`tq_tpu_torch.profilers.empirical`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tq_tpu_torch.layers.common import weight_scale
from tq_tpu_torch.ops.hese import hese_terms_count


def group_term_counts(w, weight_bits: int, group_size: int) -> np.ndarray:
    """Per-group HESE term totals of a conv weight (HWIO), grouped along
    the input-channel axis (the last group zero-padded), as int32."""
    sf = weight_scale(w, weight_bits)
    # Half to even, as the JAX package's jnp.round here (the raw weights
    # are not on the grid, so an exact half can occur).
    q = torch.round(w.abs() / sf).to(torch.int32)
    counts = hese_terms_count(q, weight_bits + 1)
    moved = torch.movedim(counts, 2, -1)
    pad = (-moved.shape[-1]) % group_size
    if pad:
        moved = torch.nn.functional.pad(moved, (0, pad))
    grouped = moved.reshape(-1, group_size)
    return grouped.sum(dim=-1).to(torch.int32).cpu().numpy()


def _eligible(m):
    return [s for i, s in enumerate(m.conv_specs())
            if i > 0 and s.groups == 1 and not s.is_se]


def plot(arch="resnet18", checkpoint=None, layer=None, weight_bits=9,
         group_sizes=(1, 8, 16), out_file="figures/term_group_dist.pdf",
         device="cuda"):
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.viz import pyplot

    m, params = load_params(arch, checkpoint, device=device)
    spec = next(s for s in _eligible(m) if layer is None or s.name == layer)
    w = params[spec.name]["w"]
    plt = pyplot()
    fig, axes = plt.subplots(1, len(group_sizes),
                             figsize=(3.4 * len(group_sizes), 2.8))
    for ax, g in zip(np.atleast_1d(axes), group_sizes):
        counts = group_term_counts(w, weight_bits, g)
        ax.hist(counts, bins=range(int(counts.max()) + 2), density=True)
        ax.axvline(counts.mean(), color="k", ls="--", lw=1)
        ax.set_title(f"g={g} (mean {counts.mean():.1f})", fontsize=9)
        ax.set_xlabel("terms per group")
    np.atleast_1d(axes)[0].set_ylabel("frequency")
    fig.suptitle(f"{arch} {spec.name}, {weight_bits}-bit", fontsize=10)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def term_pair_histogram(m, params, layer=None, group_size=16, image=64,
                        batch=2, weight_bits=9, data_bits=9,
                        encoding="binary") -> dict:
    """The statistic of :func:`plot_term_pair_dist`, on the parameters'
    device: {'layer', 'pct' (percent of partial dot products by pair
    count), 'long_tail' (the count below which 99% fall), 'theo_max'}.

    Protocol of the reference (term_group_dist.py:68-73, 101-126):
    convert the model at the unquantized TR setting (wb = db = 9, terms =
    bits, g = 1), set every scale to 0.05, run a batch of normal images
    (numpy seed 0), capture one layer's input, slice the first
    ``group_size`` channels of data and weights, and count the pairs of
    every output position with ``conv_term_pair_map``.
    """
    from tq_tpu_torch.convert import convert_cnn, static_conv_layer_settings
    from tq_tpu_torch.layers.quantize import act_quantize
    from tq_tpu_torch.profilers.empirical import (capture_activations,
                                                  conv_term_pair_map)
    from tq_tpu_torch.profilers.trace_specs import specs_for

    specs = specs_for(m, image=image)
    device = params[specs[0].name]["w"].device
    settings = static_conv_layer_settings(specs, weight_bits, 1, weight_bits)
    qparams, qcfg, qstate = convert_cnn(m, params, settings, data_bits,
                                        data_bits, image=image)
    qstate = {k: {**v, "sf": torch.tensor(0.05, device=device)}
              for k, v in qstate.items()}
    x = torch.as_tensor(
        np.random.default_rng(0).normal(size=(batch, image, image, 3)),
        dtype=torch.float32, device=device)
    captured = capture_activations(m, qparams, qstate, qcfg, x)
    eligible = [s.name for s in specs[1:]
                if s.groups == 1 and s.in_ch >= group_size
                and s.name in captured]
    name = layer if layer is not None else eligible[0]
    xin, stride, padding, _ = captured[name]
    tr = qcfg[name]
    sf = qstate[name]["sf"]
    xq = act_quantize(xin, sf, tr.data_bits, tr.data_terms)
    w_q, w_sf = qparams[name]["w"], qparams[name]["w_sf"]
    pair_map = conv_term_pair_map(
        xq[..., :group_size], w_q[:, :, :group_size, :], sf, w_sf,
        tr.data_bits, tr.weight_bits, stride, padding, encoding=encoding)
    bc = np.bincount(pair_map.cpu().numpy().ravel())
    pct = 100.0 * bc / bc.sum()
    long_tail = int(np.arange(len(pct))[np.cumsum(pct) > 99][0])
    theo_max = group_size * (tr.data_bits + 1) * (tr.weight_bits + 1)
    return {"layer": name, "pct": pct, "long_tail": long_tail,
            "theo_max": theo_max}


def plot_term_pair_dist(arch="resnet18", checkpoint=None, layer=None,
                        group_size=16, image=64, batch=2,
                        weight_bits=9, data_bits=9,
                        out_file="figures/term_pair_dist.pdf",
                        encoding="binary", device="cuda"):
    """Activation-side panel: distribution of term-pair multiplications
    per partial dot product over groups of ``group_size`` input channels
    (reference figure, term_group_dist.py:101-126; the statistic is
    :func:`term_pair_histogram`'s).  ``encoding='binary'`` is the
    reference's ``expand_binary_bits`` statistic; 'hese' counts signed
    terms.  The long tail is what group-wise top-alpha truncation cuts."""
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.viz import pyplot

    m, params = load_params(arch, checkpoint, device=device)
    h = term_pair_histogram(m, params, layer, group_size, image, batch,
                            weight_bits, data_bits, encoding)
    pct = h["pct"]
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 2.8))
    xs = np.arange(len(pct))
    ax.fill_between(xs, pct, color="cornflowerblue", zorder=2)
    ax.plot(xs, pct, "-k", lw=1.5)
    ax.axvline(h["long_tail"], color="r", ls="--", lw=1.5)
    ax.set_title(f"{arch} {h['layer']}: term-pair mults per partial dot "
                 f"product (g={group_size})", fontsize=9)
    ax.set_xlabel(f"{encoding} pair multiplications "
                  f"(99% < {h['long_tail']}; theoretical max "
                  f"{h['theo_max']})")
    ax.set_ylabel("frequency (%)")
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, bbox_inches="tight")
    plt.close(fig)
    return out_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-a", "--arch", default="resnet18")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--layer", default=None)
    ap.add_argument("--out", default="figures/term_group_dist.pdf")
    ap.add_argument("--pairs", action="store_true",
                    help="activation-side term-pair distribution panel")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)
    if a.pairs:
        out = a.out if a.out != "figures/term_group_dist.pdf" \
            else "figures/term_pair_dist.pdf"
        print(plot_term_pair_dist(a.arch, a.checkpoint, a.layer,
                                  out_file=out, device=a.device))
        return
    print(plot(a.arch, a.checkpoint, a.layer, out_file=a.out,
               device=a.device))


if __name__ == "__main__":
    main()
