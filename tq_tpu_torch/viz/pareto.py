"""Accuracy-vs-tmacs Pareto figure (reference quant_vs_term_reveal.py).

Port of ``tq_tpu.viz.pareto``.  One panel per architecture: the UQ sweep
curve vs the TR curves (one per data_terms), x = term-pair MACs (log), y
= top-1 / accuracy.  Reads the ``results/<arch>-results.json`` schema.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from tq_tpu_torch.viz import gen_frontier, pyplot


def plot(result_files, out_file="figures/quant_vs_term_reveal.pdf",
         metric="accs"):
    plt = pyplot()
    result_files = list(result_files)
    fig, axes = plt.subplots(
        1, len(result_files), figsize=(4 * len(result_files), 3.2),
        squeeze=False)
    for ax, path in zip(axes[0], result_files):
        res = json.loads(Path(path).read_text())
        arch = Path(path).stem.replace("-results", "")
        xs, ys = gen_frontier(res["quant"]["tmacs"], res["quant"][metric])
        ax.plot(xs, ys, "o-", label="UQ")
        for key in sorted(k for k in res if k.startswith("tr-data")):
            xs, ys = gen_frontier(res[key]["tmacs"], res[key][metric])
            ax.plot(xs, ys, "s--", label=f"TR dt={key[-1]}")
        ax.set_xscale("log")
        ax.set_xlabel("term-pair MACs")
        ax.set_ylabel("top-1 (%)")
        ax.set_title(arch)
        ax.legend(fontsize=8)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def plot_pair(quant_file, tr_file, out_file="figures/pareto.pdf",
              metric=None, title=""):
    """Two-file variant for the MLP/LSTM schemas
    (``{accs|ppls, tmacs, param_bits}``), UQ vs TR curves."""
    plt = pyplot()
    q = json.loads(Path(quant_file).read_text())
    t = json.loads(Path(tr_file).read_text())
    metric = metric or ("ppls" if "ppls" in q else "accs")
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    for res, label, style in ((q, "UQ", "o-"), (t, "TR", "s--")):
        ys = res[metric]
        ys = [-y for y in ys] if metric == "ppls" else ys
        xs, ys = gen_frontier(res["tmacs"], ys)
        ys = [-y for y in ys] if metric == "ppls" else ys
        ax.plot(xs, ys, style, label=label)
    ax.set_xscale("log")
    ax.set_xlabel("term-pair MACs")
    ax.set_ylabel("perplexity" if metric == "ppls" else "accuracy (%)")
    ax.set_title(title)
    ax.legend(fontsize=8)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results", nargs="+", help="results/<arch>-results.json, "
                    "or exactly two {quant,tr} files with --pair")
    ap.add_argument("--out", default="figures/quant_vs_term_reveal.pdf")
    ap.add_argument("--pair", action="store_true",
                    help="MLP/LSTM two-file schema")
    a = ap.parse_args(argv)
    if a.pair:
        print(plot_pair(a.results[0], a.results[1], a.out))
    else:
        print(plot(a.results, a.out))


if __name__ == "__main__":
    main()
