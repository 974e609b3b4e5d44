"""Group-size ablation figure (reference visualize/group_size.py).

Port of ``tq_tpu.viz.group_size``: accuracy vs alpha (= weight_terms /
g), one curve per group size, from
``results/<arch>-group-size-results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from tq_tpu_torch.viz import pyplot


def plot(result_file, out_file="figures/group_size.pdf"):
    plt = pyplot()
    res = json.loads(Path(result_file).read_text())
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    for g in sorted(res, key=int):
        ax.plot(res[g]["avg_terms"], res[g]["accs"], "o-", label=f"g={g}")
    ax.set_xlabel(r"$\alpha$ (terms per value)")
    ax.set_ylabel("top-1 (%)")
    ax.legend(fontsize=8)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--out", default="figures/group_size.pdf")
    a = ap.parse_args(argv)
    print(plot(a.results, a.out))


if __name__ == "__main__":
    main()
