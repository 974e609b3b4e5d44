"""Figure generation from results JSONs (reference visualize/).

Port of ``tq_tpu.viz``.  Five plots, each a module with ``main()``
writing ``figures/*.pdf``:

  pareto      accuracy-vs-tmacs Pareto frontier, UQ vs TR
              (quant_vs_term_reveal.py)
  group_size  g/alpha ablation (group_size.py)
  quant_error per-layer weight quantization error bars (quant_error.py)
  term_dist   per-group term-count distribution (term_group_dist.py)
  fpga        FPGA latency/energy improvement bars (fpga_results.py)

matplotlib is optional: the functions that compute (:func:`gen_frontier`,
``quant_error.layer_errors``, ``term_dist.group_term_counts``,
``term_dist.term_pair_histogram``) import without it, and each plotting
function imports it when called, through :func:`pyplot` (the headless
Agg backend and the reference's rc settings).
"""

__all__ = ["gen_frontier", "pyplot"]


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, with the shared rc
    settings of the reference's visualize/__init__.py."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "font.size": 11,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "figure.dpi": 120,
        "savefig.bbox": "tight",
    })
    return plt


def gen_frontier(xs, ys):
    """Pareto frontier: keep points not dominated by a cheaper-and-better
    point (reference quant_vs_term_reveal.py:10-20, lower x better,
    higher y better)."""
    pts = sorted(zip(xs, ys))
    front = []
    best_y = float("-inf")
    for x, y in pts:
        if y > best_y:
            front.append((x, y))
            best_y = y
    return [p[0] for p in front], [p[1] for p in front]
