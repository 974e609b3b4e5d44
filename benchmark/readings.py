"""Read the numbers that a cell's check compares, on many seeds in one
process: the program's on every seed and the control's (the reference
at TF32 in the program's place) on the seeds asked for.  The limits in
``benchmark/limits/`` are set from these readings (PERF.md); the
benchmark's own runs do not run this.

    python3 -m benchmark.readings --workload <cell> --seconds 4 \\
        --seeds 1 2 3 ... --control 1 2 3

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    manifest = bench._json(bench.ROOT / "BENCHMARK.json")
    _, cfg, traffic, e2e, layer = bench.cell_spec(manifest, a.workload)
    device = torch.device("cuda", 0)
    for seed in a.seeds:
        t0 = time.perf_counter()
        result, _, run = bench.run_cell(a.workload, cfg, traffic, e2e, [],
                                        {}, seed, a.seconds, False, device)
        line = {"seed": seed, "program": run.readings,
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items() if k != "setup_s"}}
        if seed in a.control:
            line["control"] = run.loop.readings(control=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
