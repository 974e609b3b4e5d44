"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration (``benchmark/configs/<config>.json``), its
traffic (``benchmark/traffic/<traffic>.json``, whose ``loop`` names the
loop in ``benchmark/loops/``), its limits (``benchmark/limits/<cell>.json``)
and its per-layer metrics (``benchmark/metrics/<metric>.py``) are found
by the names in ``BENCHMARK.json``.  Set-up makes the weights and inputs
from the seed and warms every shape; the window then drives the loop for
``--seconds``; the program's state is freed and a sample of what the
window produced is checked against the plain reference.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1``
reports its per-layer metrics: the window's first ``trace_lead_s``
seconds time the model step untraced, the next ``trace_seconds`` run
under ``torch.profiler``, and the rest under the loop's spans.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_WINDOW = "benchmark.traced_window"


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(manifest: dict, workload: str):
    """(cell entry, configuration, traffic, end-to-end metric entries,
    per-layer metric entries) of ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = _json(ROOT / configs[cell["config"]]["file"])
    traffic = _json(BENCH / "traffic" / f"{cell['traffic']}.json")

    def here(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in manifest["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if here(m) and m["moves"] in reported]
    return cell, cfg, traffic, e2e, layer


def read_metric(name: str, run) -> float | None:
    """The per-layer metric ``name`` of a traced run, by its reader."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


@dataclasses.dataclass
class Run:
    """One run of a cell: its inputs, and what the window measured."""

    workload: str
    cfg: dict
    traffic: dict
    seed: int
    device: object
    spans: object = None
    loop: object = None
    lead_steps: int = 0
    lead_seconds: float = 0.0
    trace_steps: int = 0
    trace: object = None
    readings: dict = dataclasses.field(default_factory=dict)


def _launches() -> dict:
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize

    return {**{f"term_matmul.{k}": v for k, v in term_matmul.launches.items()},
            **{f"term_matmul.kernel.{k}": v
               for k, v in term_matmul.kernel_launches.items()},
            **{f"tr_quantize.{k}": v for k, v in tr_quantize.launches.items()}}


def window(run, seconds: float, traced: bool) -> float:
    """Drive the loop for ``seconds``; the window's length, ending once
    its work is done.  A traced window has three parts, each of its own
    length: the untraced lead, the profiled part and the spans (at least
    one unit)."""
    from benchmark.harness import traced as profiled

    loop, spans = run.loop, run.spans
    t0 = time.perf_counter()

    def until(t_end):
        while time.perf_counter() < t_end:
            loop.unit()

    if not traced:
        until(t0 + seconds)
        loop.drain()
        return time.perf_counter() - t0
    until(t0 + min(run.traffic["trace_lead_s"], seconds))
    loop.drain()
    run.lead_seconds = time.perf_counter() - t0
    run.lead_steps = loop.steps
    out = Path(tempfile.mkdtemp(prefix="benchmark-trace-"))
    try:
        with profiled(run.device, TRACE_WINDOW, out) as result:
            s0 = loop.steps
            until(time.perf_counter() + run.traffic["trace_seconds"])
            loop.drain()
            run.trace_steps = loop.steps - s0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    run.trace = result[0]
    spans.active = True
    rest = seconds - run.traffic["trace_lead_s"] - run.traffic["trace_seconds"]
    until(time.perf_counter() + max(rest, 0.0))
    if not spans.seconds:
        loop.unit()
    loop.drain()
    spans.active = False
    return time.perf_counter() - t0


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, cfg: dict, traffic: dict, e2e: list,
             layer: list, limits: dict, seed: int, seconds: float,
             traced: bool, device, control: bool = False) -> tuple:
    """Set up, measure, free, check: (result line, checks, run).  With
    ``control`` the reference at TF32 takes the program's place in the
    check."""
    import torch

    from benchmark.harness import Spans, checks

    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    run = Run(workload, cfg, traffic, seed, device, Spans(device))
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    run.loop = loop.Loop(run)
    run.loop.setup()
    run.spans.sync()
    setup_s = time.perf_counter() - _START
    launches0 = _launches()
    seconds_taken = window(run, seconds, traced)
    steps = max(run.loop.steps, 1)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    metrics: dict = {}
    breakdown = None
    if traced:
        per_step = {k: (v - launches0[k]) / steps
                    for k, v in _launches().items() if v != launches0[k]}
        print(f"benchmark: launches a step: {json.dumps(per_step)}",
              file=sys.stderr)
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        for m in layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": run.trace.top_kernels(),
                     "idle_gaps": run.trace.idle_gaps()}
    else:
        measured = dict(run.loop.end_to_end(seconds_taken))
        measured["setup_s"] = (setup_s, "s")
        for m in e2e:
            value, unit = measured[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    if device.type == "cuda":
        device_info["power_limit"] = _power_limit()
    run.loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = run.loop.readings(control=control)
    found = checks(run.readings, limits)
    result = {"correct": all(c.ok for c in found),
              "attempted": run.loop.attempted, "failed": run.loop.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in found}
    return result, found, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    manifest = _json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, e2e, layer = cell_spec(manifest, a.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: {a.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import forbidden_modules, load_limits

    result, found, _ = run_cell(a.workload, cfg, traffic, e2e, layer,
                                load_limits(a.workload), a.seed, a.seconds,
                                bool(a.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    for c in found:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
