"""What every cell's run shares: seeds, samples, spans, the reading of a
device trace, the checks' record and the look for JAX in the process."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
# Top-level modules that may not be loaded in a run: JAX, its libraries
# and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tq_tpu")


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for the part ``tags`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *tags: int) -> torch.Generator:
    """A torch generator on ``device`` seeded for the part ``tags``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def worst(values: torch.Tensor) -> float:
    """The largest of ``values``; infinite where one is not a number."""
    values = torch.nan_to_num(values.float(), nan=float("inf"))
    return float(values.max()) if values.numel() else 0.0


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Reservoir:
    """A uniform sample of ``k`` of the units of a window, drawn from the
    seed: ask :meth:`wants` before a unit's output is copied."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self._rng = np.random.default_rng(sub_seed(seed, 7))
        self._seen = 0
        self.items: list = []
        self._slot = None

    def wants(self) -> bool:
        i = self._seen
        self._seen += 1
        if i < self.k:
            self._slot = i
            self.items.append(None)
            return True
        j = int(self._rng.integers(0, i + 1))
        self._slot = j if j < self.k else None
        return self._slot is not None

    def put(self, item) -> None:
        self.items[self._slot] = item


class Spans:
    """Host-clock spans around the calls into the program's layers, each
    ended by a synchronize unless ``sync=False`` (a span of host time
    alone); recorded only while :attr:`active` (the traced run's last
    part)."""

    def __init__(self, device):
        self.device = device
        self.active = False
        self.seconds: dict[str, list[float]] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = True):
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync:
            self.sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float | None:
        s = self.seconds.get(name)
        return 1e3 * sum(s) / len(s) if s else None


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def load_limits(workload: str) -> dict:
    return json.loads((ROOT / "benchmark" / "limits" /
                       f"{workload}.json").read_text())


def checks(values: dict, limits: dict) -> list[Check]:
    """The compared numbers with their limits (every limit must be
    read)."""
    missing = set(limits) - set(values)
    if missing:
        raise RuntimeError(f"no reading for the limits {sorted(missing)}")
    return [Check(name, float(values[name]), float(limits[name]))
            for name in limits]


# ----------------------------------------------------------------- traces


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """The device activity of a traced window (microseconds on the
    profiler's clock): kernel events, host operations and the window."""

    start: float
    end: float
    kernels: list  # (name, start, duration)
    host_ops: list  # (name, start, duration)

    @classmethod
    def from_events(cls, events: list, window: str) -> "Trace":
        marks = [e for e in events if e.get("name") == window
                 and e.get("ph") == "X" and e.get("cat") in
                 ("user_annotation", "cpu_op")]
        if not marks:
            raise RuntimeError(f"the trace has no {window!r} annotation")
        start = float(marks[0]["ts"])
        end = start + float(marks[0]["dur"])
        kernels, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts >= end or ts + dur <= start:
                continue
            if e.get("cat") == "kernel":
                kernels.append((e["name"], ts, dur))
            elif e.get("cat") in ("cpu_op", "user_annotation",
                                  "cuda_runtime", "python_function"):
                if e["name"] != window:
                    host.append((e["name"], ts, dur))
        return cls(start, end, kernels, host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union((max(ts, self.start), min(ts + d, self.end))
                      for _, ts, d in self.kernels)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_share(self) -> float | None:
        """% of the window in which no kernel ran; None without kernels."""
        if not self.kernels:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """Summed device time and count of the kernels whose names hold
        one of ``patterns``."""
        hits = [d for name, _, d in self.kernels
                if any(p in name for p in patterns)]
        return sum(hits) * 1e-6, len(hits)

    def top_kernels(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, _, d in self.kernels:
            by[name[:160]] = by.get(name[:160], 0.0) + d * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no kernel running, each named by
        the innermost host operation running at its start."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals() + [(self.end, self.end)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            running = [(ts, d, name) for name, ts, d in self.host_ops
                       if ts <= s < ts + d]
            name = min(running, key=lambda r: r[1])[2] if running else "host"
            out.append([name[:160], (e - s) * 1e-6])
        return out


@contextlib.contextmanager
def traced(device, window: str, out_dir: Path):
    """Profile the block (CPU and CUDA activity) inside an annotation
    named ``window``; yields a list that holds the :class:`Trace` once the
    block has ended.  The Chrome trace is written to ``out_dir`` and
    deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    result: list = []
    prof = profile(activities=activities)
    prof.start()
    try:
        with record_function(window):
            yield result
    finally:
        prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    result.append(Trace.from_events(events, window))
