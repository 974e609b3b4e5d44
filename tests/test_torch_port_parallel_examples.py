"""The port's three parallel examples run as a user runs them: ``python -m
tq_tpu_torch.examples.<name> --world 2 --device cpu`` (two gloo ranks
started by ``parallel/launch.py``), and one under ``torchrun``; each
prints the line its JAX twin prints (tests/test_examples.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = [
    ("sharded_inference", "served 100 requests"),
    ("pipeline_inference", "pipelined 8 microbatches"),
    ("lm_serving", "served 51 generation requests"),
]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("name,expect", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_two_ranks(name, expect):
    out = _run([sys.executable, "-m", f"tq_tpu_torch.examples.{name}",
                "--world", "2", "--device", "cpu"])
    assert expect in out, out[-2000:]
    assert out.count(expect) == 1  # printed by rank 0 alone


def test_example_runs_under_torchrun():
    out = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m",
                "tq_tpu_torch.examples.sharded_inference", "--device", "cpu"])
    assert out.count("served 100 requests") == 1, out[-2000:]
