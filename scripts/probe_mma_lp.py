#!/usr/bin/env python3
"""Where the ``mma_lp`` kernel's time goes: the kernel with parts of it
switched off.

    python3 scripts/probe_mma_lp.py [--shape M K N]

Copies ``tq_tpu_torch/csrc`` to a temporary directory, inserts an early
exit into each of three parts of ``term_matmul_mma_lp.cu`` (bit 1: the
MMA warps' fragment loads and MMAs; bit 2: the load warps' reveal,
conversion and shared-memory stores, with the loaded words XOR-ed into
one stored word so that the loads stay live; bit 4: their global
loads), builds the file once for every combination of the bits with
``nvcc`` (all at once), and times each build's ``tq_term_matmul_mma_lp`` by CUDA events
(20 launches after 3) at the shape (default ``bench.py::bench_matmul``'s
(8192, 2048, 512)) in three variants: ``bf16_raw`` and ``bf16`` on
float32 weights (bits 8, 3 terms) and ``int8_int8`` (bits 7, 3 terms).
With a part off the output is wrong, so nothing is checked: the times
only bound each part (all off: the launch, the step barriers and the
epilogue).  Prints one JSON line: the card's ``nvidia-smi`` name and
power limit and µs by ``off=<bits> <variant>``.  Needs one CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = "term_matmul_mma_lp.cu"
# (text in the kernel, what the probe puts in its place): an early exit
# guarded by one bit of TQ_PROBE.
SWITCHES = [
    ("        if (c * kChunkK<MODE> >= rows) break;",
     "        if (c * kChunkK<MODE> >= rows || (TQ_PROBE & 1)) break;"),
    # The loads stay live: their words, XOR-ed, are stored instead.
    ("    auto store = [&](int s, const Regs& g) {",
     "    auto store = [&](int s, const Regs& g) {\n"
     "      if (TQ_PROBE & 2) {\n"
     "        uint32_t h = g.s[0] ^ g.s[1];\n"
     "        for (int i = 0; i < R; ++i)\n"
     "          for (int j = 0; j < 4; ++j) h ^= g.x[i][j];\n"
     "        for (int c = 0; c < 2; ++c)\n"
     "          for (int i = 0; i < R; ++i)\n"
     "            for (int j = 0; j < E; ++j) h ^= g.w[c][i][j];\n"
     "        *reinterpret_cast<uint32_t*>(smem + (s & 1) * kSlot + 4 * p) ="
     " h;\n"
     "        return;\n"
     "      }"),
    ("    auto load = [&](int s, Regs& g) {",
     "    auto load = [&](int s, Regs& g) {\n"
     "      if (TQ_PROBE & 4) return;"),
]


def build(tmp: Path, nvcc: str, arch_flags: list[str]) -> dict[int, Path]:
    src = (tmp / SOURCE).read_text()
    for old, new in SWITCHES:
        if src.count(old) != 1:
            sys.exit(f"{SOURCE} changed: no single {old.strip()!r}")
        src = src.replace(old, new)
    (tmp / SOURCE).write_text(src)
    libs = {bits: tmp / f"probe{bits}.so" for bits in range(8)}
    procs = [subprocess.Popen([nvcc, *arch_flags, "-shared",
                               f"-DTQ_PROBE={bits}", "-o", str(lib),
                               str(tmp / SOURCE)])
             for bits, lib in libs.items()]
    if any(p.wait() != 0 for p in procs):
        sys.exit("nvcc failed")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(8192, 2048, 512),
                    metavar=("M", "K", "N"))
    M, K, N = ap.parse_args().shape

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import nvidia_smi_line
    from tq_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev)
    w32 = torch.randn(K, N, generator=gen, device=dev) * 0.05
    w8 = torch.randint(-127, 128, (K, N), generator=gen,
                       device=dev).to(torch.int8)
    sf = torch.tensor(0.03, device=dev)
    w_sf = torch.tensor(0.0123, device=dev)
    out = torch.empty(M, N, device=dev)
    # variant -> (weights, mode, weight format, quantize_x, bits)
    variants = {"bf16_raw": (w32, 1, 0, 0, 8), "bf16": (w32, 1, 0, 1, 8),
                "int8_int8": (w8, 2, 2, 1, 7)}
    us = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, tmp / f.name)
        libs = build(tmp, _build._nvcc(), list(_build.ARCH_FLAGS))
        for bits, path in libs.items():
            fn = ctypes.CDLL(str(path)).tq_term_matmul_mma_lp
            fn.argtypes = _build.SIGNATURES["tq_term_matmul_mma_lp"]
            for name, (w, mode, fmt, qx, b) in variants.items():
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    err = fn(x.data_ptr(), w.data_ptr(), None, sf.data_ptr(),
                             w_sf.data_ptr(), out.data_ptr(), M, N, K, b, 3,
                             mode, fmt, qx, 1, -(-K // 32) * 32, stream)
                    if err:
                        sys.exit(f"tq_term_matmul_mma_lp: CUDA error {err}")

                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                us[f"off={bits} {name}"] = start.elapsed_time(end) / 20 * 1e3
    print(json.dumps({"card": nvidia_smi_line(), "shape": [M, K, N],
                      "parts_off": {"1": "mma", "2": "convert+store",
                                    "4": "global loads"},
                      "us": us}), flush=True)


if __name__ == "__main__":
    main()
