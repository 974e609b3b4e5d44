#!/usr/bin/env python3
"""Where the ``mma`` kernel's time goes: the kernel with parts of it
switched off.

    python3 scripts/probe_mma.py

Copies ``tq_tpu_torch/csrc`` to a temporary directory and builds
``term_matmul_mma.cu`` alone with ``nvcc`` (all builds at once), once for
every combination of three early exits (bit 1: the MMA warps' fragment
loads and MMAs; bit 2: the load warps' widening, split and shared-memory
stores, with the loaded words XOR-ed into one stored word so that the
loads stay live; bit 4: their global loads).  Times each build's
``tq_term_matmul_mma``
by CUDA events (20 launches after 3) in the raw-input f32 variants on
float32, int8, int16, bf16-stored and 9-bit weights at SHAPES, on the
plan ``kernels/term_matmul.py::plan`` gives with the build's own cluster
occupancy.  With a part off the output is wrong, so nothing is checked:
the times only bound each part.  Prints one JSON line: the card's
``nvidia-smi`` name and power limit and µs by ``off=<bits> <variant>
<shape>``.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = "term_matmul_mma.cu"
SHAPES = [(64, 650, 33278), (128, 784, 512), (350, 650, 2600)]
FORMATS = {"f32": 0, "bf16": 1, "int8": 2, "int16": 3, "packed8": 4}
# (text in the kernel, what the probe puts in its place): an early exit
# guarded by one bit of TQ_PROBE.
SWITCHES = [
    ("        if (kk >= rows) break;",
     "        if (kk >= rows || (TQ_PROBE & 1)) break;"),
    # The loads stay live: their words, XOR-ed, are stored instead.
    ("    auto store = [&](int s, const Regs& g) {",
     "    auto store = [&](int s, const Regs& g) {\n"
     "      if (TQ_PROBE & 2) {\n"
     "        uint32_t h = g.s ^ g.a[0] ^ g.a[1] ^ g.a[2] ^ g.a[3];\n"
     "        for (int j = 0; j < kWQuads; ++j)\n"
     "          for (int e = 0; e < E; ++e) h ^= g.b[j][e];\n"
     "        reinterpret_cast<uint32_t*>(slot(s))[p] = h;\n"
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
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import _tm_weights, nvidia_smi_line
    from tq_tpu_torch.kernels import _build
    from tq_tpu_torch.kernels import term_matmul as tm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    operands = {}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device=dev)
        for fmt in FORMATS:
            w, w_sf, _ = _tm_weights(torch, fmt, K, N, gen, dev)
            packed = fmt == "packed8"
            operands[fmt, (M, K, N)] = (
                x, w.lo if packed else w, w.signs if packed else None,
                w.w_sf if packed else w_sf)
    us = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, tmp / f.name)
        libs = build(tmp, _build._nvcc(), list(_build.ARCH_FLAGS))
        for bits, path in libs.items():
            lib = ctypes.CDLL(str(path))
            fn = lib.tq_term_matmul_mma
            fn.argtypes = _build.SIGNATURES["tq_term_matmul_mma"]
            occ = lib.tq_term_matmul_mma_clusters
            occ.argtypes = _build.SIGNATURES["tq_term_matmul_mma_clusters"]
            for (fmt, (M, K, N)), (x, w, signs, w_sf) in operands.items():
                clusters = tuple(occ(FORMATS[fmt], s) for s in range(1, 9))
                p = tm.plan(M, N, K, fmt, "f32", sms, "mma", clusters)
                out = torch.empty(M, N, device=dev)
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    err = fn(x.data_ptr(), w.data_ptr(),
                             signs.data_ptr() if signs is not None else None,
                             None,
                             w_sf.data_ptr() if w_sf is not None else None,
                             out.data_ptr(), M, N, K, 8, 3, FORMATS[fmt], 0,
                             p.splits, p.k_per_split, stream)
                    if err:
                        sys.exit(f"tq_term_matmul_mma: CUDA error {err}")

                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                us[f"off={bits} f32_raw_{fmt} {M}x{K}x{N}"] = (
                    start.elapsed_time(end) / 20 * 1e3)
    print(json.dumps({"card": nvidia_smi_line(),
                      "parts_off": {"1": "mma", "2": "widen+split+store",
                                    "4": "global loads"},
                      "us": us}), flush=True)


if __name__ == "__main__":
    main()
