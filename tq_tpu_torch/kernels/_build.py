"""Build and load the hand-written CUDA kernels of ``tq_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, which is loaded with ``ctypes``: seconds to build, where an
extension that includes PyTorch's headers takes minutes.  No
``--use_fast_math``: the quantize division must stay correctly rounded.

The library is named by a hash of the sources and flags and written to
``tq_tpu_torch/_build/`` (ignored by git), so an edited source rebuilds
and an unchanged one is compiled once per checkout.  Nothing here runs
at import time: :func:`load` is called by a kernel wrapper the first
time it is given a CUDA tensor.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["load", "check", "library_path", "stream"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# name -> argtypes; every entry point returns a cudaError_t as int.
SIGNATURES = {
    # x, sf, out, head, n_vec, tail, blocks, bits, budget, variant, stream
    "tq_tr_quantize_elementwise": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _I,
                                   _I, _P],
    # x, sf, out, head, n_vec, tail, blocks, stream
    "tq_tr_scale_copy": [_P, _P, _P, _I64, _I64, _I64, _I, _P],
    # variant -> blocks of that element-wise kernel an SM runs at once
    "tq_tr_elementwise_blocks_per_sm": [_I],
    # x, sf, out, outer, n, inner, group_size, bits, budget, serial, stream
    "tq_tr_quantize_grouped": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I,
                               _P],
    # x, w, signs, sf, w_sf, out, M, N, K, bits, budget, mode, wfmt,
    # quantize_x, splits, k_per_split, row_tile, stream
    "tq_term_matmul_stream": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P],
    # x, w, signs, sf, w_sf, out, M, N, K, bits, budget, wfmt, quantize_x,
    # splits, k_per_split, stream
    "tq_term_matmul_mma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    # wfmt, splits -> clusters of the mma kernel the card runs at once
    "tq_term_matmul_mma_clusters": [_I, _I],
    # x, w, signs, sf, w_sf, out, M, N, K, bits, budget, mode, wfmt,
    # quantize_x, splits, k_per_split, stream
    "tq_term_matmul_mma_lp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    # mode, splits -> clusters of the mma_lp kernel the card runs at once
    "tq_term_matmul_mma_lp_clusters": [_I, _I],
    # x, head, n_vec, tail, counts, num_bins, minv, maxv, inv_width,
    # blocks, stream
    "tq_histogram": [_P, _I64, _I64, _I64, _P, _I, _F, _F, _F, _I, _P],
    # x, ends, held, ptrs, w_sf, out, gather, scatter, scale, P, E, N, K,
    # G, tiles, splits, k_per_split, top_k, stream
    "tq_term_matmul_grouped": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P],
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from tq_tpu_torch/csrc")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for s in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libtq_kernels_{h.hexdigest()[:16]}.so"


# Seconds each command of the last build took, by output file name.
compile_seconds: dict[str, float] = {}


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once (each writes the file after its ``-o``);
    note how long each took; raise with the output of any that fails."""
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:
        procs = [subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT)
                 for c in cmds]
        pending = dict(zip(procs, cmds))
        while pending:
            for p in [p for p in pending if p.poll() is not None]:
                cmd = pending.pop(p)
                compile_seconds[Path(cmd[cmd.index("-o") + 1]).name] = (
                    time.perf_counter() - t0)
            time.sleep(0.05)
        log.seek(0)
        out = log.read()
    failed = [f"{' '.join(c)} (exit {p.returncode})"
              for p, c in zip(procs, cmds) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n" + out)


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in _sources()]
        _run_all([[nvcc, *ARCH_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(_sources(), objs)])
        lib = Path(tmp) / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call if it is not on disk."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tq_error_string.argtypes = [_I]
        lib.tq_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stream(device) -> int:
    """The handle of the current stream of ``device`` (a CUDA tensor's,
    with its index), as ``torch.cuda.current_stream(device).cuda_stream``
    gives it, without building that ``torch.cuda.Stream`` object on every
    launch (``chip_smoke.py`` holds the two equal)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = _LIB.tq_error_string(err) if _LIB is not None else b""
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"({(msg or b'').decode()})")
