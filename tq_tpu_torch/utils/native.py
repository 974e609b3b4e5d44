"""ctypes bindings for the native tr_oracle library.

Port of ``tq_tpu.utils.native``: the same loader of the repository's
``native/build/libtr_oracle.so`` (built with ``make -C native`` when it is
absent) and the same NumPy functions.  The library is the reference's
term reveal in plain C++, a golden model independent of both packages,
fast enough for tensors of millions of elements; the port's tests and
``chip_smoke.py`` hold ``tr_quantize`` against it.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["tr_reveal_native", "hese_term_counts_native"]

_ROOT = Path(__file__).resolve().parents[2]
_LIB_PATH = _ROOT / "native" / "build" / "libtr_oracle.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        subprocess.run(["make", "-C", str(_ROOT / "native")], check=True,
                       capture_output=True)
    _lib = ctypes.CDLL(str(_LIB_PATH))
    _lib.tr_reveal.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    _lib.tr_reveal.restype = None
    _lib.hese_term_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    _lib.hese_term_counts.restype = None
    return _lib


def tr_reveal_native(x: np.ndarray, sf: float, bits: int, group_size: int,
                     num_keep_terms: int) -> np.ndarray:
    """Reference-semantics term reveal over the last axis of ``x``
    (float32), one library call a row."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    flat = x.reshape(-1, x.shape[-1])
    out = np.empty_like(flat)
    ptr = ctypes.POINTER(ctypes.c_float)
    for r in range(flat.shape[0]):
        xi = np.ascontiguousarray(flat[r])
        oi = np.empty_like(xi)
        lib.tr_reveal(xi.ctypes.data_as(ptr), oi.ctypes.data_as(ptr),
                      xi.size, ctypes.c_float(sf), bits, group_size,
                      num_keep_terms)
        out[r] = oi
    return out.reshape(x.shape)


def hese_term_counts_native(q: np.ndarray, bits: int) -> np.ndarray:
    """HESE term count of each non-negative integer of ``q`` (int64)."""
    lib = _load()
    q = np.ascontiguousarray(q, np.int64).reshape(-1)
    counts = np.empty_like(q)
    ptr = ctypes.POINTER(ctypes.c_int64)
    lib.hese_term_counts(q.ctypes.data_as(ptr), counts.ctypes.data_as(ptr),
                         q.size, bits)
    return counts
