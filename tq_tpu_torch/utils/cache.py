"""Where the compiled kernels are kept.

Port of ``tq_tpu.utils.cache``.  The JAX package's function turns on
XLA's persistent compilation cache.  The port's one compiled artifact is
the kernel library, which ``kernels/_build.py`` names by a hash of its
sources and flags and keeps in ``tq_tpu_torch/_build/``: a re-run of the
same checkout loads it without compiling.  Call before the first kernel
launch.
"""

from __future__ import annotations

from pathlib import Path

from tq_tpu_torch.kernels import _build

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(path: str | None = None) -> Path:
    """The directory the kernel library is built into and loaded from;
    given ``path``, that directory, for the rest of this process."""
    if path is not None:
        _build.BUILD_DIR = Path(path)
    return _build.BUILD_DIR
