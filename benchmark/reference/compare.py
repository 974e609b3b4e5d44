"""How far an output lies from the reference's."""

from __future__ import annotations


def gap(got, want) -> float:
    """The widest gap between ``got`` and ``want``, as a share of
    ``want``'s largest magnitude; infinite where ``got`` is missing, the
    shapes differ or a value is not a number."""
    if got is None or got.shape != want.shape:
        return float("inf")
    value = float((got - want).abs().max() / want.abs().max())
    return value if value == value else float("inf")
