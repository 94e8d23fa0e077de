"""Array manipulations (heat_tpu ``core/manipulations.py``). Only
``resplit`` is ported; the rest waits for a later slice."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["resplit"]


def resplit(arr: DNDarray, axis=None) -> DNDarray:
    """Out-of-place split change (heat_tpu ``manipulations.py:705``):
    :meth:`DNDarray.resplit`, one all-to-all from one split axis to another."""
    return arr.resplit(axis)
