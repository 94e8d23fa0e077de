"""Memory helpers (heat_tpu ``core/memory.py``)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy"]


def copy(x: DNDarray) -> DNDarray:
    """A copy of ``x`` that shares no memory with it (heat_tpu
    ``memory.py:23``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    return DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm)
