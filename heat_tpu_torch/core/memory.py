"""Memory helpers (heat_tpu ``core/memory.py``)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout", "sanitize_memory_order"]


def copy(x: DNDarray) -> DNDarray:
    """A copy of ``x`` that shares no memory with it (heat_tpu
    ``memory.py:23``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    return DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm)


def sanitize_memory_order(order: str) -> str:
    """Check an ``order=`` keyword (heat_tpu ``memory.py:12``): ``C``, ``K``
    and ``A`` are the row-major layout every shard has; ``F`` raises
    ``NotImplementedError``, as in heat_tpu."""
    if order not in ("C", "F", "K", "A"):
        raise ValueError(f"order must be one of 'C', 'F', 'K', 'A', got {order!r}")
    if order == "F":
        raise NotImplementedError("column-major layout is not supported")
    return order


def sanitize_memory_layout(x, order: str = "C"):
    """``x`` in the memory ``order`` asked for (heat_tpu ``memory.py:30``):
    row-major only, as :func:`sanitize_memory_order` checks."""
    sanitize_memory_order(order)
    return x
