"""Shape/axis sanitation helpers (heat_tpu ``core/stride_tricks.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape",
           "sanitize_slice"]


def broadcast_shape(shape_a, shape_b) -> Tuple[int, ...]:
    """NumPy broadcast of two shapes (heat_tpu ``stride_tricks.py:13``);
    ``ValueError`` where they do not broadcast."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError as exc:
        raise ValueError(
            f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}"
        ) from exc


def broadcast_shapes(*shapes) -> Tuple[int, ...]:
    """NumPy broadcast of any number of shapes (heat_tpu
    ``stride_tricks.py:23``)."""
    try:
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError as exc:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}") from exc


def sanitize_axis(shape, axis):
    """Normalize a (possibly negative / tuple) axis against ``shape``
    (heat_tpu ``stride_tricks.py:30``)."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        axis = tuple(sanitize_axis(shape, ax) for ax in axis)
        if len(set(axis)) != len(axis):
            raise ValueError("repeated axis")
        return axis
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0:
        if axis in (0, -1):
            return 0
        raise ValueError(f"axis {axis} out of bounds for 0-dimensional array")
    if axis < -ndim or axis >= ndim:
        raise ValueError(f"axis {axis} out of bounds for {ndim}-dimensional array")
    return axis % ndim


def sanitize_shape(shape, lval: int = 0) -> Tuple[int, ...]:
    """Normalize a shape argument (heat_tpu ``stride_tricks.py:53``)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(shape)
    out = []
    for dim in shape:
        if not isinstance(dim, (int, np.integer)):
            raise TypeError(f"expected shape of ints, got {type(dim)}")
        dim = int(dim)
        if dim < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
        out.append(dim)
    return tuple(out)


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """A slice with explicit non-negative bounds for an axis of length
    ``max_dim`` (heat_tpu ``stride_tricks.py:69``)."""
    if not isinstance(sl, slice):
        raise TypeError("can only be applied to slice objects")
    return slice(*sl.indices(max_dim))
