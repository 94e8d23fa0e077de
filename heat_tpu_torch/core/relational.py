"""Relational operations (heat_tpu ``core/relational.py``): element-wise
comparisons in the operands' promoted type, giving bool."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape

__all__ = ["eq", "equal", "ge", "greater_equal", "gt", "greater", "le", "less_equal", "lt",
           "less", "ne", "not_equal"]


def eq(x, y) -> DNDarray:
    """Element-wise == (heat_tpu ``relational.py:13``)."""
    return _operations._binary_op(torch.eq, x, y)


def equal(x, y) -> bool:
    """True iff ``x`` and ``y`` broadcast together and are equal everywhere
    (heat_tpu ``:18``): one element-wise test and one global ``all``."""
    from . import logical

    if not isinstance(x, DNDarray) and not isinstance(y, DNDarray):
        return bool(np.all(np.equal(np.asarray(x), np.asarray(y))))
    try:
        broadcast_shape(x.shape if isinstance(x, DNDarray) else np.shape(x),
                        y.shape if isinstance(y, DNDarray) else np.shape(y))
    except ValueError:
        return False
    return bool(logical.all(eq(x, y)).item())


def ge(x, y) -> DNDarray:
    """Element-wise >= (heat_tpu ``:38``)."""
    return _operations._binary_op(torch.ge, x, y)


greater_equal = ge


def gt(x, y) -> DNDarray:
    """Element-wise > (heat_tpu ``:46``)."""
    return _operations._binary_op(torch.gt, x, y)


greater = gt


def le(x, y) -> DNDarray:
    """Element-wise <= (heat_tpu ``:54``)."""
    return _operations._binary_op(torch.le, x, y)


less_equal = le


def lt(x, y) -> DNDarray:
    """Element-wise < (heat_tpu ``:62``)."""
    return _operations._binary_op(torch.lt, x, y)


less = lt


def ne(x, y) -> DNDarray:
    """Element-wise != (heat_tpu ``:70``)."""
    return _operations._binary_op(torch.ne, x, y)


not_equal = ne
