"""Logical operations (heat_tpu ``core/logical.py``)."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["all", "allclose", "any", "count_nonzero", "in1d", "isclose", "isfinite", "isin",
           "isinf", "isnan", "isneginf", "isposinf", "logical_and", "logical_not", "logical_or", "logical_xor",
           "signbit"]


def _all_op(t: torch.Tensor, dim, keepdim: bool) -> torch.Tensor:
    return torch.all(t != 0, dim=dim, keepdim=keepdim) if dim else (t != 0)


def _any_op(t: torch.Tensor, dim, keepdim: bool) -> torch.Tensor:
    return torch.any(t != 0, dim=dim, keepdim=keepdim) if dim else (t != 0)


def all(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:  # noqa: A001
    """Whether every element is nonzero (heat_tpu ``logical.py:58``); along
    the split axis one all-reduce (a logical and)."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(x, _all_op, 1, axis=axis, out=out, keepdims=keepdims,
                                  reduction="min")


def allclose(x: DNDarray, y: DNDarray, rtol: float = 1e-05, atol: float = 1e-08,
             equal_nan: bool = False) -> bool:
    """Whether ``x`` and ``y`` are close everywhere (heat_tpu ``:69``)."""
    return bool(all(isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)).item())


def any(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:  # noqa: A001
    """Whether any element is nonzero (heat_tpu ``:75``); along the split
    axis one all-reduce (a logical or)."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(x, _any_op, 0, axis=axis, out=out, keepdims=keepdims,
                                  reduction="max")


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Element-wise ``|x - y| <= atol + rtol·|y|`` (heat_tpu ``:84``)."""
    return _operations._binary_op(torch.isclose, x, y, fn_kwargs={
        "rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def isfinite(x: DNDarray) -> DNDarray:
    """Element-wise finiteness (heat_tpu ``:91``)."""
    return _operations._local_op(torch.isfinite, x)


def isinf(x: DNDarray) -> DNDarray:
    """Element-wise infinity test (heat_tpu ``:96``)."""
    return _operations._local_op(torch.isinf, x)


def count_nonzero(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Number of nonzero elements (heat_tpu ``:101``): one distributed sum."""
    from . import arithmetics, types

    return arithmetics.sum((x != 0).astype(types.int64), axis=axis, keepdims=keepdims)


def isnan(x: DNDarray) -> DNDarray:
    """Element-wise NaN test (heat_tpu ``:136``)."""
    return _operations._local_op(torch.isnan, x)


def isneginf(x: DNDarray, out=None) -> DNDarray:
    """Element-wise -inf test (heat_tpu ``:141``)."""
    return _operations._local_op(torch.isneginf, x, out)


def isposinf(x: DNDarray, out=None) -> DNDarray:
    """Element-wise +inf test (heat_tpu ``:146``)."""
    return _operations._local_op(torch.isposinf, x, out)


def logical_and(x, y) -> DNDarray:
    """Element-wise logical AND (heat_tpu ``:151``)."""
    return _operations._binary_op(torch.logical_and, x, y)


def logical_not(x: DNDarray, out=None) -> DNDarray:
    """Element-wise logical NOT (heat_tpu ``:156``)."""
    return _operations._local_op(torch.logical_not, x, out)


def logical_or(x, y) -> DNDarray:
    """Element-wise logical OR (heat_tpu ``:161``)."""
    return _operations._binary_op(torch.logical_or, x, y)


def logical_xor(x, y) -> DNDarray:
    """Element-wise logical XOR (heat_tpu ``:166``)."""
    return _operations._binary_op(torch.logical_xor, x, y)


def _signbit(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t, dtype=torch.bool) if t.dtype == torch.bool else torch.signbit(t)


def signbit(x: DNDarray, out=None) -> DNDarray:
    """Element-wise sign-bit test (heat_tpu ``:171``)."""
    return _operations._local_op(_signbit, x, out)


def isin(element, test_elements, assume_unique: bool = False, invert: bool = False) -> DNDarray:
    """Membership test (heat_tpu ``logical.py:110``): ``test_elements`` is
    the lookup set, replicated (a split DNDarray gathered once);
    ``element`` keeps its split. Both compare in their promoted type; a
    NaN is in no set."""
    from . import factories

    if not isinstance(element, DNDarray):
        element = factories.array(element)
    if isinstance(test_elements, DNDarray):
        table = test_elements._logical()
    else:
        table = torch.as_tensor(np.asarray(test_elements))
    table = table.to(element.larray.device).reshape(-1)

    def member(a):
        ct = torch.promote_types(a.dtype, table.dtype)
        return torch.isin(a.to(ct), table.to(ct), assume_unique=assume_unique, invert=invert)

    return _operations._local_op(member, element)


def in1d(ar1, ar2, assume_unique: bool = False, invert: bool = False) -> DNDarray:
    """1-D membership (heat_tpu ``logical.py:125``): :func:`isin` of the
    flattened ``ar1``."""
    from . import factories, manipulations

    if not isinstance(ar1, DNDarray):
        ar1 = factories.array(ar1)
    return isin(manipulations.flatten(ar1), ar2, assume_unique=assume_unique, invert=invert)
