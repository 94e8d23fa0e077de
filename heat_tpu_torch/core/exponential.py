"""Exponential and logarithmic operations (heat_tpu
``core/exponential.py``). Exact types compute as floats: int64 as float64,
bool and the narrower integers as float32, as ``jnp`` does."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["exp", "exp2", "expm1", "i0", "log", "log10", "log1p", "log2", "logaddexp",
           "logaddexp2", "sqrt", "square"]


def _inexact_op(fn):
    """``fn`` on the tensor in its inexact type."""
    def op(t: torch.Tensor, **kwargs) -> torch.Tensor:
        return fn(t.to(_operations._inexact(t.dtype)), **kwargs)

    op.__name__ = getattr(fn, "__name__", "op")
    return op


_exp = _inexact_op(torch.exp)
_expm1 = _inexact_op(torch.expm1)
_exp2 = _inexact_op(torch.exp2)
_log = _inexact_op(torch.log)
_log2 = _inexact_op(torch.log2)
_log10 = _inexact_op(torch.log10)
_log1p = _inexact_op(torch.log1p)
_sqrt = _inexact_op(torch.sqrt)
_i0 = _inexact_op(torch.special.i0)


def exp(x: DNDarray, out=None) -> DNDarray:
    """Element-wise e**x (heat_tpu ``exponential.py:26``)."""
    return _operations._local_op(_exp, x, out)


def expm1(x: DNDarray, out=None) -> DNDarray:
    """Element-wise e**x - 1 (heat_tpu ``:31``)."""
    return _operations._local_op(_expm1, x, out)


def exp2(x: DNDarray, out=None) -> DNDarray:
    """Element-wise 2**x (heat_tpu ``:36``)."""
    return _operations._local_op(_exp2, x, out)


def log(x: DNDarray, out=None) -> DNDarray:
    """Element-wise natural logarithm (heat_tpu ``:41``)."""
    return _operations._local_op(_log, x, out)


def log2(x: DNDarray, out=None) -> DNDarray:
    """Element-wise base-2 logarithm (heat_tpu ``:46``)."""
    return _operations._local_op(_log2, x, out)


def log10(x: DNDarray, out=None) -> DNDarray:
    """Element-wise base-10 logarithm (heat_tpu ``:51``)."""
    return _operations._local_op(_log10, x, out)


def log1p(x: DNDarray, out=None) -> DNDarray:
    """Element-wise log(1 + x) (heat_tpu ``:56``)."""
    return _operations._local_op(_log1p, x, out)


def logaddexp(x1, x2, out=None, where=None) -> DNDarray:
    """log(exp(x1) + exp(x2)) (heat_tpu ``:61``)."""
    return _operations._binary_op(torch.logaddexp, x1, x2, out, where, rule="inexact")


def logaddexp2(x1, x2, out=None, where=None) -> DNDarray:
    """log2(2**x1 + 2**x2) (heat_tpu ``:66``)."""
    return _operations._binary_op(torch.logaddexp2, x1, x2, out, where, rule="inexact")


def sqrt(x: DNDarray, out=None) -> DNDarray:
    """Element-wise square root (heat_tpu ``:71``)."""
    return _operations._local_op(_sqrt, x, out)


def _square(t: torch.Tensor) -> torch.Tensor:
    # jnp squares bool as int32
    return torch.square(t.to(torch.int32) if t.dtype == torch.bool else t)


def square(x: DNDarray, out=None) -> DNDarray:
    """Element-wise square (heat_tpu ``:76``)."""
    return _operations._local_op(_square, x, out)


def i0(x: DNDarray, out=None) -> DNDarray:
    """Modified Bessel function of the first kind, order 0 (heat_tpu ``:81``)."""
    return _operations._local_op(_i0, x, out)
