"""Trigonometric and hyperbolic operations (heat_tpu
``core/trigonometrics.py``). Exact types compute as floats, as in
:mod:`.exponential`."""

from __future__ import annotations

import math

import torch

from . import _operations
from .dndarray import DNDarray
from .exponential import _inexact_op

__all__ = ["acos", "acosh", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctan2",
           "arctanh", "asin", "asinh", "atan", "atan2", "atanh", "cos", "cosh", "deg2rad",
           "degrees", "hypot", "rad2deg", "radians", "sin", "sinc", "sinh", "tan", "tanh"]



def _scaled(factor, real_fn):
    """Multiplication by ``factor``; torch's own function for real types."""
    def op(t: torch.Tensor) -> torch.Tensor:
        return t * factor if t.is_complex() else real_fn(t)

    return op


_OPS = {name: _inexact_op(getattr(torch, name)) for name in (
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh", "cos", "cosh", "sin", "sinc",
    "sinh", "tan", "tanh")}
_OPS["deg2rad"] = _inexact_op(_scaled(math.pi / 180, torch.deg2rad))
_OPS["rad2deg"] = _inexact_op(_scaled(180 / math.pi, torch.rad2deg))


def arccos(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse cosine (heat_tpu ``trigonometrics.py:40``)."""
    return _operations._local_op(_OPS["arccos"], x, out)


acos = arccos


def arccosh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse hyperbolic cosine (heat_tpu ``:48``)."""
    return _operations._local_op(_OPS["arccosh"], x, out)


acosh = arccosh


def arcsin(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse sine (heat_tpu ``:56``)."""
    return _operations._local_op(_OPS["arcsin"], x, out)


asin = arcsin


def arcsinh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse hyperbolic sine (heat_tpu ``:64``)."""
    return _operations._local_op(_OPS["arcsinh"], x, out)


asinh = arcsinh


def arctan(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse tangent (heat_tpu ``:72``)."""
    return _operations._local_op(_OPS["arctan"], x, out)


atan = arctan


def arctanh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise inverse hyperbolic tangent (heat_tpu ``:80``)."""
    return _operations._local_op(_OPS["arctanh"], x, out)


atanh = arctanh


def hypot(t1, t2) -> DNDarray:
    """Element-wise ``sqrt(t1**2 + t2**2)`` (heat_tpu ``:88``)."""
    return _operations._binary_op(torch.hypot, t1, t2, rule="inexact")


def arctan2(x1, x2) -> DNDarray:
    """Element-wise two-argument inverse tangent (heat_tpu ``:94``)."""
    return _operations._binary_op(torch.arctan2, x1, x2, rule="inexact")


atan2 = arctan2


def cos(x: DNDarray, out=None) -> DNDarray:
    """Element-wise cosine (heat_tpu ``:102``)."""
    return _operations._local_op(_OPS["cos"], x, out)


def cosh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise hyperbolic cosine (heat_tpu ``:107``)."""
    return _operations._local_op(_OPS["cosh"], x, out)


def deg2rad(x: DNDarray, out=None) -> DNDarray:
    """Degrees to radians (heat_tpu ``:112``)."""
    return _operations._local_op(_OPS["deg2rad"], x, out)


radians = deg2rad


def rad2deg(x: DNDarray, out=None) -> DNDarray:
    """Radians to degrees (heat_tpu ``:120``)."""
    return _operations._local_op(_OPS["rad2deg"], x, out)


degrees = rad2deg


def sin(x: DNDarray, out=None) -> DNDarray:
    """Element-wise sine (heat_tpu ``:128``)."""
    return _operations._local_op(_OPS["sin"], x, out)


def sinh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise hyperbolic sine (heat_tpu ``:133``)."""
    return _operations._local_op(_OPS["sinh"], x, out)


def tan(x: DNDarray, out=None) -> DNDarray:
    """Element-wise tangent (heat_tpu ``:138``)."""
    return _operations._local_op(_OPS["tan"], x, out)


def tanh(x: DNDarray, out=None) -> DNDarray:
    """Element-wise hyperbolic tangent (heat_tpu ``:143``)."""
    return _operations._local_op(_OPS["tanh"], x, out)


def sinc(x: DNDarray, out=None) -> DNDarray:
    """Normalized sinc, sin(πx) / (πx) (heat_tpu ``:148``)."""
    return _operations._local_op(_OPS["sinc"], x, out)
