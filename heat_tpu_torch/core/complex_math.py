"""Complex-number operations (heat_tpu ``core/complex_math.py``)."""

from __future__ import annotations

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t: torch.Tensor, deg: bool = False) -> torch.Tensor:
    # jnp takes the angle of an exact type in float64
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float64)
    res = torch.angle(t)
    return torch.rad2deg(res) if deg else res


def angle(x: DNDarray, deg: bool = False, out=None) -> DNDarray:
    """Element-wise argument, in radians or with ``deg`` in degrees
    (heat_tpu ``complex_math.py:13``)."""
    return _operations._local_op(_angle, x, out, deg=deg)


def _conj(t: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(t) if t.is_complex() else t.clone()


def conjugate(x: DNDarray, out=None) -> DNDarray:
    """Element-wise complex conjugate (heat_tpu ``:18``)."""
    return _operations._local_op(_conj, x, out)


conj = conjugate


def _imag(t: torch.Tensor) -> torch.Tensor:
    return torch.imag(t).clone() if t.is_complex() else torch.zeros_like(t)


def imag(x: DNDarray) -> DNDarray:
    """Imaginary part (heat_tpu ``:26``); zeros of ``x``'s type for real input."""
    return _operations._local_op(_imag, x)


def real(x: DNDarray) -> DNDarray:
    """Real part (heat_tpu ``:31``); ``x`` itself for real input."""
    if issubclass(x.dtype, types.complexfloating):
        return _operations._local_op(lambda t: torch.real(t).clone(), x)
    return x
