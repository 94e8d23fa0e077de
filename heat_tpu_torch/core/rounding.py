"""Rounding operations (heat_tpu ``core/rounding.py``). The rounding
functions leave exact types as they are, as ``jnp`` does."""

from __future__ import annotations

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["abs", "absolute", "ceil", "clip", "copysign", "fabs", "fix", "floor", "modf",
           "nan_to_num", "round", "round_", "sgn", "sign", "trunc"]


def _exact_kept(fn):
    """``fn`` on floating tensors; an exact tensor is copied unchanged."""
    def op(t: torch.Tensor, **kwargs) -> torch.Tensor:
        if t.is_floating_point() or t.is_complex():
            return fn(t, **kwargs)
        return t.clone()

    return op


_abs = _exact_kept(torch.abs)
_ceil = _exact_kept(torch.ceil)
_floor = _exact_kept(torch.floor)
_trunc = _exact_kept(torch.trunc)


def _complex_round(t: torch.Tensor, decimals: int = 0) -> torch.Tensor:
    # the real and imaginary parts round apart, as jnp rounds them
    if t.is_complex():
        return torch.complex(torch.round(t.real, decimals=decimals),
                             torch.round(t.imag, decimals=decimals))
    return torch.round(t, decimals=decimals)


_round = _exact_kept(_complex_round)


def _integral_abs(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.dtype == torch.bool else torch.abs(t)


def abs(x, out=None, dtype=None) -> DNDarray:  # noqa: A001
    """Element-wise absolute value (heat_tpu ``rounding.py:31``); complex
    input gives its real type."""
    res = _operations._local_op(_abs if not types.heat_type_is_exact(x.dtype)
                                else _integral_abs, x, out)
    if dtype is not None:
        res = res.astype(types.canonical_heat_type(dtype), copy=False)
    return res


absolute = abs


def ceil(x: DNDarray, out=None) -> DNDarray:
    """Element-wise ceiling (heat_tpu ``:44``)."""
    return _operations._local_op(_ceil, x, out)


def _clip(t: torch.Tensor, min=None, max=None, dtype=None) -> torch.Tensor:
    return torch.clamp(t if dtype is None else t.to(dtype), min=min, max=max)


def clip(x: DNDarray, min=None, max=None, out=None) -> DNDarray:  # noqa: A002
    """Clamp to ``[min, max]`` (heat_tpu ``:49``); a DNDarray bound is taken
    as this rank's shard of an array split like ``x``."""
    if min is None and max is None:
        raise ValueError("either min or max must be set")
    mn = min.larray if isinstance(min, DNDarray) else min
    mx = max.larray if isinstance(max, DNDarray) else max
    # a python bound of a higher kind than x raises the result type, as a
    # weak-typed scalar does in heat_tpu (an int array clipped to 2.5 is
    # float64)
    dtype = x.dtype
    for bound in (min, max):
        if isinstance(bound, (bool, int, float, complex)):
            dtype = _operations._scalar_type(dtype, bound)
    tdt = None if dtype is x.dtype else dtype.torch_type()
    return _operations._local_op(_clip, x, out, min=mn, max=mx, dtype=tdt)


def copysign(t1, t2) -> DNDarray:
    """Magnitude of ``t1`` with the sign of ``t2`` (heat_tpu ``:62``)."""
    return _operations._binary_op(torch.copysign, t1, t2, rule="inexact")


def fabs(x: DNDarray, out=None) -> DNDarray:
    """Floating absolute value (heat_tpu ``:68``)."""
    return abs(x, out, dtype=None).astype(
        types.promote_types(x.dtype, types.float32), copy=False)


def floor(x: DNDarray, out=None) -> DNDarray:
    """Element-wise floor (heat_tpu ``:76``)."""
    return _operations._local_op(_floor, x, out)


def _modf(t: torch.Tensor):
    t = t.to(_operations._inexact(t.dtype))
    whole = torch.trunc(t)
    frac = torch.where(torch.isinf(t), torch.copysign(torch.zeros_like(t), t), t - whole)
    return frac, whole


def modf(x: DNDarray, out=None) -> tuple:
    """Fractional and integral parts (heat_tpu ``:81``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    frac = _operations._local_op(lambda t: _modf(t)[0], x)
    whole = _operations._local_op(lambda t: _modf(t)[1], x)
    if out is not None:
        if not isinstance(out, tuple) or len(out) != 2:
            raise TypeError("expected out to be None or a tuple of two DNDarrays")
        out[0].larray = frac.larray
        out[1].larray = whole.larray
        return out
    return frac, whole


def round(x: DNDarray, decimals: int = 0, out=None, dtype=None) -> DNDarray:  # noqa: A001
    """Round half to even at ``decimals`` (heat_tpu ``:96``). An exact
    array is its own rounding for ``decimals >= 0``; below that it raises
    ``NotImplementedError``, as ``jnp.round`` does for integers."""
    if decimals < 0 and types.heat_type_is_exact(x.dtype):
        raise NotImplementedError("integer np.round not implemented for decimals < 0")
    res = _operations._local_op(_round, x, out, decimals=decimals)
    if dtype is not None:
        res = res.astype(types.canonical_heat_type(dtype), copy=False)
    return res


def sgn(x: DNDarray, out=None) -> DNDarray:
    """Sign, ``x / |x|`` for complex input (heat_tpu ``:104``)."""
    return _operations._local_op(_sign, x, out)


def sign(x: DNDarray, out=None) -> DNDarray:
    """Sign (heat_tpu ``:109``); for complex input the sign of the real part
    (the imaginary part's where the real one is zero), as ``jnp`` gives it."""
    return _operations._local_op(_sign, x, out)


def _sign(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.sgn(t)
    if t.is_floating_point():
        # torch.sign(nan) is 0; jnp.sign keeps the NaN
        return torch.where(torch.isnan(t), t, torch.sign(t))
    return torch.sign(t)


def trunc(x: DNDarray, out=None) -> DNDarray:
    """Truncate toward zero (heat_tpu ``:114``)."""
    return _operations._local_op(_trunc, x, out)


def fix(x: DNDarray, out=None) -> DNDarray:
    """Round toward zero into a floating type (heat_tpu ``:119``)."""
    res = trunc(x if not types.heat_type_is_exact(x.dtype) else x.astype(types.float32))
    return _operations._finalize(res, out)


def round_(x: DNDarray, decimals: int = 0, out=None) -> DNDarray:
    """Alias of :func:`round` (heat_tpu ``:128``)."""
    return round(x, decimals=decimals, out=out)


def _nan_to_num(t: torch.Tensor, nan=0.0, posinf=None, neginf=None) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        return t.clone()
    return torch.nan_to_num(t, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(x: DNDarray, nan: float = 0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    """NaN and infinities as finite numbers (heat_tpu ``:133``)."""
    return _operations._local_op(_nan_to_num, x, out, nan=nan, posinf=posinf, neginf=neginf)
