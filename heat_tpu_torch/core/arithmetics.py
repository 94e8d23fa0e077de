"""Arithmetic operations (heat_tpu ``core/arithmetics.py``).

Every function funnels through the op engine (:mod:`._operations`) with
heat_tpu's result types. Integer division and remainder by zero: torch
raises ``ZeroDivisionError`` for a CPU integer tensor (``jnp`` returns a
value), and a card tensor gives an unspecified value. ``diff`` along the
split axis runs heat_tpu's window fetch (:func:`._manips.split_diff`), its
``prepend``/``append`` the distributed concatenation.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = [
    "add", "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor", "cumprod",
    "cumproduct", "cumsum", "diff", "div", "divide", "ediff1d", "floor_divide", "floordiv", "fmod", "heaviside",
    "invert", "left_shift", "mod", "mul", "multiply", "nancumprod", "nancumsum", "neg",
    "negative", "pos", "positive", "pow", "power", "prod", "remainder", "right_shift", "sub",
    "subtract", "sum",
]


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise addition (heat_tpu ``arithmetics.py:57``)."""
    return _operations._binary_op(torch.add, t1, t2, out, where)


def _check_int_args(t1, t2, name):
    for t in (t1, t2):
        if isinstance(t, DNDarray) and not types.heat_type_is_exact(t.dtype):
            raise TypeError(f"{name} is only supported for integer or boolean arrays")
        if isinstance(t, float):
            raise TypeError(f"{name} is only supported for integer or boolean operands")


def bitwise_and(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise AND of integer or bool arrays (heat_tpu ``:62``)."""
    _check_int_args(t1, t2, "bitwise_and")
    return _operations._binary_op(torch.bitwise_and, t1, t2, out, where)


def bitwise_or(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise OR (heat_tpu ``:68``)."""
    _check_int_args(t1, t2, "bitwise_or")
    return _operations._binary_op(torch.bitwise_or, t1, t2, out, where)


def bitwise_xor(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise XOR (heat_tpu ``:74``)."""
    _check_int_args(t1, t2, "bitwise_xor")
    return _operations._binary_op(torch.bitwise_xor, t1, t2, out, where)


# torch scans along a leading axis with one thread per trailing element, in
# sequence down the axis: with few trailing elements that is a handful of
# threads (torch.cumsum along axis 0 of 2^23 x 64 float32 took 3.0 s on an
# "NVIDIA H100 80GB HBM3, 700.00 W"; these blocks 3.8 ms). An axis longer
# than _SCAN_BLOCK is scanned in blocks of that length, all at once, and
# each block is then combined with the scan of the totals of the blocks
# before it (the same scheme again, for a long run of blocks).
_SCAN_BLOCK = 1024


def _scan(fn, combine, neutral, t: torch.Tensor, dim: int) -> torch.Tensor:
    # jnp keeps an integer type (int32 stays int32) and takes bool as int64
    dtype = torch.int64 if t.dtype == torch.bool else t.dtype
    dim %= max(t.ndim, 1)
    n = t.shape[dim] if t.ndim else 1
    trailing = int(np.prod(t.shape[dim + 1:]))
    if t.ndim == 0 or n <= _SCAN_BLOCK:
        return fn(t, dim, dtype=dtype)
    x = t.reshape(-1, n, trailing).to(dtype)
    blocks = -(-n // _SCAN_BLOCK)
    pad = blocks * _SCAN_BLOCK - n
    if pad:
        x = torch.cat([x, x.new_full((x.shape[0], pad, trailing), neutral)], dim=1)
    inner = fn(x.view(x.shape[0], blocks, _SCAN_BLOCK, trailing), 2, dtype=dtype)
    totals = _scan(fn, combine, neutral, inner[:, :, -1], 1)
    prior = torch.cat([totals.new_full(totals[:, :1].shape, neutral), totals[:, :-1]], dim=1)
    out = combine(inner, prior.unsqueeze(2)).view(x.shape)
    return out[:, :n].reshape(t.shape)


def _cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    return _scan(torch.cumsum, torch.add, 0, t, dim)


def _cumprod(t: torch.Tensor, dim: int) -> torch.Tensor:
    return _scan(torch.cumprod, torch.mul, 1, t, dim)


def cumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis`` (heat_tpu ``:88``); along the split
    axis one exclusive scan of the ranks' products."""
    return _operations._cum_op(a, _cumprod, axis, 1, out, dtype, combine="prod")


cumproduct = cumprod


def cumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis`` (heat_tpu ``:96``); along the split
    axis one exclusive scan of the ranks' sums."""
    return _operations._cum_op(a, _cumsum, axis, 0, out, dtype, combine="sum")


def _nan_filled(a: DNDarray, fill) -> DNDarray:
    """``a`` with its NaNs replaced by ``fill``."""
    return _operations._local_op(lambda t: torch.where(torch.isnan(t), fill, t), a)


def nancumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum with NaNs taken as zero (heat_tpu ``:101``)."""
    if types.heat_type_is_exact(a.dtype):
        return cumsum(a, axis, dtype=dtype, out=out)
    return cumsum(_nan_filled(a, 0.0), axis, dtype=dtype, out=out)


def nancumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product with NaNs taken as one (heat_tpu ``:111``)."""
    if types.heat_type_is_exact(a.dtype):
        return cumprod(a, axis, dtype=dtype, out=out)
    return cumprod(_nan_filled(a, 1.0), axis, dtype=dtype, out=out)


def div(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise true division (heat_tpu ``:226``): exact types divide as
    floats (int32 / int32 is float32, int64 float64)."""
    return _operations._binary_op(torch.true_divide, t1, t2, out, where, rule="inexact")


divide = div


def floordiv(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise floor division (heat_tpu ``:234``); bool operands
    divide as int32. For a zero integer divisor see the module's note."""
    return _operations._binary_op(torch.floor_divide, t1, t2, out, where, rule="int_bool")


floor_divide = floordiv


def fmod(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise C-style remainder (heat_tpu ``:242``)."""
    return _operations._binary_op(torch.fmod, t1, t2, out, where, rule="int_bool")


def invert(a: DNDarray, out=None) -> DNDarray:
    """Element-wise bitwise NOT of integer or bool arrays (heat_tpu ``:247``)."""
    if not types.heat_type_is_exact(a.dtype):
        raise TypeError("invert is only supported for integer or boolean arrays")
    return _operations._local_op(torch.bitwise_not, a, out)


bitwise_not = invert


def left_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise left shift (heat_tpu ``:257``)."""
    _check_int_args(t1, t2, "left_shift")
    return _operations._binary_op(torch.bitwise_left_shift, t1, t2, out, where,
                                  rule="int_bool")


def mod(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise Python-style modulo (heat_tpu ``:263``). For a zero
    integer divisor see the module's note."""
    return _operations._binary_op(torch.remainder, t1, t2, out, where, rule="int_bool")


remainder = mod


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise multiplication (heat_tpu ``:271``)."""
    return _operations._binary_op(torch.mul, t1, t2, out, where)


multiply = mul


def neg(a: DNDarray, out=None) -> DNDarray:
    """Element-wise negation (heat_tpu ``:279``)."""
    return _operations._local_op(torch.neg, a, out)


negative = neg


def _positive(t: torch.Tensor) -> torch.Tensor:
    return t.clone()


def pos(a: DNDarray, out=None) -> DNDarray:
    """Element-wise unary plus (heat_tpu ``:287``)."""
    return _operations._local_op(_positive, a, out)


positive = pos


def pow(t1, t2, out=None, where=None) -> DNDarray:  # noqa: A001
    """Element-wise power (heat_tpu ``:295``); bool operands as int32."""
    return _operations._binary_op(torch.pow, t1, t2, out, where, rule="int_bool")


power = pow


def prod(a: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """Product reduction (heat_tpu ``:303``): exact types multiply in int64;
    along the split axis one all-reduce of the partial products."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(a, _prod, 1, axis=axis, out=out, keepdims=keepdims,
                                  reduction="prod")


def _prod(t: torch.Tensor, dim, keepdim: bool) -> torch.Tensor:
    # torch.prod takes one dim at a time
    for d in sorted(dim, reverse=True):
        t = torch.prod(t, d, keepdim=keepdim)
    return t if dim else torch.prod(t)


def right_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise right shift (heat_tpu ``:313``)."""
    _check_int_args(t1, t2, "right_shift")
    return _operations._binary_op(torch.bitwise_right_shift, t1, t2, out, where,
                                  rule="int_bool")


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise subtraction (heat_tpu ``:319``)."""
    return _operations._binary_op(torch.sub, t1, t2, out, where)


subtract = sub


def sum(a: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:  # noqa: A001
    """Sum reduction (heat_tpu ``:327``): exact types sum in int64; along
    the split axis one all-reduce of the partial sums."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(a, torch.sum, 0, axis=axis, out=out, keepdims=keepdims,
                                  reduction="sum")


def heaviside(x1, x2, out=None) -> DNDarray:
    """Heaviside step function (heat_tpu ``:339``): exact types as floats."""
    return _operations._binary_op(torch.heaviside, x1, x2, out, rule="inexact")


def diff(a: DNDarray, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """The ``n``-th discrete difference along ``axis`` (heat_tpu
    ``arithmetics.py:149``): along the split axis, ``n`` window fetches
    (``out[g] = in[g+1] - in[g]``, bool ``!=``) after ``prepend``/``append``
    join by the ring concatenation; along another axis, on the shard."""
    from . import _manips, manipulations
    from .stride_tricks import sanitize_axis

    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    axis = sanitize_axis(a.shape, axis)
    if a.split is not None and a.comm.size > 1 and a.shape[axis] > 1:
        if prepend is not None or append is not None:
            for val, front in ((prepend, True), (append, False)):
                if val is None:
                    continue
                # promote, never truncate: diff(int, prepend=0.5) is float
                vt = val.larray if isinstance(val, DNDarray) else torch.as_tensor(
                    np.asarray(val))
                pdt = types.canonical_heat_type(torch.promote_types(a.larray.dtype, vt.dtype))
                if pdt is not a.dtype:
                    a = a.astype(pdt)
                if isinstance(val, DNDarray) and val.ndim:
                    vd = val.astype(pdt)
                else:
                    # a scalar broadcasts to one slice along the axis, as in numpy
                    if isinstance(val, DNDarray):
                        vt = val._logical()
                    if vt.ndim == 0:
                        vt = vt.expand(tuple(1 if i == axis else s
                                             for i, s in enumerate(a.gshape)))
                    vd = DNDarray.from_global(vt.to(device=a.larray.device,
                                                    dtype=pdt.torch_type()), None, a.device,
                                              a.comm)
                pair = [vd.resplit(a.split), a] if front else [a, vd.resplit(a.split)]
                a = manipulations.concatenate(pair, axis=axis)
            return diff(a, n=n, axis=axis)
        if axis != a.split:
            gshape = tuple(s - n if i == axis else s for i, s in enumerate(a.gshape))
            if gshape[axis] <= 0:
                return diff(a.resplit(None), n=n, axis=axis)
            return DNDarray(torch.diff(a.larray, n=n, dim=axis), gshape, a.dtype, a.split,
                            a.device, a.comm)
        if a.shape[axis] - n <= 0:
            gshape = tuple(0 if i == axis else s for i, s in enumerate(a.gshape))
            return DNDarray.from_global(a.larray.new_zeros(gshape), None, a.device, a.comm)
        out = a
        for _ in range(n):
            local = _manips.split_diff(out.larray, axis, out.shape[axis], out.comm)
            gshape = tuple(s - 1 if i == axis else s for i, s in enumerate(out.gshape))
            out = DNDarray(local, gshape, out.dtype, axis, out.device, out.comm)
        return out
    kwargs = {}
    for name, val in (("prepend", prepend), ("append", append)):
        if val is not None:
            t = val._logical() if isinstance(val, DNDarray) else torch.as_tensor(np.asarray(val))
            if t.ndim == 0:
                t = t.expand(tuple(1 if i == axis else s for i, s in enumerate(a.gshape)))
            kwargs[name] = t.to(a.larray.device)
    logical = a._logical()
    if kwargs:
        # as jnp.diff promotes: a python scalar is weakly typed, an array is not
        pdt = a.dtype
        for val, t in zip((v for v in (prepend, append) if v is not None), kwargs.values()):
            pdt = _operations._scalar_type(pdt, val) if isinstance(
                val, (bool, int, float, complex)) else types.canonical_heat_type(
                torch.promote_types(pdt.torch_type(), t.dtype))
        logical = logical.to(pdt.torch_type())
        kwargs = {k: v.to(pdt.torch_type()) for k, v in kwargs.items()}
    res = torch.diff(logical, n=n, dim=axis, **kwargs)
    split = a.split
    if split is not None and res.shape[split] == 0:
        split = None
    return DNDarray.from_global(res, split, a.device, a.comm)


def ediff1d(ary: DNDarray, to_end=None, to_begin=None) -> DNDarray:
    """Differences of the flattened array with optional tails
    (``numpy.ediff1d``, heat_tpu ``arithmetics.py:121``)."""
    from . import factories, manipulations

    d = diff(manipulations.flatten(ary))

    def tail(v, name):
        arr = np.ravel(np.asarray(v))
        want = np.dtype(str(d.larray.dtype).replace("torch.", "")) \
            if d.larray.dtype != torch.bfloat16 else np.dtype(np.float32)
        if not np.can_cast(arr.dtype, want, casting="same_kind"):
            raise TypeError(f"dtype of {name} ({arr.dtype}) is not compatible with the "
                            f"difference dtype ({d.dtype}) under the same_kind rule")
        return factories.array(arr, dtype=d.dtype, device=ary.device, comm=ary.comm)

    parts = ([tail(to_begin, "to_begin")] if to_begin is not None else []) + [d] + \
        ([tail(to_end, "to_end")] if to_end is not None else [])
    return manipulations.concatenate(parts, axis=0) if len(parts) > 1 else d
