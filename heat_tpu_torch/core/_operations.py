"""The op engine (heat_tpu ``core/_operations.py``): the four generic
wrappers the DNDarray operations funnel through, and ``out=``/``where=``.

heat_tpu leaves the cross-device reduction to GSPMD; here it is written out
as the original Heat does it: a local partial reduction on the shard, then
one all-reduce when the reduced axes include the split axis. A cumulative
operation along the split axis adds the exclusive scan of the ranks'
totals (one collective, :meth:`TorchCommunication.Exscan`).

Result types are heat_tpu's (JAX with x64), not torch's: two arrays
promote as ``torch.promote_types`` does (JAX's lattice gives the same over
the heat types), a python scalar is weakly typed (:func:`_scalar_type`),
and each operation names its rule (:func:`_compute_type`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = []

# JAX's inexact type of each exact type (x64: int64 → float64, the
# narrower integers and bool → float32)
_INEXACT = {torch.bool: torch.float32, torch.uint8: torch.float32, torch.int8: torch.float32,
            torch.int16: torch.float32, torch.int32: torch.float32, torch.int64: torch.float64}


def _inexact(dtype: torch.dtype) -> torch.dtype:
    return _INEXACT.get(dtype, dtype)


def _compute_type(rule: str, dtype: torch.dtype) -> torch.dtype:
    """The type an operation computes in, from the promoted type of its
    operands: ``"promote"`` keeps it (add, mul, comparisons, ...),
    ``"inexact"`` makes exact types floating (true division, arctan2, ...),
    ``"int_bool"`` computes bool operands as int32 (floor division, mod,
    power, shifts), as ``jnp`` does."""
    if rule == "inexact":
        return _inexact(dtype)
    if rule == "int_bool" and dtype == torch.bool:
        return torch.int32
    return dtype


def _split_in_output(split, ndim_in: int, ndim_out: int):
    return None if split is None else split + (ndim_out - ndim_in)


# the type of each kind of python scalar where it outranks the array's kind
_SCALAR_DEFAULT = {1: types.int64, 2: types.float64, 3: types.complex128}


def _scalar_type(dtype, scalar):
    """The type of an array of ``dtype`` combined with a python bool, int,
    float or complex, as heat_tpu's JAX operations give it (a weak-typed
    scalar under x64): the array's type, unless the scalar is of a higher
    kind (bool < int < float < complex); then int64 for an int, float64 for
    a float, and for a complex the complex type of a floating array's width
    (complex128 beside float64 or an exact type, else complex64)."""
    kind = types._kind_rank(types.canonical_heat_type(type(scalar)))
    own = types._kind_rank(dtype)
    if kind <= own:
        return dtype
    if kind == 3 and own == 2 and dtype is not types.float64:
        return types.complex64
    return _SCALAR_DEFAULT[kind]


# what a binary operation takes beside a DNDarray (DNDarray's comparisons
# return NotImplemented for anything else)
OPERAND_TYPES = (DNDarray, bool, int, float, complex, np.generic, np.ndarray, list, tuple,
                 torch.Tensor)


def _operand(t, like: DNDarray):
    """A binary operand as the engine takes it: a DNDarray or a python
    scalar as they are; numpy scalars, arrays, tensors and sequences as a
    replicated DNDarray of their own type (numpy's for python data)."""
    if not isinstance(t, OPERAND_TYPES):
        raise TypeError(f"operand type not supported: {type(t)}")
    if isinstance(t, DNDarray) or (isinstance(t, (bool, int, float, complex))
                                   and not isinstance(t, np.generic)):
        return t
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))
    return DNDarray.from_global(t.to(like.larray.device), None, like.device, like.comm)


def __binary_op(operation: Callable, t1, t2, out: Optional[DNDarray] = None, where=None,
                fn_kwargs: Optional[dict] = None, rule: str = "promote") -> DNDarray:
    """Elementwise binary operation (heat_tpu ``_operations.py:61``) of a
    DNDarray with a scalar or another DNDarray, computed in
    :func:`_compute_type` of the operands' promoted type; a python scalar
    becomes a 0-d CPU tensor of that type (rounded to it first, as JAX
    rounds a weak scalar).

    Distribution, as heat_tpu's: a split operand of extent 1 along its
    split axis, where the output is longer, is replicated first; two
    different splits align the second operand to the first one's split
    axis (ONE all-to-all), or replicate it where it spans no such axis; a
    replicated operand is cut to the split operand's chunk locally."""
    fn_kwargs = fn_kwargs or {}
    if isinstance(t1, DNDarray):
        t2 = _operand(t2, t1)
    elif isinstance(t2, DNDarray):
        t1 = _operand(t1, t2)
    else:
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")

    if not isinstance(t1, DNDarray) or not isinstance(t2, DNDarray):
        x = t1 if isinstance(t1, DNDarray) else t2
        other = t2 if x is t1 else t1
        ct = _compute_type(rule, _scalar_type(x.dtype, other).torch_type())
        local = x.larray.to(ct)
        scalar = torch.tensor(other, dtype=ct)
        res = (operation(local, scalar, **fn_kwargs) if x is t1
               else operation(scalar, local, **fn_kwargs))
        result = DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split,
                          x.device, x.comm)
        return _finalize(result, out, where)

    out_shape = broadcast_shape(t1.shape, t2.shape)
    ndim = len(out_shape)
    s1 = _split_in_output(t1.split, t1.ndim, ndim)
    s2 = _split_in_output(t2.split, t2.ndim, ndim)
    # an operand split along an axis it broadcasts over holds its one row on
    # one rank only: replicate it (heat_tpu ``_operations.py:124-133``)
    if s1 is not None and t1.shape[t1.split] == 1 and out_shape[s1] != 1:
        t1, s1 = t1.resplit(None), None
    if s2 is not None and t2.shape[t2.split] == 1 and out_shape[s2] != 1:
        t2, s2 = t2.resplit(None), None
    if s1 is not None and s2 is not None and s1 != s2:
        ax2 = s1 - (ndim - t2.ndim)
        t2 = t2.resplit(ax2 if ax2 >= 0 and t2.shape[ax2] == out_shape[s1] else None)
        s2 = _split_in_output(t2.split, t2.ndim, ndim)
    out_split = s1 if s1 is not None else s2
    ct = _compute_type(rule, torch.promote_types(t1.larray.dtype, t2.larray.dtype))
    p1, p2 = t1.larray.to(ct), t2.larray.to(ct)
    if out_split is not None:
        # a replicated operand spanning the split axis keeps only this
        # rank's chunk of it; one broadcasting over that axis stays whole
        for i, (t, s) in enumerate(((t1, s1), (t2, s2))):
            ax = out_split - (ndim - t.ndim)
            if s is None and ax >= 0 and t.shape[ax] == out_shape[out_split] != 1:
                _, _, slices = t.comm.chunk(t.shape, ax)
                if i == 0:
                    p1 = p1[slices]
                else:
                    p2 = p2[slices]
    res = operation(p1, p2, **fn_kwargs)
    result = DNDarray(res, out_shape, types.canonical_heat_type(res.dtype), out_split,
                      t1.device, t1.comm)
    return _finalize(result, out, where)


def _finalize(result: DNDarray, out: Optional[DNDarray], where=None) -> DNDarray:
    """``out=``/``where=`` (heat_tpu ``_operations.py:200``): without them
    the result itself; with ``out`` the result written into it in its type
    (``out`` first moved to the result's split); with ``where`` as well,
    only where the mask holds, ``out`` keeping its split and its values
    elsewhere."""
    if where is not None:
        if out is None:
            raise ValueError("'where' requires 'out' to be specified")
        mask = _align_where_mask(where, out)
        aligned = result.resplit(out.split) if result.split != out.split else result
        out.larray = torch.where(mask, aligned.larray.to(out.larray.dtype), out.larray)
        return out
    if out is not None:
        sanitation.sanitize_out(out, result.shape, result.split, result.device)
        out.larray = result.larray.to(out.larray.dtype)
        return out
    return result


def _align_where_mask(where, out: DNDarray) -> torch.Tensor:
    """The ``where=`` mask as a bool tensor aligned with ``out``'s shard
    (heat_tpu ``_operations.py:228``): a DNDarray of ``out``'s shape moves
    to its split; any other mask (a broadcasting DNDarray, an array, a
    scalar) is taken whole and cut to ``out``'s chunk where it spans the
    split axis."""
    if isinstance(where, DNDarray):
        if where.gshape == tuple(out.gshape):
            if where.split != out.split:
                where = where.resplit(out.split)
            return where.larray.to(torch.bool)
        mask = where._logical()
    else:
        mask = torch.as_tensor(np.asarray(where))
    mask = mask.to(device=out.larray.device, dtype=torch.bool)
    if out.split is not None:
        ax = out.split - (out.ndim - mask.ndim)
        if ax >= 0 and mask.shape[ax] == out.gshape[out.split] != 1:
            _, _, slices = out.comm.chunk(mask.shape, ax)
            mask = mask[slices]
    return mask


def __local_op(operation: Callable, x: DNDarray, out: Optional[DNDarray] = None,
               **kwargs) -> DNDarray:
    """Elementwise operation on the shard, no communication (heat_tpu
    ``_operations.py:252``). ``operation`` gives the result its type."""
    sanitation.sanitize_in(x)
    res = operation(x.larray, **kwargs)
    result = DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split,
                      x.device, x.comm)
    return _finalize(result, out)


def __reduce_op(x: DNDarray, partial_op: Callable, neutral, axis=None,
                out: Optional[DNDarray] = None, keepdims: bool = False,
                reduction: str = "sum", **kwargs) -> DNDarray:
    """Reduction (heat_tpu ``_operations.py:280``): ``partial_op`` (taking
    ``dim``, a tuple, and ``keepdim``) on the shard; when the split axis is
    reduced, ONE all-reduce with ``reduction`` (sum/prod/min/max) combines
    the partials. An empty shard contributes the ``neutral`` element. A
    floating min or max carries its NaNs through the all-reduce (the
    partials and a NaN flag travel as one tensor), since a NaN is the
    result wherever one occurs, as ``jnp``'s reductions give it."""
    res, gshape, out_split, touches_split = _reduce_partial(x, partial_op, neutral, axis,
                                                           keepdims, **kwargs)
    if touches_split and x.comm.size > 1:
        if reduction in ("min", "max") and res.is_floating_point():
            res = _allreduce_keeping_nan(x.comm, res, reduction)
        else:
            res = x.comm.Allreduce(res.contiguous(), reduction)
    result = DNDarray(res, gshape, types.canonical_heat_type(res.dtype), out_split,
                      x.device, x.comm)
    return _finalize(result, out)


def _reduce_partial(x: DNDarray, partial_op: Callable, neutral, axis, keepdims: bool,
                    **kwargs):
    """This rank's partial of a reduction, before any collective: returns
    ``(partial, gshape, out_split, touches_split)``."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    axes = tuple(range(x.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else axis)
    touches_split = x.split is not None and x.split in axes
    if x.split is None or touches_split:
        out_split = None
    elif keepdims:
        out_split = x.split
    else:
        out_split = x.split - sum(1 for a in axes if a < x.split)
    if keepdims:
        gshape = tuple(1 if i in axes else s for i, s in enumerate(x.shape))
    else:
        gshape = tuple(s for i, s in enumerate(x.shape) if i not in axes)
    local = x.larray
    if touches_split and local.shape[x.split] == 0:
        shp = list(local.shape)
        shp[x.split] = 1
        local = torch.full(shp, neutral, dtype=local.dtype, device=local.device)
    res = partial_op(local, dim=axes, keepdim=keepdims, **kwargs)
    return res, gshape, out_split, touches_split


def _allreduce_keeping_nan(comm, res: torch.Tensor, reduction: str) -> torch.Tensor:
    nan = torch.isnan(res)
    sign = 1.0 if reduction == "max" else -1.0
    packed = torch.stack([torch.where(nan, -sign * float("inf"), res),
                          nan.to(res.dtype) * sign])
    comm.Allreduce(packed, reduction)
    return torch.where(packed[1] != 0, float("nan"), packed[0])


def __cum_op(x: DNDarray, partial_op: Callable, axis, neutral, out: Optional[DNDarray] = None,
             dtype=None, combine: str = "sum") -> DNDarray:
    """Cumulative operation (heat_tpu ``_operations.py:343``):
    ``partial_op(tensor, dim)`` on the shard; along the split axis each
    rank then ``combine``s (sum or prod) its result with the exclusive scan
    of the ranks' totals — ONE collective
    (:meth:`TorchCommunication.Exscan` of each rank's last slice; an empty
    shard's total is ``neutral``). ``dtype`` casts the result."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative over flattened array: call flatten() first")
    res = partial_op(x.larray, axis)
    if x.split == axis and x.comm.size > 1:
        if res.shape[axis] > 0:
            total = res.select(axis, -1)
        else:
            shape = tuple(s for i, s in enumerate(res.shape) if i != axis)
            total = torch.full(shape, neutral, dtype=res.dtype, device=res.device)
        prior = x.comm.Exscan(total, combine).unsqueeze(axis)
        res = res + prior if combine == "sum" else res * prior
    if dtype is not None:
        res = res.to(types.canonical_heat_type(dtype).torch_type())
    result = DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split,
                      x.device, x.comm)
    return _finalize(result, out)


_binary_op = __binary_op
_local_op = __local_op
_reduce_op = __reduce_op
_cum_op = __cum_op
