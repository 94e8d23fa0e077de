"""The op engine (heat_tpu ``core/_operations.py``): the generic wrappers
the DNDarray operations funnel through.

heat_tpu leaves the cross-device reduction to GSPMD; here it is written out
as the original Heat does it: a local partial reduction on the shard, then
one all-reduce when the reduced axes include the split axis.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = []


def _split_in_output(split, ndim_in: int, ndim_out: int):
    return None if split is None else split + (ndim_out - ndim_in)


# the type of each kind of python scalar where it outranks the array's kind
_SCALAR_DEFAULT = {1: types.int64, 2: types.float64}


def _scalar_type(dtype, scalar):
    """The type of an array of ``dtype`` combined with a python bool, int or
    float, as heat_tpu's JAX operations give it (a weak-typed scalar under
    x64): the array's type, unless the scalar is of a higher kind (bool <
    int < float); then int64 for an int, float64 for a float."""
    kind = types._kind_rank(types.canonical_heat_type(type(scalar)))
    return dtype if kind <= types._kind_rank(dtype) else _SCALAR_DEFAULT[kind]


def __binary_op(operation: Callable, t1, t2) -> DNDarray:
    """Elementwise binary operation (heat_tpu ``_operations.py:61``) for a
    DNDarray with a python scalar, or two DNDarrays. With a scalar the shard
    first takes the type heat_tpu's operation gives (:func:`_scalar_type`).
    A split operand of extent 1 along its split
    axis, where the output is longer, is replicated first, as heat_tpu
    does. A replicated operand is cut to the split operand's chunk locally;
    two different splits align the second operand to the first by a
    resplit."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")
    if not isinstance(t1, DNDarray) or not isinstance(t2, DNDarray):
        x = t1 if isinstance(t1, DNDarray) else t2
        other = t2 if x is t1 else t1
        if not isinstance(other, (int, float, bool)):
            raise TypeError(f"operand type not supported: {type(other)}")
        local = x.larray.to(_scalar_type(x.dtype, other).torch_type())
        res = operation(local, other) if x is t1 else operation(other, local)
        return DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split,
                        x.device, x.comm)

    out_shape = tuple(torch.broadcast_shapes(t1.shape, t2.shape))
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
        t2 = t2.resplit(s1 - (ndim - t2.ndim))
        s2 = s1
    out_split = s1 if s1 is not None else s2
    p1, p2 = t1.larray, t2.larray
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
    res = operation(p1, p2)
    return DNDarray(res, out_shape, types.canonical_heat_type(res.dtype), out_split,
                    t1.device, t1.comm)


def __local_op(operation: Callable, x: DNDarray, **kwargs) -> DNDarray:
    """Elementwise operation on the shard, no communication (heat_tpu
    ``_operations.py:252``)."""
    res = operation(x.larray, **kwargs)
    return DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split,
                    x.device, x.comm)


def __reduce_op(x: DNDarray, partial_op: Callable, neutral, axis=None,
                keepdims: bool = False, reduction: str = "sum") -> DNDarray:
    """Reduction (heat_tpu ``_operations.py:280``): ``partial_op`` (a torch
    reduction taking ``dim``/``keepdim``) on the shard; when the split axis
    is reduced, one all-reduce with ``reduction`` (sum/min/max) combines the
    partials. An empty shard contributes the ``neutral`` element."""
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
    if x.ndim == 0:
        res = local.clone()
    else:
        res = partial_op(local, dim=axes, keepdim=keepdims)
    if touches_split:
        res = x.comm.Allreduce(res.contiguous(), reduction)
    return DNDarray(res, gshape, types.canonical_heat_type(res.dtype), out_split,
                    x.device, x.comm)


_binary_op = __binary_op
_local_op = __local_op
_reduce_op = __reduce_op
