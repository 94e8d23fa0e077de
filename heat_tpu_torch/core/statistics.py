"""Moments and extrema (heat_tpu ``core/statistics.py``).

Eager, with heat_tpu's two-pass structure: ``mean`` is one sum (one
all-reduce along the split axis) divided by the count, as heat_tpu's
``sum / float(n)``; ``var``/``std`` take the mean with the reduced axes
kept, then the sum of squared deviations (two all-reduces); ``average``
with weights packs ``sum(x·w)`` and ``sum(w)`` into ONE all-reduce. The
percentiles, histograms, ``bincount``, ``cov``, the searches,
``interp``, ``gradient`` and ``trapz`` wait for sorting and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, arithmetics, exponential, logical, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["argmax", "argmin", "average", "kurtosis", "max", "maximum", "mean", "min",
           "minimum", "nanargmax", "nanargmin", "nanmax", "nanmean", "nanmin", "nanprod",
           "nanstd", "nansum", "nanvar", "ptp", "skew", "std", "var"]


def _max_neutral(x: DNDarray):
    """Neutral element of a max-reduction: the type's smallest value."""
    if x.dtype is types.bool:
        return False
    if types.heat_type_is_exact(x.dtype):
        return torch.iinfo(x.dtype.torch_type()).min
    return -float("inf")


def _min_neutral(x: DNDarray):
    if x.dtype is types.bool:
        return True
    if types.heat_type_is_exact(x.dtype):
        return torch.iinfo(x.dtype.torch_type()).max
    return float("inf")


def argmax(x: DNDarray, axis=None, out=None, **kwargs) -> DNDarray:
    """Index of the maximum (heat_tpu ``statistics.py:86``): the first one,
    a NaN counting as the maximum; int64. Along the split axis the result is
    replicated, from ONE all-gather of each rank's (value, index) pairs."""
    return _arg_reduce(x, True, axis, out)


def argmin(x: DNDarray, axis=None, out=None, **kwargs) -> DNDarray:
    """Index of the minimum (heat_tpu ``statistics.py:93``), as
    :func:`argmax`."""
    return _arg_reduce(x, False, axis, out)


def _arg_reduce(x: DNDarray, largest: bool, axis, out) -> DNDarray:
    from . import sanitation

    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    local = x.larray
    pick = torch.max if largest else torch.min
    if axis is None:
        flat = local.reshape(-1)
        if flat.numel() == 0:
            vals = torch.full((1,), _max_neutral(x) if largest else _min_neutral(x),
                              dtype=local.dtype, device=local.device)
            idx = torch.full((1,), x.size, dtype=torch.int64, device=local.device)
        else:
            v, i = pick(flat, 0)
            vals, idx = v.reshape(1), i.reshape(1)
            if x.split is not None:
                # this rank's flat index in the global array
                offset, lshape, _ = x.comm.chunk(x.gshape, x.split)
                coords = list(np.unravel_index(int(i), lshape))
                coords[x.split] += offset
                idx = torch.tensor([int(np.ravel_multi_index(coords, x.gshape))],
                                   device=local.device)
        if x.split is not None and x.comm.size > 1:
            idx = _combine_ranks(x.comm, vals, idx, largest)
        result = DNDarray(idx.reshape(()), (), types.int64, None, x.device, x.comm)
        return _operations._finalize(result, out)
    gshape = tuple(s for i, s in enumerate(x.shape) if i != axis)
    if axis != x.split:
        # torch has no argmax of bool: compare as uint8
        cmp = local.view(torch.uint8) if local.dtype == torch.bool else local
        res = (torch.argmax if largest else torch.argmin)(cmp, dim=axis)
        split = None if x.split is None else x.split - (axis < x.split)
        result = DNDarray(res, gshape, types.int64, split, x.device, x.comm)
        return _operations._finalize(result, out)
    offset, _, _ = x.comm.chunk(x.gshape, axis)
    if local.shape[axis] == 0:
        shape = tuple(s for i, s in enumerate(local.shape) if i != axis)
        vals = torch.full(shape, _max_neutral(x) if largest else _min_neutral(x),
                          dtype=local.dtype, device=local.device)
        idx = torch.full(shape, x.gshape[axis], dtype=torch.int64, device=local.device)
    else:
        vals, idx = pick(local, dim=axis)
        idx = idx + offset
    if x.comm.size > 1:
        idx = _combine_ranks(x.comm, vals, idx, largest)
    result = DNDarray(idx, gshape, types.int64, None, x.device, x.comm)
    return _operations._finalize(result, out)


def _combine_ranks(comm, vals: torch.Tensor, idx: torch.Tensor, largest: bool) -> torch.Tensor:
    """The global index of the extremum from each rank's (value, index)
    pair, through ONE all-gather of both as bytes: the lowest index among
    the ranks holding the extremum (a NaN, where any rank holds one)."""
    vb = vals.contiguous().reshape(-1).view(torch.uint8)
    ib = idx.contiguous().reshape(-1).view(torch.uint8)
    both = comm.Allgather(torch.cat([vb, ib]).unsqueeze(0), 0)
    allv = both[:, :vb.numel()].contiguous().view(vals.dtype).reshape((-1,) + tuple(vals.shape))
    alli = both[:, vb.numel():].contiguous().view(torch.int64).reshape((-1,) + tuple(idx.shape))
    ext = allv.amax(0) if largest else allv.amin(0)
    hit = allv == ext
    if allv.is_floating_point():
        nan = torch.isnan(allv)
        hit = torch.where(nan.any(0), nan, hit)
    big = torch.iinfo(torch.int64).max
    return torch.where(hit, alli, big).amin(0)


def _axes(x: DNDarray, axis):
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        return tuple(range(x.ndim))
    return (axis,) if isinstance(axis, int) else axis


def _count(x: DNDarray, axis) -> int:
    return x.size if axis is None else int(np.prod([x.shape[a] for a in _axes(x, axis)]))


def average(x: DNDarray, axis=None, weights=None, returned: bool = False):
    """Weighted average (heat_tpu ``statistics.py:124``). With ``weights``
    (an array of ``x``'s shape, or 1-D along ``axis``), the partial sums of
    ``x·w`` and of ``w`` travel in ONE packed all-reduce where the split
    axis is reduced. Weights summing to zero raise ``ZeroDivisionError``."""
    from . import factories

    if weights is None:
        result = mean(x, axis)
        if returned:
            full = torch.full(result.larray.shape, float(_count(x, axis)),
                              dtype=result.larray.dtype, device=result.larray.device)
            return result, DNDarray(full, result.gshape, result.dtype, result.split,
                                    result.device, result.comm)
        return result
    if not isinstance(weights, DNDarray):
        weights = factories.array(weights, device=x.device, comm=x.comm)
    if axis is None:
        if weights.shape != x.shape:
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        w = weights
    else:
        axis = sanitize_axis(x.shape, axis)
        if not isinstance(axis, int):
            raise NotImplementedError("weighted average over multiple axes is not supported")
        if weights.shape == x.shape:
            w = weights
        elif weights.ndim != 1 or weights.shape[0] != x.shape[axis]:
            raise ValueError("Shape of weights must be consistent with shape of x "
                             "along specified axis.")
        else:
            w = _along(weights, x, axis)
    if w.shape == x.shape and w.split != x.split:
        w = w.resplit(x.split)
    prod = arithmetics.mul(x, w)
    num, gshape, out_split, touches = _operations._reduce_partial(prod, torch.sum, 0, axis,
                                                                  False)
    den, dshape, dsplit, _ = _operations._reduce_partial(w, torch.sum, 0, axis, False)
    if touches and x.comm.size > 1:
        num, den = x.comm.packed_allreduce([num, den])
    num = DNDarray(num, gshape, types.canonical_heat_type(num.dtype), out_split, x.device,
                   x.comm)
    den = DNDarray(den, dshape, types.canonical_heat_type(den.dtype), dsplit, x.device, x.comm)
    if bool(logical.any(den == 0).item()):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    result = arithmetics.div(num, den)
    if returned:
        if den.shape != result.shape:
            den = DNDarray(den.larray.expand(result.larray.shape), result.gshape, den.dtype,
                           result.split, result.device, result.comm)
        return result, den
    return result


def _along(weights: DNDarray, x: DNDarray, axis: int) -> DNDarray:
    """1-D ``weights`` shaped to broadcast along ``axis`` of ``x``, split
    along that axis where ``x`` is."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    if x.split == axis:
        w = weights.resplit(0) if weights.split != 0 else weights
        return DNDarray(w.larray.reshape([w.larray.shape[0] if i == axis else 1
                                          for i in range(x.ndim)]),
                        tuple(shape), w.dtype, axis, w.device, w.comm)
    w = weights.resplit(None) if weights.split is not None else weights
    return DNDarray(w.larray.reshape(shape), tuple(shape), w.dtype, None, w.device, w.comm)


def _central_moment(x: DNDarray, k: int, axis) -> DNDarray:
    mu = _mean_keepdims(x, axis)
    powed = _operations._local_op(lambda a: a ** k, arithmetics.sub(x, mu))
    return mean(powed, axis)


def kurtosis(x: DNDarray, axis=None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Fourth standardized moment (heat_tpu ``statistics.py:525``)."""
    m4 = _central_moment(x, 4, axis)
    v = var(x, axis, ddof=0)
    k = arithmetics.div(m4, arithmetics.mul(v, v))
    if unbiased:
        n = float(_count(x, axis))
        k = _operations._local_op(
            lambda g: ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g - 3 * (n - 1)) + 3, k)
    if Fischer:
        k = arithmetics.sub(k, 3.0)
    return k


def skew(x: DNDarray, axis=None, unbiased: bool = True) -> DNDarray:
    """Third standardized moment (heat_tpu ``statistics.py:540``)."""
    m3 = _central_moment(x, 3, axis)
    s = std(x, axis, ddof=0)
    g = arithmetics.div(m3, _operations._local_op(lambda a: a ** 3, s))
    if unbiased:
        n = float(_count(x, axis))
        # heat_tpu scales by a numpy float64, which promotes the result
        g = _operations._local_op(lambda v: v.to(torch.promote_types(v.dtype, torch.float64))
                                  * float(np.sqrt(n * (n - 1))) / (n - 2), g)
    return g


def max(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:  # noqa: A001
    """Maximum (heat_tpu ``statistics.py:562``); along the split axis one
    all-reduce."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(x, torch.amax, _max_neutral(x), axis=axis, out=out,
                                  keepdims=keepdims, reduction="max")


def maximum(x1, x2, out=None) -> DNDarray:
    """Element-wise maximum, NaN where either is (heat_tpu ``:569``)."""
    return _operations._binary_op(torch.maximum, x1, x2, out)


def mean(x: DNDarray, axis=None) -> DNDarray:
    """Arithmetic mean (heat_tpu ``statistics.py:574``): the sum divided by
    the count as a python float, heat_tpu's formula and rounding; exact
    types give float64, float16 stays float16. One all-reduce along the
    split axis."""
    s = arithmetics.sum(x, axis=axis)
    n = _count(x, axis)
    return arithmetics.div(s, float(n) if n else 1.0)


def min(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:  # noqa: A001
    """Minimum (heat_tpu ``statistics.py:592``); along the split axis one
    all-reduce."""
    if keepdim is not None:
        keepdims = keepdim
    return _operations._reduce_op(x, torch.amin, _min_neutral(x), axis=axis, out=out,
                                  keepdims=keepdims, reduction="min")


def minimum(x1, x2, out=None) -> DNDarray:
    """Element-wise minimum, NaN where either is (heat_tpu ``:599``)."""
    return _operations._binary_op(torch.minimum, x1, x2, out)


def _masked(cond: DNDarray, value, x: DNDarray) -> DNDarray:
    """``value`` where ``cond`` holds, else ``x``; both of one shape and
    split."""
    return DNDarray(torch.where(cond.larray, value, x.larray), x.gshape, x.dtype, x.split,
                    x.device, x.comm)


def _nan_count(x: DNDarray, axis, keepdims: bool = False) -> DNDarray:
    """Count of non-NaN elements along ``axis``."""
    return arithmetics.sum(logical.logical_not(logical.isnan(x)).astype(types.int64),
                           axis=axis, keepdims=keepdims)


def nansum(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum with NaNs taken as zero (heat_tpu ``:629``)."""
    if types.heat_type_is_exact(x.dtype):
        return arithmetics.sum(x, axis=axis, out=out, keepdims=keepdims)
    return arithmetics.sum(arithmetics._nan_filled(x, 0.0), axis=axis, out=out,
                           keepdims=keepdims)


def nanprod(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product with NaNs taken as one (heat_tpu ``:637``)."""
    if types.heat_type_is_exact(x.dtype):
        return arithmetics.prod(x, axis=axis, out=out, keepdims=keepdims)
    return arithmetics.prod(arithmetics._nan_filled(x, 1.0), axis=axis, out=out,
                            keepdims=keepdims)


def _nan_extremum(x: DNDarray, axis, keepdims: bool, fill, reducer) -> DNDarray:
    if types.heat_type_is_exact(x.dtype):
        return reducer(x, axis=axis, keepdims=keepdims)
    red = reducer(arithmetics._nan_filled(x, fill), axis=axis, keepdims=keepdims)
    return _masked(_nan_count(x, axis, keepdims) == 0, float("nan"), red)


def nanmax(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Maximum ignoring NaNs, NaN for an all-NaN slice (heat_tpu ``:656``)."""
    return _nan_extremum(x, axis, keepdims, -float("inf"), max)


def nanmin(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Minimum ignoring NaNs, NaN for an all-NaN slice (heat_tpu ``:661``)."""
    return _nan_extremum(x, axis, keepdims, float("inf"), min)


def _keep_reduced(m: DNDarray, x: DNDarray, axis) -> DNDarray:
    """A reduction of ``x`` over ``axis`` with the reduced axes kept as
    size 1 (a local reshape)."""
    axes = _axes(x, axis)
    shape = tuple(1 if i in axes else s for i, s in enumerate(x.shape))
    local = [1 if i in axes else s for i, s in enumerate(x.shape)]
    split = None
    if m.split is not None:
        split = x.split
        local[split] = m.larray.shape[m.split]
    return DNDarray(m.larray.reshape(local), shape, m.dtype, split, m.device, m.comm)


def nanmean(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Mean ignoring NaNs, NaN for an all-NaN slice (heat_tpu ``:666``)."""
    if types.heat_type_is_exact(x.dtype):
        m = mean(x, axis=axis)
        return _keep_reduced(m, x, axis) if keepdims else m
    s = arithmetics.sum(arithmetics._nan_filled(x, 0.0), axis=axis, keepdims=keepdims)
    cnt = _nan_count(x, axis, keepdims=keepdims)
    none = cnt == 0
    safe = _masked(none, 1, cnt)
    return _masked(none, float("nan"), arithmetics.div(s, safe.astype(s.dtype)))


def nanvar(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Variance ignoring NaNs (heat_tpu ``:686``); NaN where fewer than
    ``ddof + 1`` values are not NaN."""
    if types.heat_type_is_exact(x.dtype):
        v = var(x, axis=axis, ddof=ddof)
        return _keep_reduced(v, x, axis) if keepdims else v
    mu = nanmean(x, axis=axis, keepdims=True)
    dev2 = (x - mu) * (x - mu)
    bad = logical.isnan(x)
    dev2 = _masked(bad.resplit(dev2.split) if bad.split != dev2.split else bad, 0.0, dev2)
    s = arithmetics.sum(dev2, axis=axis, keepdims=keepdims)
    cnt = arithmetics.sum(logical.logical_not(bad).astype(types.int64), axis=axis,
                          keepdims=keepdims)
    denom = cnt - ddof
    few = denom <= 0
    safe = _masked(few, 1, denom)
    return _masked(few, float("nan"), arithmetics.div(s, safe.astype(s.dtype)))


def nanstd(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Standard deviation ignoring NaNs (heat_tpu ``:713``)."""
    return exponential.sqrt(nanvar(x, axis=axis, ddof=ddof, keepdims=keepdims))


def _nan_arg_extremum(x: DNDarray, axis, fill, arg_reducer) -> DNDarray:
    if types.heat_type_is_exact(x.dtype):
        return arg_reducer(x, axis=axis)
    size = _count(x, axis)
    n_bad = _nan_count(x, axis)
    if bool(logical.any(n_bad == 0).item()) and size:
        raise ValueError("All-NaN slice encountered")
    return arg_reducer(arithmetics._nan_filled(x, fill), axis=axis)


def nanargmax(x: DNDarray, axis=None) -> DNDarray:
    """Index of the maximum ignoring NaNs (heat_tpu ``:733``); an all-NaN
    slice raises ``ValueError``."""
    return _nan_arg_extremum(x, axis, -float("inf"), argmax)


def nanargmin(x: DNDarray, axis=None) -> DNDarray:
    """Index of the minimum ignoring NaNs (heat_tpu ``:739``)."""
    return _nan_arg_extremum(x, axis, float("inf"), argmin)


def ptp(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Peak to peak, ``max - min`` (heat_tpu ``statistics.py:836``)."""
    result = arithmetics.sub(max(x, axis=axis, keepdims=keepdims),
                             min(x, axis=axis, keepdims=keepdims))
    return _operations._finalize(result, out)


def std(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation, the square root of :func:`var` (heat_tpu
    ``statistics.py:1097``)."""
    return exponential.sqrt(var(x, axis, ddof=ddof, **kwargs))


def _mean_keepdims(x: DNDarray, axis) -> DNDarray:
    """The mean with the reduced axes kept as size 1 (heat_tpu
    ``statistics.py:1104``): a keepdims sum divided by the count."""
    if axis is None:
        return mean(x, None)
    n = _count(x, axis)
    return arithmetics.div(arithmetics.sum(x, axis=axis, keepdims=True), float(n) if n else 1.0)


def var(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance (heat_tpu ``statistics.py:1118``), two passes: the mean with
    the reduced axes kept, then the sum of squared deviations over
    ``n - ddof``: two all-reduces along the split axis. ``ddof >= n``
    gives NaN, as numpy does."""
    if not isinstance(ddof, int):
        raise ValueError(f"ddof must be integer, is {type(ddof)}")
    if ddof < 0:
        raise ValueError("Expected ddof >= 0")
    if kwargs.get("bessel") is True:
        ddof = 1
    mu = _mean_keepdims(x, axis)
    sq = _operations._local_op(torch.square, arithmetics.sub(x, mu))
    s = arithmetics.sum(sq, axis=axis)
    denom = _count(x, axis) - ddof
    if denom <= 0:
        return _operations._local_op(lambda v: v * float("nan"), s)
    return arithmetics.div(s, float(denom))
