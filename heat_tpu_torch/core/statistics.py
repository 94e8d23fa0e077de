"""Moments and extrema (heat_tpu ``core/statistics.py``).

Eager, with heat_tpu's two-pass structure: ``mean`` is one sum (one
all-reduce along the split axis) divided by the count, as heat_tpu's
``sum / float(n)``; ``var``/``std`` take the mean with the reduced axes
kept, then the sum of squared deviations (two all-reduces); ``average``
with weights packs ``sum(x·w)`` and ``sum(w)`` into ONE all-reduce.

The order statistics (``percentile``, ``median``, ``quantile`` and their
``nan`` forms) reduce across the split axis as heat_tpu does at world size
> 1: along the split axis through the merge-split network of :mod:`._sort`
and one all-reduce of the picks, over all axes through the data engine's
bisection (``bits`` all-reduces) or the network's flat sort. Elsewhere the
local quantile is ``jnp.quantile``'s rule, written out in torch
(``torch.quantile`` refuses tensors above 2^24 elements and interpolates by
``lerp``). The counts (``bincount``, ``histc``, ``histogram*``) are local
and one all-reduce; the lookup tables of ``searchsorted``, ``bucketize``,
``digitize`` and ``interp`` are replicated (a split table gathered once).
``cov`` and ``corrcoef`` wait for ``linalg``.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from . import _operations, arithmetics, exponential, fusion, logical, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["argmax", "argmin", "average", "bincount", "bucketize", "corrcoef", "cov",
           "digitize", "gradient",
           "histc", "histogram", "histogram2d", "histogramdd", "interp", "kurtosis", "max",
           "maximum", "mean", "median", "min", "minimum", "nanargmax", "nanargmin", "nanmax",
           "nanmean", "nanmedian", "nanmin", "nanpercentile", "nanprod", "nanquantile",
           "nanstd", "nansum", "nanvar", "percentile", "ptp", "quantile", "searchsorted",
           "skew", "std", "trapz", "var"]


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
        num, den = fusion.packed_psum([num, den], x.comm)
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


def cov(m: DNDarray, y=None, rowvar: bool = True, bias: bool = False, ddof=None) -> DNDarray:
    """Covariance matrix (heat_tpu ``statistics.py:278``): the centered Gram
    matrix through the distributed ``matmul``."""
    if ddof is not None and not isinstance(ddof, int):
        raise TypeError("ddof must be integer")
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    from . import manipulations
    from .linalg import matmul, transpose

    x = m if m.ndim == 2 else m.reshape((1, m.shape[0]))
    if not rowvar and x.shape[0] != 1:
        x = transpose(x)
    if y is not None:
        if y.ndim > 2:
            raise ValueError("y has more than 2 dimensions")
        yy = y if y.ndim == 2 else y.reshape((1, y.shape[0]))
        if not rowvar and yy.shape[0] != 1:
            yy = transpose(yy)
        x = manipulations.concatenate([x, yy], axis=0)
    if ddof is None:
        ddof = 0 if bias else 1
    centered = arithmetics.sub(x, mean(x, axis=1).reshape((x.shape[0], 1)))
    return arithmetics.div(matmul(centered, transpose(centered)), float(x.shape[1] - ddof))


def corrcoef(m: DNDarray, y=None, rowvar: bool = True) -> DNDarray:
    """Pearson correlation coefficients (heat_tpu ``statistics.py:843``):
    ``C[i,j] / sqrt(C[i,i] C[j,j])`` of :func:`cov`, clipped to [-1, 1]."""
    from . import exponential, factories, manipulations

    c = cov(m, y, rowvar=rowvar)
    if c.ndim == 0:
        return factories.array(1.0, dtype=c.dtype, comm=m.comm, device=m.device)
    d = exponential.sqrt(manipulations.diag(c))
    outer_d = arithmetics.mul(d.reshape((d.shape[0], 1)), d.reshape((1, d.shape[0])))
    return arithmetics.div(c, outer_d).clip(-1.0, 1.0)


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


# ---------------------------------------------------------------------- #
# order statistics                                                        #
# ---------------------------------------------------------------------- #
_METHODS = ("linear", "lower", "higher", "nearest", "midpoint")


def _quantile(a: torch.Tensor, q: torch.Tensor, axis, method: str, keepdims: bool,
              squash_nans: bool = False) -> torch.Tensor:
    """``jnp.percentile``'s rule (jax ``_quantile``) in float64, as XLA
    compiles it: sort; the neighbours of ``q/100·(n-1)``, which XLA folds
    into ``q·fl(0.01·(n-1))`` (``(q·0.01)·(count-1)`` for
    ``nanpercentile``); linear as ``low·(1-w) + high·w`` with the two
    products fused into one FMA (``addcmul``), nearest by ``w <= 0.5``,
    midpoint as ``(low + high)·0.5``. Without ``squash_nans`` a NaN poisons
    its lane; with it (``nanpercentile``) NaNs leave each lane's count.
    ``q`` holds float64 percentages, of rank 0 or 1, placed in front of the
    result. ``a`` sorts in its own type and only the picks widen to float64
    (the widening is monotone, so the picks are the same), which keeps a
    sort of 2^29 float32 elements at half the memory."""
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    keep_shape = None
    if axis is None:
        if keepdims:
            keep_shape = [1] * a.ndim
        a, axis = a.reshape(-1), 0
    elif isinstance(axis, tuple):
        keep_shape = [1 if i in axis else s for i, s in enumerate(a.shape)]
        kept = [i for i in range(a.ndim) if i not in axis]
        a = a.permute(kept + list(axis)).reshape([a.shape[i] for i in kept] + [-1])
        axis = a.ndim - 1
    a2 = a.movedim(axis, -1)
    rest = tuple(a2.shape[:-1])
    if squash_nans:
        a2 = torch.sort(a2, dim=-1).values
        counts = (~torch.isnan(a2)).sum(-1, dtype=q.dtype)
        qx = (q * 0.01).reshape(q.shape + (1,) * len(rest)) * (counts - 1)
        low, high = torch.floor(qx), torch.ceil(qx)
        high_weight = qx - low
        low = torch.maximum(torch.minimum(low, counts - 1), torch.zeros_like(low))
        high = torch.maximum(torch.minimum(high, counts - 1), torch.zeros_like(high))
        src = a2.expand(q.shape + a2.shape)
        low_value = torch.gather(src, -1, low.long()[..., None])[..., 0].to(q.dtype)
        high_value = torch.gather(src, -1, high.long()[..., None])[..., 0].to(q.dtype)
    else:
        if a2.is_floating_point():
            a2 = torch.where(torch.isnan(a2).any(-1, keepdim=True),
                             torch.full_like(a2, float("nan")), a2)
        a2 = torch.sort(a2, dim=-1).values
        n = a2.shape[-1]
        qx = q * (0.01 * (n - 1))
        low, high = torch.floor(qx), torch.ceil(qx)
        high_weight = qx - low
        low = low.clamp(0, n - 1).long()
        high = high.clamp(0, n - 1).long()
        low_value = a2[..., low.reshape(-1)].movedim(-1, 0).reshape(q.shape + rest).to(q.dtype)
        high_value = a2[..., high.reshape(-1)].movedim(-1, 0).reshape(q.shape + rest).to(q.dtype)
        high_weight = high_weight.reshape(q.shape + (1,) * len(rest))
    low_weight = 1 - high_weight
    if method == "linear":
        # the FMA XLA's CPU compiler makes of the sum, on its own operand
        if squash_nans:
            result = torch.addcmul(low_value * low_weight, high_value, high_weight)
        else:
            result = torch.addcmul(high_value * high_weight, low_value, low_weight)
    elif method == "lower":
        result = low_value
    elif method == "higher":
        result = high_value
    elif method == "nearest":
        result = torch.where(high_weight <= 0.5, low_value, high_value)
    else:
        result = (low_value + high_value) * 0.5
    if keepdims:
        if keep_shape is not None:
            result = result.reshape(tuple(q.shape) + tuple(keep_shape))
        else:
            result = result.unsqueeze(q.ndim + axis)
    return result


def _check_percentiles(q, interpolation: str) -> None:
    q_np = np.asarray(q, dtype=np.float64)
    if q_np.size and not bool((q_np >= 0).all() and (q_np <= 100).all()):
        # NaN fails both comparisons and raises, as numpy does
        raise ValueError("Percentiles must be in the range [0, 100]")
    if interpolation not in _METHODS:
        raise ValueError(f"unknown interpolation method {interpolation!r}")


def _local_percentile(t: torch.Tensor, q, axis, interpolation, keepdims, squash=False):
    """``jnp.(nan)percentile(t.astype(float64), q.reshape(-1), ...)``, the
    q axis then restored to ``q``'s shape (jnp refuses a q of rank > 1)."""
    qt = torch.as_tensor(np.asarray(q, dtype=np.float64), device=t.device).reshape(-1)
    res = _quantile(t, qt, axis, interpolation, keepdims, squash)
    return res.reshape(tuple(np.shape(q)) + tuple(res.shape[1:]))


def percentile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear",
               keepdims: bool = False, keepdim=None) -> DNDarray:
    """The q-th percentiles (heat_tpu ``statistics.py:963``), float64; a NaN
    poisons its lane, as in numpy.

    At world size > 1 a reduction over the split axis is
    :func:`_percentile_distributed`; one along another axis is the local
    quantile of each shard, the split kept. Otherwise the local quantile of
    the logical array, replicated."""
    if keepdim is not None:
        keepdims = keepdim
    _check_percentiles(q, interpolation)
    axis_s = sanitize_axis(x.shape, axis)
    distributed = x.split is not None and x.comm.size > 1
    if distributed and (axis_s is None or axis_s == x.split):
        return _percentile_distributed(x, q, axis_s, out, interpolation, keepdims)
    if distributed:
        if np.ndim(q) > 1:
            raise ValueError(f"q must be have rank <= 1, got shape {np.shape(q)}")
        res = _local_percentile(x.larray, q, axis_s, interpolation, keepdims)
        q_ndim = np.ndim(q)
        split = (x.split + q_ndim if keepdims
                 else x.split - (1 if axis_s < x.split else 0) + q_ndim)
        gshape = list(x.shape)
        if keepdims:
            gshape[axis_s] = 1
        else:
            del gshape[axis_s]
        gshape = tuple(np.shape(q)) + tuple(gshape)
        result = DNDarray(res, gshape, types.float64, split, x.device, x.comm)
        return _operations._finalize(result, out)
    res = _local_percentile(x._logical(), q, axis_s, interpolation, keepdims)
    result = DNDarray.from_global(res, None, x.device, x.comm)
    return _operations._finalize(result, out)


def _fetch(block: torch.Tensor, axis: int, width: int, positions, comm) -> dict:
    """The elements at global ``positions`` of a sorted array whose rank
    ``r`` holds positions ``[r·width, r·width + len)`` along ``axis`` of
    ``block``, as float64 on every rank: ONE all-reduce of their bits, each
    position summed from its owner's bits and everyone else's zeros."""
    positions = sorted(set(int(i) for i in positions))
    rest = tuple(s for i, s in enumerate(block.shape) if i != axis)
    buf = torch.zeros((len(positions),) + rest, dtype=torch.float64, device=block.device)
    lo = comm.rank * width
    for j, i in enumerate(positions):
        if lo <= i < lo + block.shape[axis]:
            buf[j] = block.select(axis, i - lo).to(torch.float64)
    bits = comm.Allreduce(buf.view(torch.int64))
    vals = bits.view(torch.float64)
    return {i: vals[j] for j, i in enumerate(positions)}


def _percentile_distributed(x: DNDarray, q, axis_s, out, interpolation, keepdims) -> DNDarray:
    """Order statistics across the split axis (heat_tpu ``statistics.py:1018``).

    Over all axes: the data engine's bisection (``bits`` all-reduces, the
    answers on every rank), or with the engine off, or for bool, the
    network's flat sort of the bag (NaN or the type's maximum filling each
    rank's block) and one all-reduce of the picks. Along the split axis:
    the network sort and one all-reduce of the picks. The picks and their
    interpolation are heat_tpu's own formula (``f = (n-1)·q/100``, linear as
    ``a + (b - a)·w``, nearest by ``np.round``), not the local rule."""
    from . import _sort
    from ..data import ops as data_ops

    comm = x.comm
    floating = x.larray.dtype.is_floating_point
    q_arr = np.asarray(q, dtype=np.float64).reshape(-1)
    if axis_s is None:
        n = x.size
        take = data_ops.order_stat_take(x.larray, n, q_arr, interpolation, floating, comm) \
            if n > 0 else None
        if take is None:
            fill = float("nan") if floating else _min_neutral(x)
            block = _sort.distributed_flat_sort(x.larray, x.gshape, x.split, fill, comm)
            width, axis_b = _sort.flat_block(x.gshape, x.split, comm), 0
    else:
        n = x.shape[axis_s]
        take = None
        block, _ = _sort.distributed_sort(x.larray, axis_s, n, False, comm)
        width, axis_b = comm.chunk_size(n), axis_s
    picks_at = []
    for qv in q_arr:
        f = (n - 1) * float(qv) / 100.0
        lo, hi = int(np.floor(f)), int(np.ceil(f))
        picks_at.append((f, lo, hi))
    if take is None:
        need = {n - 1} if floating else set()
        for f, lo, hi in picks_at:
            need.update((lo, hi, int(np.round(f))))
        got = _fetch(block, axis_b, width, need, comm)

        def take(i):
            return got[int(i)]

    picks = []
    for f, lo, hi in picks_at:
        w = f - lo
        if interpolation == "lower":
            r = take(lo).to(torch.float64)
        elif interpolation == "higher":
            r = take(hi).to(torch.float64)
        elif interpolation == "nearest":
            r = take(int(np.round(f))).to(torch.float64)
        elif interpolation == "midpoint":
            r = (take(lo).to(torch.float64) + take(hi).to(torch.float64)) / 2
        else:
            a = take(lo).to(torch.float64)
            r = a if hi == lo else a + (take(hi).to(torch.float64) - a) * w
        picks.append(r)
    if floating:
        last = take(n - 1)
        picks = [torch.where(torch.isnan(last), torch.full_like(r, float("nan")), r)
                 for r in picks]
    res = picks[0] if np.ndim(q) == 0 else torch.stack(picks)
    if np.ndim(q) > 1:
        res = res.reshape(tuple(np.shape(q)) + tuple(res.shape[1:]))
    if keepdims and axis_s is not None:
        res = res.unsqueeze(axis_s + np.ndim(q))
    elif keepdims:
        res = res.reshape(tuple(np.shape(q)) + (1,) * x.ndim)
    result = DNDarray.from_global(res, None, x.device, comm)
    return _operations._finalize(result, out)


def median(x: DNDarray, axis=None, keepdims: bool = False, keepdim=None) -> DNDarray:
    """The median, the 50th percentile (heat_tpu ``statistics.py:585``)."""
    if keepdim is not None:
        keepdims = keepdim
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


def _q01_to_percent(q):
    """Quantiles in [0, 1] checked (NaN fails) and scaled to percent
    (heat_tpu ``statistics.py:811``)."""
    qn = np.asarray(q, dtype=np.float64)
    if qn.size and not bool((qn >= 0).all() and (qn <= 1).all()):
        raise ValueError("Quantiles must be in the range [0, 1]")
    return qn * 100.0


def quantile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear",
             keepdims: bool = False) -> DNDarray:
    """The q-th quantiles, ``q`` in [0, 1] (heat_tpu ``statistics.py:828``)."""
    return percentile(x, _q01_to_percent(q), axis=axis, out=out,
                      interpolation=interpolation, keepdims=keepdims)


def nanpercentile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear",
                  keepdims: bool = False) -> DNDarray:
    """The q-th percentiles ignoring NaNs (heat_tpu ``statistics.py:744``).
    Over all axes the NaNs are masked out (a split selection) and the rest
    takes :func:`percentile`; along an axis that is split at world size >
    1, the array moves its split off it first (one all-to-all) and each
    shard takes the NaN-dropping local quantile."""
    if not types.heat_type_is_inexact(x.dtype):
        return percentile(x, q, axis=axis, out=out, interpolation=interpolation,
                          keepdims=keepdims)
    from . import manipulations

    if axis is None:
        flat = manipulations.flatten(x)
        kept = flat[logical.logical_not(logical.isnan(flat))]
        res = percentile(kept, q, axis=None, interpolation=interpolation)
        if keepdims:
            res = res.reshape(tuple(np.shape(q)) + (1,) * x.ndim)
        return _operations._finalize(res, out)
    axis_s = sanitize_axis(x.shape, axis)
    distributed = x.split is not None and x.comm.size > 1
    if distributed and x.split == axis_s:
        x = x.resplit((axis_s + 1) % x.ndim) if x.ndim > 1 else x.resplit(None)
        distributed = x.split is not None
    q_ndim = np.ndim(q)
    if keepdims:
        gshape = tuple(np.shape(q)) + tuple(1 if i == axis_s else s
                                            for i, s in enumerate(x.shape))
    else:
        gshape = tuple(np.shape(q)) + tuple(s for i, s in enumerate(x.shape) if i != axis_s)
    if not distributed:
        res = _local_percentile(x._logical(), q, axis_s, interpolation, keepdims, squash=True)
        result = DNDarray.from_global(res, None, x.device, x.comm)
        return _operations._finalize(result, out)
    res = _local_percentile(x.larray, q, axis_s, interpolation, keepdims, squash=True)
    out_split = (x.split + q_ndim if keepdims
                 else (x.split - (1 if axis_s < x.split else 0)) + q_ndim)
    result = DNDarray(res, gshape, types.float64, out_split, x.device, x.comm)
    return _operations._finalize(result, out)


def nanmedian(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """The median ignoring NaNs (heat_tpu ``statistics.py:806``)."""
    return nanpercentile(x, 50.0, axis=axis, keepdims=keepdims)


def nanquantile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear",
                keepdims: bool = False) -> DNDarray:
    """The q-th quantiles ignoring NaNs, ``q`` in [0, 1] (heat_tpu ``:820``)."""
    return nanpercentile(x, _q01_to_percent(q), axis=axis, out=out,
                         interpolation=interpolation, keepdims=keepdims)


# ---------------------------------------------------------------------- #
# searches                                                                #
# ---------------------------------------------------------------------- #
def _table(t, like: DNDarray) -> torch.Tensor:
    """A lookup table on ``like``'s device: a DNDarray's logical array (one
    all-gather when split), anything else as a tensor."""
    if isinstance(t, DNDarray):
        return t._logical()
    if isinstance(t, torch.Tensor):
        return t.to(like.larray.device)
    return torch.as_tensor(np.asarray(t), device=like.larray.device)


def _search_key(t: torch.Tensor) -> torch.Tensor:
    """A key with jax's sort comparator order: NaN above everything and
    ``-0.0 == +0.0`` for floats, bool as uint8."""
    from ._sort import _float_sort_key, _sortable

    if t.dtype.is_floating_point:
        return _float_sort_key(torch.where(t == 0, torch.zeros_like(t), t))
    return _sortable(t)


def _searchsorted(table: torch.Tensor, v: torch.Tensor, side: str) -> torch.Tensor:
    """``jnp.searchsorted(table, v, side)``: both in their promoted type,
    compared as jax's sort does; int64. Against a table without NaN,
    IEEE comparisons are that order (a NaN query lands past the end, -0.0
    equals +0.0), so only a table holding NaN takes the integer keys."""
    ct = torch.promote_types(table.dtype, v.dtype)
    table, v = table.to(ct), v.to(ct)
    if ct == torch.bool or (ct.is_floating_point and bool(torch.isnan(table).any())):
        table, v = _search_key(table), _search_key(v)
    return torch.searchsorted(table.contiguous(), v.contiguous(),
                              right=(side == "right")).to(torch.int64)


def searchsorted(a: DNDarray, v, side: str = "left", sorter=None) -> DNDarray:
    """Insertion indices into the sorted 1-D ``a`` (heat_tpu
    ``statistics.py:859``), int64: ``a`` is the (replicated) table, ``v``
    keeps its split."""
    from . import factories

    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if sorter is not None:
        raise NotImplementedError("searchsorted: sorter is not supported")
    if not isinstance(v, DNDarray):
        if isinstance(a, DNDarray):
            v = factories.array(v, device=a.device, comm=a.comm)
        else:
            v = factories.array(v)
    table = _table(a, v)
    return _operations._local_op(lambda t: _searchsorted(table, t, side), v)


def bucketize(input: DNDarray, boundaries, right: bool = False, out=None) -> DNDarray:
    """Bucket indices (heat_tpu ``statistics.py:265``), int64, with heat_tpu's
    side: ``right=False`` searches to the right."""
    table = _table(boundaries, input)
    side = "left" if right else "right"
    return _operations._local_op(lambda t: _searchsorted(table, t, side), input, out)


def digitize(x: DNDarray, bins, right: bool = False) -> DNDarray:
    """NumPy's bin indices (heat_tpu ``statistics.py:272``, ``jnp.digitize``):
    int32; decreasing bins search the reversed table."""
    table = _table(bins, x)
    side = "left" if right else "right"

    def dig(t):
        if table.shape[0] == 0:
            return torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        if bool(table[-1] >= table[0]):
            return _searchsorted(table, t, side).to(torch.int32)
        return (table.shape[0] - _searchsorted(table.flip(0), t, side)).to(torch.int32)

    return _operations._local_op(dig, x)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, left, right):
    """``jnp.interp`` (jax ``_interp``): ``x`` and ``xp`` in their promoted
    inexact type, ``fp`` in its own; a spacing below the type's
    ``spacing(eps)`` takes the left sample."""
    ct = _operations._inexact(torch.promote_types(x.dtype, xp.dtype))
    x, xp = x.to(ct), xp.to(ct)
    fp = fp.to(_operations._inexact(fp.dtype))
    i = _searchsorted(xp, x, "right").clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(str(ct).split(".")[-1]).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1, dx)) * df)
    lv = fp[0] if left is None else torch.as_tensor(left, dtype=f.dtype, device=f.device)
    rv = fp[-1] if right is None else torch.as_tensor(right, dtype=f.dtype, device=f.device)
    f = torch.where(x < xp[0], lv.to(f.dtype), f)
    return torch.where(x > xp[-1], rv.to(f.dtype), f)


def interp(x: DNDarray, xp, fp, left=None, right=None) -> DNDarray:
    """1-D linear interpolation (heat_tpu ``statistics.py:949``): the table
    ``(xp, fp)`` replicated, ``x`` keeps its split."""
    from . import factories

    if not isinstance(x, DNDarray):
        x = factories.array(x)
    xpv, fpv = _table(xp, x), _table(fp, x)
    return _operations._local_op(lambda t: _interp(t, xpv, fpv, left, right), x)


# ---------------------------------------------------------------------- #
# counts                                                                  #
# ---------------------------------------------------------------------- #
def _aligned_weights(x: DNDarray, weights):
    """The weights of ``x``'s own shard (heat_tpu ``_aligned_weight_phys``,
    ``statistics.py:193``): None without weights (counts), a same-shaped
    DNDarray moved to ``x``'s split (one all-to-all), same-shaped data cut
    to the chunk; ``False`` where heat_tpu falls back to the logical path."""
    if weights is None:
        return None
    if isinstance(weights, DNDarray):
        if weights.gshape == x.gshape and weights.split != x.split:
            weights = weights.resplit(x.split)
        if weights.split == x.split and weights.lshape == x.lshape:
            return weights.larray
        return False
    w = _table(weights, x)
    if x.split is None or tuple(w.shape) != x.gshape:
        return w if tuple(w.shape) == x.lshape else False
    _, _, slices = x.comm.chunk(x.gshape, x.split)
    return w[slices]


def _scatter_counts(idx: torch.Tensor, w, length: int, dtype) -> torch.Tensor:
    """``zeros(length, dtype).at[idx].add(w)`` with out-of-range indices
    dropped: one ``bincount`` whose last bin takes them. Without weights the
    counts are exact integers (jnp adds ones in ``dtype``, which stalls at
    2^24 in a float32 bin)."""
    idx = torch.where((idx >= 0) & (idx < length), idx, length)
    counts = torch.bincount(idx, weights=None if w is None else w.to(dtype),
                            minlength=length + 1)
    return counts[:length].to(dtype)


def bincount(x: DNDarray, weights=None, minlength: int = 0) -> DNDarray:
    """Occurrences of non-negative integers (heat_tpu ``statistics.py:216``).

    A 1-D split array at world size > 1 counts its shard and sums the
    counts in ONE all-reduce; its minimum (checked non-negative) and its
    maximum (the length) are two scalar reductions first."""
    if not types.heat_type_is_exact(x.dtype):
        raise TypeError("bincount requires an integer array")
    if isinstance(weights, DNDarray) and weights.gshape != x.gshape:
        raise ValueError("weights and x don't have the same shape")
    if x.split is not None and x.comm.size > 1 and x.ndim == 1 and x.size > 0:
        w = _aligned_weights(x, weights)
        if w is not False:
            if int(min(x).item()) < 0:
                raise ValueError("bincount requires non-negative entries")
            length = builtins.max(int(minlength), int(max(x).item()) + 1)
            dtype = torch.int64 if w is None else w.dtype
            counts = _scatter_counts(x.larray.long().clamp(0, length - 1), w, length, dtype)
            counts = x.comm.Allreduce(counts)
            return DNDarray.from_global(counts, None, x.device, x.comm)
    logical_x = x._logical().reshape(-1)
    w = None
    if weights is not None:
        w = _table(weights, x).reshape(-1)
    length = builtins.max(int(minlength),
                          (int(logical_x.max()) + 1) if logical_x.numel() else 0)
    dtype = torch.int64 if w is None else w.dtype
    counts = _scatter_counts(logical_x.long().clamp(min=0), w, length, dtype)
    return DNDarray.from_global(counts, None, x.device, x.comm)


def _jnp_edges(lo: float, hi: float, bins: int, dtype, device) -> torch.Tensor:
    """``jnp.histogram_bin_edges`` of an integer ``bins``: the range in the
    array's inexact type, widened by ±0.5 when empty, then ``jnp.linspace``
    (``lo·(1 - i/bins) + hi·(i/bins)``, the last edge ``hi``)."""
    r = torch.tensor([lo, hi], dtype=dtype, device=device)
    if bool(r[0] == r[1]):
        r = torch.stack([r[0] - 0.5, r[1] + 0.5])
    i = torch.arange(bins + 1, dtype=dtype, device=device)
    frac = i / torch.tensor(bins, dtype=dtype, device=device)
    return torch.where(i == bins, r[1], r[0] * (1 - frac) + r[1] * frac)


def _histogram_local(a: torch.Tensor, edges: torch.Tensor, w=None, wdt=None):
    """``jnp.histogram`` against ``edges``: ``a`` and the weights in their
    promoted inexact type (without ``w``, ones of type ``wdt``, by default
    ``a``'s), the edges cast to it, ``searchsorted(edges, a, 'right')``, the
    closed last edge, a scatter-add, the first (below-range) bin dropped."""
    wt = w.dtype if w is not None else (wdt or a.dtype)
    ct = _operations._inexact(torch.promote_types(a.dtype, wt))
    a = a.reshape(-1).to(ct)
    e = edges.to(ct)
    idx = _searchsorted(e, a, "right")
    idx = torch.where(a == e[-1], e.shape[0] - 1, idx)
    return _scatter_counts(idx, None if w is None else w.reshape(-1), e.shape[0], ct)[1:]


def _hist_counts_distributed(x: DNDarray, edges: np.ndarray, weights):
    """The shard's histogram against the shared float64 ``edges``, summed in
    ONE all-reduce (heat_tpu ``statistics.py:312``: counts in int64 that
    ``jnp.histogram`` promotes with the values); None where the weights
    cannot be aligned."""
    w = _aligned_weights(x, weights)
    if w is False:
        return None
    e = torch.as_tensor(edges, dtype=torch.float64, device=x.larray.device)
    return x.comm.Allreduce(_histogram_local(x.larray, e, w, wdt=torch.int64))


def _minmax_scalars(x: DNDarray):
    """The global minimum and maximum as python floats: two scalar
    reductions (heat_tpu ``statistics.py:342``)."""
    return float(min(x).item()), float(max(x).item())


def histc(input: DNDarray, bins: int = 100, min=0, max=0, out=None) -> DNDarray:  # noqa: A002
    """A histogram of equal bins between ``min`` and ``max`` (the data's
    extrema when both are 0), in the input's type (heat_tpu
    ``statistics.py:357``). A split array at world size > 1 counts its shard
    against float64 edges and sums in one all-reduce."""
    lo, hi = float(min), float(max)
    if input.split is not None and input.comm.size > 1 and input.size > 0:
        if lo == 0 and hi == 0:
            lo, hi = _minmax_scalars(input)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        res = _hist_counts_distributed(input, np.linspace(lo, hi, int(bins) + 1), None)
        if res is not None:
            result = DNDarray.from_global(res.to(input.dtype.torch_type()), None,
                                          input.device, input.comm)
            return _operations._finalize(result, out)
    logical_t = input._logical().reshape(-1)
    if lo == 0 and hi == 0:
        lo = float(logical_t.min()) if logical_t.numel() else 0.0
        hi = float(logical_t.max()) if logical_t.numel() else 1.0
    ct = _operations._inexact(logical_t.dtype)
    edges = _jnp_edges(lo, hi, int(bins), ct, logical_t.device)
    res = _histogram_local(logical_t, edges, None)
    result = DNDarray.from_global(res.to(input.dtype.torch_type()), None, input.device,
                                  input.comm)
    return _operations._finalize(result, out)


def histogram(a: DNDarray, bins=10, range=None, normed=None, weights=None,  # noqa: A002
              density=None):
    """NumPy's histogram (heat_tpu ``statistics.py:383``): ``(counts,
    edges)``, replicated. A split array at world size > 1 counts its shard
    against float64 edges and sums in one all-reduce (density after it);
    otherwise ``jnp.histogram`` of the logical array."""
    if a.split is not None and a.comm.size > 1 and a.size > 0 and \
            not isinstance(bins, DNDarray):
        if np.ndim(bins) == 0:
            lo, hi = ((float(range[0]), float(range[1])) if range is not None
                      else _minmax_scalars(a))
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            edges = np.linspace(lo, hi, int(bins) + 1)
        else:
            edges = np.asarray(bins, dtype=np.float64)
        res = _hist_counts_distributed(a, edges, weights)
        if res is not None:
            e = torch.as_tensor(edges, device=res.device)
            if density:
                res = res / (float(res.sum()) * torch.diff(e))
            return (DNDarray.from_global(res, None, a.device, a.comm),
                    DNDarray.from_global(e, None, a.device, a.comm))
    t = a._logical().reshape(-1)
    w = None
    if weights is not None:
        w = _table(weights, a).reshape(-1)
    ct = _operations._inexact(t.dtype if w is None else torch.promote_types(t.dtype, w.dtype))
    if np.ndim(bins) == 1 or isinstance(bins, DNDarray):
        edges = _table(bins, a).to(ct)
    else:
        if range is None:
            lo, hi = float(t.to(ct).min()), float(t.to(ct).max())
        else:
            lo, hi = float(range[0]), float(range[1])
        edges = _jnp_edges(lo, hi, int(bins), ct, t.device)
    res = _histogram_local(t, edges, w)
    if density:
        res = res / torch.diff(edges) / res.sum()
    return (DNDarray.from_global(res, None, a.device, a.comm),
            DNDarray.from_global(edges, None, a.device, a.comm))


def _searchsorted_minus1(col: DNDarray, edges: np.ndarray) -> DNDarray:
    """``searchsorted(edges, col, 'right') - 1`` on each shard (heat_tpu
    ``statistics.py:491``)."""
    return _operations._local_op(
        lambda t: _searchsorted(torch.as_tensor(edges, device=t.device), t, "right") - 1, col)


def histogramdd(sample, bins=10, range=None, weights=None,  # noqa: A002
                density: bool = False):
    """A D-dimensional histogram (heat_tpu ``statistics.py:422``): per-axis
    bin indices on the split sample fold into one flat index, out-of-range
    samples into a dropped overflow bin, and one :func:`bincount`.
    ``sample`` is an (N, D) DNDarray or a sequence of (N,) arrays; returns
    ``(H, edges)``."""
    from . import factories, indexing

    if isinstance(sample, DNDarray):
        if sample.ndim == 1:
            sample = sample.reshape((sample.shape[0], 1))
        cols = [sample[:, d] for d in builtins.range(sample.shape[1])]
    else:
        cols = [c if isinstance(c, DNDarray) else factories.array(np.asarray(c))
                for c in sample]
    nbins, edges_list = [], []
    for d, col in enumerate(cols):
        b = bins[d] if isinstance(bins, (list, tuple)) else bins
        if np.ndim(b) == 0:
            if range is not None and range[d] is not None:
                lo, hi = float(range[d][0]), float(range[d][1])
            elif col.size == 0:
                lo, hi = 0.0, 1.0
            else:
                lo, hi = _minmax_scalars(col)
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            edges = np.linspace(lo, hi, int(b) + 1)
        else:
            edges = np.asarray(b, dtype=np.float64)
        nbins.append(len(edges) - 1)
        edges_list.append(edges)
    total = int(np.prod(nbins))
    flat = valid = None
    stride = total
    for col, edges, nb in zip(cols, edges_list, nbins):
        stride //= nb
        idx = _searchsorted_minus1(col, edges)
        # the rightmost edge is closed, as numpy's: it joins the last bin
        idx = indexing.where(col == float(edges[-1]),
                             factories.full_like(idx, nb - 1, dtype=idx.dtype), idx)
        ok = logical.logical_and(col >= float(edges[0]), col <= float(edges[-1]))
        valid = ok if valid is None else logical.logical_and(valid, ok)
        term = idx.clip(0, nb - 1) * stride
        flat = term if flat is None else flat + term
    flat = indexing.where(valid, flat, factories.full_like(flat, total, dtype=flat.dtype))
    counts = bincount(flat.astype(types.int64), weights=weights, minlength=total + 1)
    H = counts[:total].reshape(tuple(nbins))
    if density:
        vol = edges_list[0][1:] - edges_list[0][:-1]
        for e in edges_list[1:]:
            vol = np.multiply.outer(vol, e[1:] - e[:-1])
        tot = float(H.sum().item())
        H = H / (factories.array(vol, dtype=types.float64, device=H.device, comm=H.comm)
                 * (tot if tot else 1.0))
    return H, [factories.array(e, device=H.device, comm=H.comm) for e in edges_list]


def histogram2d(x: DNDarray, y: DNDarray, bins=10, range=None, weights=None,  # noqa: A002
                density: bool = False):
    """A 2-D histogram (heat_tpu ``statistics.py:500``): :func:`histogramdd`
    of the pair. ``bins``: a scalar for both axes, a pair of per-axis
    specifications, or one array of edges shared by both."""
    if not np.isscalar(bins) and not isinstance(bins, DNDarray):
        try:
            length = len(bins)
        except TypeError:
            length = None
        if length is not None and length != 2 and all(np.isscalar(b) for b in bins):
            shared = np.asarray(bins)
            bins = [shared, shared]
        else:
            bins = list(bins)
    H, edges = histogramdd((x, y), bins=bins, range=range, weights=weights, density=density)
    return H, edges[0], edges[1]


# ---------------------------------------------------------------------- #
# calculus                                                                #
# ---------------------------------------------------------------------- #
def trapz(y: DNDarray, x=None, dx: float = 1.0, axis: int = -1) -> DNDarray:
    """Trapezoidal integration (heat_tpu ``statistics.py:876``): two slices
    of the axis (window fetches when it is split) and one reduction."""
    from . import factories

    axis = sanitize_axis(y.shape, axis)
    n = y.shape[axis]
    if n < 2:
        gshape = tuple(sz for i, sz in enumerate(y.shape) if i != axis)
        return factories.zeros(gshape, dtype=y.dtype, device=y.device, comm=y.comm)
    sl_lo = tuple(slice(None, -1) if i == axis else slice(None) for i in builtins.range(y.ndim))
    sl_hi = tuple(slice(1, None) if i == axis else slice(None) for i in builtins.range(y.ndim))
    pair_sum = arithmetics.add(y[sl_hi], y[sl_lo])
    if x is None:
        return arithmetics.mul(arithmetics.sum(pair_sum, axis=axis), 0.5 * float(dx))
    xv = x._logical() if isinstance(x, DNDarray) else torch.as_tensor(np.asarray(x))
    if xv.ndim != 1:
        raise NotImplementedError("trapz: only 1-D sample positions")
    d = torch.diff(xv)
    shape = [1] * y.ndim
    shape[axis] = d.shape[0]
    dd = factories.array(d.reshape(shape).cpu().numpy(), device=y.device, comm=y.comm)
    return arithmetics.mul(arithmetics.sum(arithmetics.mul(pair_sum, dd), axis=axis), 0.5)


def gradient(f: DNDarray, *varargs, axis=None, edge_order: int = 1):
    """The numerical gradient (heat_tpu ``statistics.py:911``): central
    differences inside, one-sided at the edges, from slices and one
    concatenation (window fetches along a split axis). Scalar spacing;
    a list for several axes."""
    from . import manipulations

    if edge_order != 1:
        raise NotImplementedError("gradient: only edge_order=1")
    if len(varargs) > 1:
        raise NotImplementedError("gradient: per-axis spacing arrays are not supported "
                                  "(scalar spacing only)")
    h = float(varargs[0]) if varargs else 1.0
    axes = (tuple(builtins.range(f.ndim)) if axis is None
            else ((axis,) if isinstance(axis, int) else tuple(axis)))
    axes = tuple(sanitize_axis(f.shape, a) for a in axes)
    outs = []
    for ax in axes:
        if f.shape[ax] < 2:
            raise ValueError("gradient requires at least 2 points per axis")

        def sl(a, b):
            return tuple(slice(a, b) if i == ax else slice(None)
                         for i in builtins.range(f.ndim))

        interior = arithmetics.div(arithmetics.sub(f[sl(2, None)], f[sl(None, -2)]), 2.0 * h)
        first = arithmetics.div(arithmetics.sub(f[sl(1, 2)], f[sl(0, 1)]), h)
        last = arithmetics.div(arithmetics.sub(f[sl(-1, None)], f[sl(-2, -1)]), h)
        outs.append(manipulations.concatenate([first, interior, last], axis=ax))
    return outs[0] if len(axes) == 1 else outs
