"""Shape and data manipulations (heat_tpu ``core/manipulations.py``).

Operations that leave the split axis alone run on the shard, with no
communication. Those that move rows along the split axis run heat_tpu's
scheduled window fetches (:mod:`._manips`: concatenate, flip, roll, pad,
repeat, reshape, the diag pair) on every rank, each round one
point-to-point permutation; none gathers the logical array. Where heat_tpu
takes the logical array (``_logical()``), so does the port: one all-gather,
counted in ``comm.stats``. ``sort`` and ``unique`` along the split axis run
the merge-split network of :mod:`._sort` and :mod:`._setops`, ``topk``
heat_tpu's tournament (one all-gather of the candidates); the set
operations are ``unique`` and ``isin`` put together, as in heat_tpu.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import factories, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "array_split", "balance", "broadcast_arrays", "broadcast_to", "column_stack",
    "concatenate", "diag", "diagonal", "dsplit", "dstack", "expand_dims", "flatten", "flip",
    "fliplr", "flipud", "hsplit", "hstack", "intersect1d", "moveaxis", "pad", "ravel",
    "redistribute", "repeat", "reshape", "resplit", "roll", "rot90", "row_stack", "setdiff1d",
    "setxor1d", "shape", "sort", "split", "squeeze", "stack", "swapaxes", "tile", "topk",
    "union1d", "unique", "vsplit", "vstack",
]


def _wrap(tensor: torch.Tensor, split, like: DNDarray, dtype=None) -> DNDarray:
    """A global tensor every rank holds as a canonical DNDarray (heat_tpu's
    ``from_logical``): each rank keeps its chunk."""
    return DNDarray.from_global(tensor, split, like.device, like.comm, dtype)


def _distributed(a: DNDarray) -> bool:
    return a.split is not None and a.comm.size > 1


def _transpose(a: DNDarray, axes=None) -> DNDarray:
    """Axis permutation (heat_tpu ``linalg/basics.py:478``): a local permute
    and the split axis remapped, no communication."""
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(sanitize_axis(a.shape, ax) for ax in axes)
        if sorted(axes) != list(range(a.ndim)):
            raise ValueError(f"axes must be a permutation of dimensions, got {axes}")
    split = None if a.split is None else axes.index(a.split)
    return DNDarray(a.larray.permute(*axes), tuple(a.shape[ax] for ax in axes), a.dtype,
                    split, a.device, a.comm)


def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """heat_tpu ``manipulations.py:83``: the canonical layout is always
    balanced; the array itself, or a copy."""
    if copy:
        from . import memory

        return memory.copy(array)
    return array


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """heat_tpu ``manipulations.py:530``: a copy, which takes the canonical
    map only (:meth:`DNDarray.redistribute_`)."""
    from . import memory

    out = memory.copy(arr)
    out.redistribute_(lshape_map, target_map)
    return out


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:93``."""
    target = tuple(np.broadcast_shapes(*[tuple(a.shape) for a in arrays]))
    return [broadcast_to(a, target) for a in arrays]


def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """heat_tpu ``manipulations.py:101``: the split axis keeps its extent (a
    split axis of extent 1 is replicated first), so the broadcast is local."""
    shape = sanitize_shape(shape)
    out_split = None
    if x.split is not None:
        out_split = x.split + (len(shape) - x.ndim)
        if x.shape[x.split] == 1 and shape[out_split] != 1:
            x, out_split = x.resplit(None), None
    if out_split is not None and x.comm.size > 1 and shape[out_split] != x.shape[x.split]:
        raise ValueError(f"cannot broadcast shape {x.shape} to {shape}: the split axis extent "
                         f"must match (got {shape[out_split]} vs {x.shape[x.split]})")
    _, lshape, _ = x.comm.chunk(shape, out_split)
    try:
        res = torch.broadcast_to(x.larray, lshape)
    except RuntimeError as exc:
        raise ValueError(f"cannot broadcast shape {x.shape} to {shape}") from exc
    return DNDarray(res, shape, x.dtype, out_split, x.device, x.comm)


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """heat_tpu ``manipulations.py:136``. Arrays split along the axis join
    through the window fetch (each input's rows shift by the lengths before
    it); arrays split along another axis join on the shard; a minority
    layout moves to the majority's first (one resplit each)."""
    from . import _manips

    arrays = list(arrays)
    if len(arrays) < 1:
        raise ValueError("need at least one array to concatenate")
    for a in arrays:
        if not isinstance(a, DNDarray):
            raise TypeError(f"inputs must be DNDarrays, found {type(a)}")
    axis = sanitize_axis(arrays[0].shape, axis)
    lead = arrays[0].shape
    for a in arrays[1:]:
        if a.ndim != len(lead) or any(a.shape[i] != lead[i] for i in range(a.ndim) if i != axis):
            raise ValueError("all input array dimensions except the concatenation axis must "
                             f"match exactly: {lead} vs {tuple(a.shape)} on axis {axis}")
    out_split = arrays[0].split
    if any(a.split != out_split for a in arrays[1:]):
        non_none = [a.split for a in arrays if a.split is not None]
        out_split = non_none[0] if non_none else None
    dtype = types.result_type(*arrays)
    tdt = dtype.torch_type()
    comm = arrays[0].comm
    if out_split is not None and comm.size > 1:
        arrays = [a for a in arrays if a.shape[axis] > 0] or arrays
        arrays = [a if a.split == out_split else a.resplit(out_split) for a in arrays]
    gshape = tuple(sum(a.shape[axis] for a in arrays) if i == axis else s
                   for i, s in enumerate(arrays[0].gshape))
    if out_split == axis and comm.size > 1 and all(a.shape[axis] > 0 for a in arrays):
        out = _manips.ring_concat([a.larray.to(tdt) for a in arrays], axis,
                                  [a.shape[axis] for a in arrays], comm)
        return DNDarray(out, gshape, dtype, axis, arrays[0].device, comm)
    if out_split is not None and out_split != axis and all(a.split == out_split
                                                           for a in arrays):
        res = torch.cat([a.larray.to(tdt) for a in arrays], dim=axis)
        return DNDarray(res, gshape, dtype, out_split, arrays[0].device, comm)
    res = torch.cat([a._logical().to(tdt) for a in arrays], dim=axis)
    return _wrap(res, out_split, arrays[0], dtype)


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """heat_tpu ``manipulations.py:130``."""
    return concatenate([a.reshape((a.shape[0], 1)) if a.ndim == 1 else a for a in arrays], 1)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """heat_tpu ``manipulations.py:784``."""
    return concatenate([a.reshape((1, a.shape[0])) if a.ndim == 1 else a for a in arrays], 0)


vstack = row_stack


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """heat_tpu ``manipulations.py:417``."""
    return concatenate(arrays, 0 if all(a.ndim == 1 for a in arrays) else 1)


def dstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """heat_tpu ``manipulations.py:336``."""
    prepped = []
    for a in arrays:
        if a.ndim == 1:
            a = a.reshape((1, a.shape[0], 1))
        elif a.ndim == 2:
            a = a.reshape((a.shape[0], a.shape[1], 1))
        prepped.append(a)
    return concatenate(prepped, 2)


def _diag_construct_distributed(a: DNDarray, offset: int) -> DNDarray:
    """diag of a split vector: the vector, zero-extended to ``L`` by the
    ring concatenation, is in the output's row chunks; each rank builds its
    rows (heat_tpu ``manipulations.py:223``)."""
    comm = a.comm
    n = a.shape[0]
    L = n + abs(offset)
    pad = factories.zeros(abs(offset), dtype=a.dtype, split=0, device=a.device, comm=comm)
    w = concatenate([a, pad] if offset > 0 else [pad, a], 0) if offset else a
    lo, _, _ = comm.chunk((L,), 0)
    rows = w.larray.shape[0]
    gpos = torch.arange(lo, lo + rows, device=w.larray.device)
    col = gpos + offset
    ok = (col >= 0) & (col < L)
    block = w.larray.new_zeros((rows, L))
    r = torch.arange(rows, device=w.larray.device)
    block[r[ok], col[ok]] = w.larray[ok]
    return DNDarray(block, (L, L), a.dtype, 0, a.device, comm)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """heat_tpu ``manipulations.py:261``: construct from a vector, or the
    diagonal of a matrix."""
    if a.ndim == 1:
        if a.split == 0 and a.comm.size > 1 and a.shape[0] > 0:
            return _diag_construct_distributed(a, int(offset))
        return _wrap(torch.diag(a._logical(), offset), 0 if a.split is not None else None, a)
    return diagonal(a, offset=offset)


def _diagonal_extract_distributed(a: DNDarray, offset: int) -> DNDarray:
    """The diagonal of a row-split matrix: each row's element is on its
    rank; the diagonal's rows re-chunk through the mask ring (heat_tpu
    ``manipulations.py:271``)."""
    comm = a.comm
    n, m = a.shape
    L = max(0, min(n, m - offset) if offset >= 0 else min(n + offset, m))
    if L == 0:
        return DNDarray.from_global(a.larray.new_zeros((0,)), None, a.device, comm)
    lo, _, _ = comm.chunk(a.gshape, 0)
    local = a.larray
    gpos = torch.arange(lo, lo + local.shape[0], device=local.device)
    col = gpos + offset
    ok = (col >= 0) & (col < m)
    vals = local.gather(1, col.clamp(0, m - 1).unsqueeze(1)).squeeze(1) if m else \
        local.new_zeros((local.shape[0],))
    vals = torch.where(ok, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    w = DNDarray(vals, (n,), a.dtype, 0, a.device, comm)
    first = max(0, -offset)
    if first == 0 and L == n:
        return w
    rows = np.arange(n)
    return w[(rows >= first) & (rows < first + L)]


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """heat_tpu ``manipulations.py:306``."""
    if a.ndim == 2 and {dim1, dim2} == {0, 1} and _distributed(a) and a.size > 0:
        if (dim1, dim2) == (1, 0):
            return diagonal(_transpose(a), offset=offset, dim1=0, dim2=1)
        if a.split == 1:
            return _diagonal_extract_distributed(_transpose(a), -int(offset))
        return _diagonal_extract_distributed(a, int(offset))
    res = torch.diagonal(a._logical(), offset, dim1, dim2)
    out_split = None
    if a.split is not None:
        out_split = res.ndim - 1 if a.split in (dim1, dim2) else 0
    return _wrap(res, out_split, a)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """heat_tpu ``manipulations.py:348``: local; the split index shifts."""
    axis = sanitize_axis(tuple(a.shape) + (1,), axis)
    split = a.split if a.split is None or a.split < axis else a.split + 1
    gshape = list(a.shape)
    gshape.insert(axis, 1)
    return DNDarray(a.larray.unsqueeze(axis), tuple(gshape), a.dtype, split, a.device, a.comm)


def flatten(a: DNDarray) -> DNDarray:
    """heat_tpu ``manipulations.py:359``: a split array through the
    re-chunking reshape."""
    if _distributed(a) and a.size > 0:
        return reshape(a, (a.size,), new_split=0)
    return _wrap(a._logical().reshape(-1), 0 if a.split is not None else None, a)


def ravel(a: DNDarray) -> DNDarray:
    """heat_tpu ``manipulations.py:525``."""
    return flatten(a)


def _axes(a: DNDarray, axis):
    if axis is None:
        return tuple(range(a.ndim))
    if isinstance(axis, (int, np.integer)):
        return (sanitize_axis(a.shape, axis),)
    return tuple(sanitize_axis(a.shape, ax) for ax in axis)


def flip(a: DNDarray, axis=None) -> DNDarray:
    """heat_tpu ``manipulations.py:368``: other axes flip on the shard, the
    split axis through the window fetch (two rounds: the block reversal and
    its neighbor)."""
    from . import _manips

    axes = _axes(a, axis)
    if a.split is not None and a.split in axes:
        if a.comm.size > 1 and a.shape[a.split] > 0:
            other = [ax for ax in axes if ax != a.split]
            local = a.larray.flip(other) if other else a.larray
            out = _manips.ring_flip(local, a.split, a.shape[a.split], a.comm)
            return DNDarray(out, a.gshape, a.dtype, a.split, a.device, a.comm)
        return _wrap(a._logical().flip(axes), a.split, a)
    return DNDarray(a.larray.flip(axes), a.gshape, a.dtype, a.split, a.device, a.comm)


def fliplr(a: DNDarray) -> DNDarray:
    """heat_tpu ``manipulations.py:398``."""
    if a.ndim < 2:
        raise IndexError("expected array with at least 2 dimensions")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """heat_tpu ``manipulations.py:405``."""
    return flip(a, 0)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """heat_tpu ``manipulations.py:424``."""
    source = (source,) if isinstance(source, (int, np.integer)) else tuple(source)
    destination = ((destination,) if isinstance(destination, (int, np.integer))
                   else tuple(destination))
    source = tuple(sanitize_axis(x.shape, s) for s in source)
    destination = tuple(sanitize_axis(x.shape, d) for d in destination)
    if len(source) != len(destination):
        raise ValueError("source and destination arguments must have the same number of "
                         "elements")
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return _transpose(x, order)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """heat_tpu ``manipulations.py:924``."""
    axes = list(range(x.ndim))
    a1, a2 = sanitize_axis(x.shape, axis1), sanitize_axis(x.shape, axis2)
    axes[a1], axes[a2] = axes[a2], axes[a1]
    return _transpose(x, axes)


def _normalize_pad_width(pad_width, ndim):
    """NumPy's ``pad_width`` forms as ``((before, after), ...)``, or None."""
    try:
        pw = np.asarray(pad_width, dtype=np.int64)
    except (ValueError, TypeError):
        return None
    if pw.ndim == 0:
        return ((int(pw), int(pw)),) * ndim
    if pw.shape == (2,):
        return ((int(pw[0]), int(pw[1])),) * ndim
    if pw.shape == (1,):
        return ((int(pw[0]), int(pw[0])),) * ndim
    if pw.shape == (ndim, 2):
        return tuple((int(a), int(b)) for a, b in pw)
    if pw.shape == (1, 2):
        return ((int(pw[0, 0]), int(pw[0, 1])),) * ndim
    return None


_PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap", "linear_ramp", "maximum",
              "mean", "median", "minimum")


def _constant_pairs(constant_values, ndim: int, dtype: torch.dtype):
    """``constant_values`` as ``[[before, after], ...]`` python scalars of
    ``dtype``'s values (cast on the host, as ``jnp.pad`` casts), by
    ``jnp.pad``'s broadcast (a scalar, a pair, or one pair per axis)."""
    cv = torch.as_tensor(np.asarray(constant_values)).to(dtype)
    if cv.ndim == 1 and cv.shape[0] not in (1, 2):
        raise ValueError(f"pad: constant_values has unsupported shape {tuple(cv.shape)}. If "
                         "the shape is 1D or 2D, the last dimension must be of size 1 or 2.")
    if cv.ndim == 1 and cv.shape[0] == 1:
        cv = cv.reshape(())
    return torch.broadcast_to(cv, (ndim, 2)).tolist()


def _pad_stat(t: torch.Tensor, ax: int, mode: str) -> torch.Tensor:
    """``jnp.pad``'s statistic of a whole axis (kept, length 1): ``amax``,
    ``amin``, ``mean`` or ``median`` (the midpoint of the two middle
    values, NaN where the axis holds one), rounded for an integer type."""
    if mode == "maximum":
        return torch.amax(t, ax, keepdim=True)
    if mode == "minimum":
        return torch.amin(t, ax, keepdim=True)
    work = t if t.is_floating_point() or t.is_complex() else t.to(torch.float64)
    if mode == "mean":
        stat = work.mean(ax, keepdim=True)
    else:
        k = t.shape[ax]
        srt = work.sort(ax).values
        stat = (srt.narrow(ax, (k - 1) // 2, 1) + srt.narrow(ax, k // 2, 1)) * 0.5
        stat = torch.where(work.isnan().any(ax, keepdim=True), float("nan"), stat)
    if not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool):
        stat = stat.round()
    return stat.to(t.dtype)


def _pad_ramp(t: torch.Tensor, ax: int, edge: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` rows running from 0 towards the row ``edge`` (excluded),
    ``jnp.linspace(0, edge, width, endpoint=False)``'s formula; an integer
    type floors."""
    work = edge if edge.is_floating_point() or edge.is_complex() else edge.to(torch.float64)
    shape = [1] * t.ndim
    shape[ax] = width
    if width == 1:
        ramp = torch.zeros_like(work)
    else:
        real = work.real.dtype if work.is_complex() else work.dtype
        step = (torch.arange(width, dtype=real, device=t.device) / width).reshape(shape)
        step = step.to(work.dtype)
        ramp = torch.zeros_like(work) * (1 - step) + work * step
    if not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool):
        ramp = ramp.floor()
    out_shape = list(t.shape)
    out_shape[ax] = width
    return torch.broadcast_to(ramp, out_shape).to(t.dtype)


def _pad_local(t: torch.Tensor, pw, mode: str, values) -> torch.Tensor:
    """``jnp.pad`` of a tensor along each axis of ``pw`` in turn, on its
    device: each axis's two margins are made (filled with ``values``, from
    :func:`_constant_pairs`; a statistic or a ramp of the axis; or the
    source rows of :func:`._manips.pad_src`, the rule heat_tpu's ring pad
    uses) and concatenated around the tensor."""
    from ._manips import pad_src

    for ax, (before, after) in enumerate(pw):
        if not before and not after:
            continue
        n = t.shape[ax]
        shapes = [t.shape[:ax] + (w,) + t.shape[ax + 1:] for w in (before, after)]
        if mode in ("edge", "reflect", "symmetric", "wrap"):
            if n == 0:
                raise ValueError(f"can't extend empty axis {ax} using modes other than "
                                 "'constant' or 'empty'")
            parts = [t.index_select(ax, pad_src(torch.arange(lo, hi, device=t.device), n,
                                                before, mode))
                     for lo, hi in ((0, before), (before + n, before + n + after))]
        elif mode == "constant":
            parts = [torch.full(shp, v, dtype=t.dtype, device=t.device)
                     for shp, v in zip(shapes, values[ax])]
        elif mode == "linear_ramp":
            parts = [_pad_ramp(t, ax, t.narrow(ax, 0, 1), before),
                     _pad_ramp(t, ax, t.narrow(ax, n - 1, 1), after).flip(ax)]
        else:
            stat = _pad_stat(t, ax, mode)
            parts = [stat.expand(shp) for shp in shapes]
        t = torch.cat([parts[0], t, parts[1]], ax)
    return t


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """heat_tpu ``manipulations.py:461``. Margins on other axes apply to
    the shard; a constant margin on the split axis joins by the ring
    concatenation, an ``edge``/``reflect``/``symmetric``/``wrap`` margin by
    one window fetch; a ramp or a statistic on the split axis, and constant
    values that differ by axis, take the logical array (one all-gather) as
    heat_tpu does. Every mode pads on the array's device."""
    from . import _manips

    if mode == "empty":  # jnp.pad's empty margin is zeros
        mode, constant_values = "constant", 0
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"Unimplemented padding mode '{mode}' for np.pad.")
    pw = _normalize_pad_width(pad_width, array.ndim)
    if pw is None:
        raise ValueError(f"pad: pad_width {pad_width!r} does not fit an array of "
                         f"{array.ndim} dimensions")
    if any(b < 0 or a < 0 for b, a in pw):
        raise ValueError("index can't contain negative values")
    scalar = np.ndim(constant_values) == 0
    values = _constant_pairs(constant_values, array.ndim, array.larray.dtype) \
        if mode == "constant" else None
    if _distributed(array) and array.size > 0 and (mode != "constant" or scalar):
        split = array.split
        before, after = pw[split]
        other = tuple((0, 0) if i == split else p for i, p in enumerate(pw))
        local = _pad_local(array.larray, other, mode, values)
        gshape = tuple(s + (0 if i == split else pw[i][0] + pw[i][1])
                       for i, s in enumerate(array.gshape))
        out = DNDarray(local, gshape, array.dtype, split, array.device, array.comm)
        if before == 0 and after == 0:
            return out
        if mode == "constant":
            parts = []
            for width in (before, after):
                shp = tuple(width if i == split else s for i, s in enumerate(gshape))
                parts.append(factories.full(shp, constant_values, dtype=array.dtype,
                                            split=split, device=array.device, comm=array.comm))
            return concatenate([p for p in (parts[0], out, parts[1]) if p.shape[split]],
                               split)
        n = array.shape[split]
        if mode in ("edge", "reflect", "symmetric", "wrap") and \
                n > (1 if mode == "reflect" else 0):
            local = _manips.ring_pad(out.larray, split, n, before, after, mode, array.comm)
            g2 = tuple(s + (before + after if i == split else 0)
                       for i, s in enumerate(out.gshape))
            return DNDarray(local, g2, array.dtype, split, array.device, array.comm)
    res = _pad_local(array._logical(), pw, mode, values)
    return _wrap(res, array.split, array, array.dtype)


def _repeats(a: DNDarray, repeats, axis):
    """heat_tpu's checks of ``repeats``: a scalar (a size-1 array counts),
    or non-negative 1-D counts matching the repeated length."""
    if isinstance(repeats, DNDarray):
        repeats = repeats.numpy()
    if isinstance(repeats, (bool, np.bool_)) or not isinstance(repeats, (int, np.integer)):
        arr = np.asarray(repeats)
        if arr.ndim == 0 or (arr.ndim == 1 and arr.size == 1):
            repeats = int(arr.reshape(-1)[0])
        else:
            if arr.size and (arr < 0).any():
                raise ValueError("repeats must be non-negative")
            target = a.size if axis is None else a.shape[sanitize_axis(a.shape, axis)]
            if arr.ndim != 1 or arr.size != target:
                raise ValueError(f"repeats shape {arr.shape} does not match the repeat target "
                                 f"length {target}")
            return arr.astype(np.int64)
    repeats = int(repeats)
    if repeats < 0:
        raise ValueError("repeats must be non-negative")
    return repeats


def repeat(a: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """heat_tpu ``manipulations.py:540``. A scalar repeat of the split axis
    fans each row out through the window fetch; array counts build the
    source map ``searchsorted(cumsum(counts), i, right)`` on each rank's
    chunk of the output and take it through the ring gather; other axes
    repeat on the shard; ``axis=None`` flattens first."""
    from . import _manips

    repeats = _repeats(a, repeats, axis)
    scalar = isinstance(repeats, int)
    if _distributed(a) and a.size > 0 and (not scalar or repeats > 0):
        if axis is None:
            flat = a if a.ndim == 1 and a.split == 0 else flatten(a)
            return repeat(flat, repeats, 0)
        axis = sanitize_axis(a.shape, axis)
        total = repeats * a.shape[axis] if scalar else int(repeats.sum())
        gshape = tuple(total if i == axis else s for i, s in enumerate(a.gshape))
        if axis != a.split:
            reps = repeats if scalar else torch.as_tensor(repeats, device=a.larray.device)
            res = torch.repeat_interleave(a.larray, reps, dim=axis)
            return DNDarray(res, gshape, a.dtype, a.split, a.device, a.comm)
        if scalar:
            out = _manips.ring_repeat(a.larray, axis, a.shape[axis], repeats, a.comm)
            return DNDarray(out, gshape, a.dtype, axis, a.device, a.comm)
        if total == 0:
            return factories.empty(gshape, dtype=a.dtype, split=a.split, device=a.device,
                                   comm=a.comm)
        pos = factories.arange(total, split=0, device=a.device, comm=a.comm)
        cum = torch.cumsum(torch.as_tensor(repeats, device=pos.larray.device), 0)
        src = torch.searchsorted(cum, pos.larray, right=True)
        key = (slice(None),) * axis + (DNDarray(src, (total,), types.int64, 0, a.device,
                                                a.comm),)
        return a[key]
    reps = repeats if scalar else torch.as_tensor(repeats, device=a.larray.device)
    res = torch.repeat_interleave(a._logical(), reps, dim=axis)
    if axis is None:
        out_split = 0 if a.split is not None else None
    else:
        out_split = a.split
    return _wrap(res, out_split, a)


def reshape(a: DNDarray, *shape, new_split=None, **kwargs) -> DNDarray:
    """heat_tpu ``manipulations.py:642``. A split array re-chunks its
    row-major flat sequence: moved to split 0 (one resplit), then local
    where every rank's flat range stays its own, else one window fetch of
    flat ranges, then moved to ``new_split``."""
    from . import _manips

    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = tuple(a.size // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {shape}")
    if new_split is None:
        new_split = a.split if a.split is None else min(a.split, len(shape) - 1)
    if _distributed(a) and a.size > 0 and len(shape) > 0 and a.ndim > 0:
        comm = a.comm
        src = a if a.split == 0 else a.resplit(0)
        r_in = int(np.prod(src.gshape[1:], dtype=np.int64))
        r_out = int(np.prod(shape[1:], dtype=np.int64))
        if comm.chunk_size(src.gshape[0]) * r_in == comm.chunk_size(shape[0]) * r_out:
            local = src.larray.reshape((-1,) + shape[1:])
        else:
            local = _manips.ring_reshape(src.larray, src.gshape, shape, comm)
        res = DNDarray(local, shape, a.dtype, 0, a.device, comm)
        return res.resplit(new_split) if new_split != 0 else res
    if a.split is None or a.comm.size == 1:
        if new_split is not None:
            new_split = sanitize_axis(shape, new_split) if shape else None
        return DNDarray(a.larray.reshape(shape), shape, a.dtype, new_split, a.device, a.comm)
    return _wrap(a._logical().reshape(shape), new_split, a)


def resplit(arr: DNDarray, axis=None) -> DNDarray:
    """Out-of-place split change (heat_tpu ``manipulations.py:705``):
    :meth:`DNDarray.resplit`, one all-to-all from one split axis to another."""
    return arr.resplit(axis)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """heat_tpu ``manipulations.py:710``: other axes roll on the shard, the
    split axis through the window fetch (the wrap and the rest)."""
    from . import _manips

    if axis is None:
        if x.ndim == 1 and x.split == 0:
            return roll(x, sum(shift) if isinstance(shift, (tuple, list)) else shift, 0)
        res = torch.roll(x._logical().reshape(-1), shift).reshape(x.shape)
        return _wrap(res, x.split, x)
    axes = ((int(axis),) if isinstance(axis, (int, np.integer))
            else tuple(int(ax) for ax in axis))
    shifts = ((int(shift),) * len(axes) if isinstance(shift, (int, np.integer))
              else tuple(int(s) for s in shift))
    if len(shifts) != len(axes):
        raise ValueError("shift and axis must have the same length")
    axes = tuple(sanitize_axis(x.shape, ax) for ax in axes)
    if x.split is not None and x.split in axes:
        if x.comm.size > 1 and x.shape[x.split] > 0:
            split_shift = sum(s for s, ax in zip(shifts, axes) if ax == x.split)
            other = [(s, ax) for s, ax in zip(shifts, axes) if ax != x.split]
            local = x.larray
            if other:
                local = torch.roll(local, [s for s, _ in other], [ax for _, ax in other])
            out = _manips.ring_roll(local, x.split, x.shape[x.split], split_shift, x.comm)
            return DNDarray(out, x.gshape, x.dtype, x.split, x.device, x.comm)
        return _wrap(torch.roll(x._logical(), shifts, axes), x.split, x)
    return DNDarray(torch.roll(x.larray, shifts, axes), x.gshape, x.dtype, x.split, x.device,
                    x.comm)


def rot90(m: DNDarray, k: int = 1, axes: Sequence[int] = (0, 1)) -> DNDarray:
    """heat_tpu ``manipulations.py:751``: numpy's decomposition into the
    distributed flip and the local transpose."""
    axes = tuple(sanitize_axis(m.shape, ax) for ax in axes)
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError("len(axes) must be 2 and they must differ")
    k = k % 4
    if _distributed(m) and m.size > 0:
        if k == 0:
            from . import memory

            return memory.copy(m)
        if k == 2:
            return flip(m, axes)
        order = list(range(m.ndim))
        order[axes[0]], order[axes[1]] = order[axes[1]], order[axes[0]]
        if k == 1:
            return _transpose(flip(m, axes[1]), order)
        return flip(_transpose(m, order), axes[1])
    res = torch.rot90(m._logical(), k, axes)
    out_split = m.split
    if out_split in axes and k % 2 == 1:
        out_split = axes[0] if m.split == axes[1] else axes[1]
    return _wrap(res, out_split, m)


def shape(a: DNDarray) -> Tuple[int, ...]:
    """heat_tpu ``manipulations.py:790``."""
    return a.shape


def _split_points(n: int, indices_or_sections):
    if isinstance(indices_or_sections, (int, np.integer)):
        k = int(indices_or_sections)
        if k <= 0:
            raise ValueError("number sections must be larger than 0")
        if n % k:
            raise ValueError("array split does not result in an equal division")
        return [n // k * i for i in range(1, k)]
    return [int(i) for i in indices_or_sections]


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:856``: the logical array (one all-gather
    of a split array), cut at the points, each part re-chunked."""
    axis = sanitize_axis(x.shape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy().tolist()
    elif isinstance(indices_or_sections, np.ndarray):
        indices_or_sections = indices_or_sections.tolist()
    n = x.shape[axis]
    points = _split_points(n, indices_or_sections)
    logical = x._logical()
    bounds = [0] + [min(max(p + n if p < 0 else p, 0), n) for p in points] + [n]
    parts = [logical.narrow(axis, lo, max(hi - lo, 0)) for lo, hi in zip(bounds, bounds[1:])]
    return [_wrap(p, x.split, x) for p in parts]


def array_split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:839``: sections of unequal length allowed."""
    axis = sanitize_axis(x.shape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy().tolist()
    elif isinstance(indices_or_sections, np.ndarray):
        indices_or_sections = indices_or_sections.tolist()
    if isinstance(indices_or_sections, (int, np.integer)):
        n, k = x.shape[axis], int(indices_or_sections)
        if k <= 0:
            raise ValueError("number sections must be larger than 0")
        sizes = [n // k + 1] * (n % k) + [n // k] * (k - n % k)
        indices_or_sections = list(np.cumsum(sizes[:-1]))
    return split(x, indices_or_sections, axis=axis)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:1170``."""
    return split(x, indices_or_sections, axis=0)


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:410``."""
    return split(x, indices_or_sections, axis=0 if x.ndim < 2 else 1)


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """heat_tpu ``manipulations.py:331``."""
    return split(x, indices_or_sections, axis=2)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """heat_tpu ``manipulations.py:868``: a squeezed split axis is
    replicated first (one all-gather of its one row)."""
    if axis is not None:
        axes = _axes(x, axis)
        for ax in axes:
            if x.shape[ax] != 1:
                raise ValueError("cannot select an axis to squeeze out which has size not "
                                 f"equal to one, got axis {ax}")
    else:
        axes = tuple(i for i, s in enumerate(x.shape) if s == 1)
    if x.split is not None and x.split in axes:
        x = x.resplit(None)
    res = x.larray.squeeze(axes) if axes else x.larray
    split = x.split
    if split is not None:
        split -= sum(1 for ax in axes if ax < split)
    gshape = tuple(s for i, s in enumerate(x.shape) if i not in axes)
    return DNDarray(res, gshape, x.dtype, split, x.device, x.comm)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """heat_tpu ``manipulations.py:889``: inputs of one split join on the
    shard (the new axis is not split)."""
    from . import _operations

    arrays = list(arrays)
    shapes = {a.shape for a in arrays}
    if len(shapes) != 1:
        raise ValueError(f"all input arrays must have the same shape, got {shapes}")
    axis = sanitize_axis((len(arrays),) + tuple(arrays[0].shape), axis)
    base = arrays[0].split
    if base is not None and arrays[0].comm.size > 1 and \
            all(a.split == base for a in arrays) and arrays[0].size > 0:
        result = concatenate([expand_dims(a, axis) for a in arrays], axis)
    else:
        dtype = types.result_type(*arrays)
        res = torch.stack([a._logical().to(dtype.torch_type()) for a in arrays], axis)
        split = None if base is None else base + (1 if axis <= base else 0)
        result = _wrap(res, split, arrays[0], dtype)
    return _operations._finalize(result, out) if out is not None else result


def _tile_distributed(x: DNDarray, reps) -> Optional[DNDarray]:
    """Tiles that add no leading axes (heat_tpu ``manipulations.py:935``):
    other axes tile on the shard, the split axis as a ring concatenation of
    its copies."""
    reps = (reps,) if isinstance(reps, (int, np.integer)) else tuple(reps)
    if not _distributed(x) or x.size == 0 or len(reps) > x.ndim or \
            any(int(r) <= 0 for r in reps):
        return None
    reps = (1,) * (x.ndim - len(reps)) + tuple(int(r) for r in reps)
    split = x.split
    other = tuple(1 if i == split else r for i, r in enumerate(reps))
    local = x.larray.repeat(other) if any(r != 1 for r in other) else x.larray
    gshape = tuple(s * other[i] for i, s in enumerate(x.gshape))
    base = DNDarray(local, gshape, x.dtype, split, x.device, x.comm)
    return base if reps[split] == 1 else concatenate([base] * reps[split], split)


def tile(x: DNDarray, reps) -> DNDarray:
    """heat_tpu ``manipulations.py:955``."""
    if isinstance(reps, DNDarray):
        reps = reps.numpy().tolist()
    dist = _tile_distributed(x, reps)
    if dist is not None:
        return dist
    reps_t = (int(reps),) if isinstance(reps, (int, np.integer)) else tuple(int(r) for r in reps)
    res = torch.tile(x._logical(), reps_t)
    split = x.split
    if split is not None:
        split += res.ndim - x.ndim
    return _wrap(res, split, x)


# ---------------------------------------------------------------------- #
# sorting, top-k, unique and the set operations                           #
# ---------------------------------------------------------------------- #
def _argsort(t: torch.Tensor, dim: int, descending: bool = False) -> torch.Tensor:
    """``jnp.argsort``: stable (ties keep their order, descending too), NaN
    last ascending, first descending; bool as uint8; complex lexicographic
    by (real, imag), which ``torch.sort`` refuses."""
    if t.is_complex():
        o = torch.sort(t.imag, dim=dim, descending=descending, stable=True).indices
        o2 = torch.sort(torch.gather(t.real, dim, o), dim=dim, descending=descending,
                        stable=True).indices
        return torch.gather(o, dim, o2)
    from ._sort import _sortable

    return torch.sort(_sortable(t), dim=dim, descending=descending, stable=True).indices


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Sort along an axis (heat_tpu ``manipulations.py:795``); returns
    ``(values, indices)``, the indices int64 positions along ``axis``.

    Along the split axis at world size > 1 the merge-split network
    (:func:`._sort.distributed_sort`): R(p) rounds of one point-to-point
    permutation each, no all-gather; the result keeps the canonical layout.
    Otherwise a stable local sort of the shard."""
    axis = sanitize_axis(a.shape, axis)
    if a.split == axis and a.comm.size > 1 and a.shape[axis] > 0:
        from . import _sort

        values, idx = _sort.distributed_sort(a.larray, axis, a.shape[axis], descending, a.comm)
    elif a.larray.is_complex():
        idx = _argsort(a.larray, axis, descending)
        values = torch.gather(a.larray, axis, idx)
    else:
        from ._sort import _sortable

        values, idx = torch.sort(_sortable(a.larray), dim=axis, descending=descending,
                                 stable=True)
        values = values.view(a.larray.dtype)
    vals = DNDarray(values, a.gshape, a.dtype, a.split, a.device, a.comm)
    indices = DNDarray(idx, a.gshape, types.int64, a.split, a.device, a.comm)
    if out is not None:
        out.larray = vals.larray
        return out, indices
    return vals, indices


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True,
         out=None):
    """The ``k`` largest (or smallest) values and their indices along
    ``dim`` (heat_tpu ``manipulations.py:971``), in ``lax.top_k``'s order:
    ties to the lower index, a NaN first (also for the smallest, which
    heat_tpu selects as the largest of the negation).

    Along the split axis at world size > 1: heat_tpu's tournament
    (:func:`._manips.split_topk`), one all-gather of the candidates."""
    from . import _manips

    dim = sanitize_axis(a.shape, dim)
    if a.split == dim and a.comm.size > 1 and 0 < k <= a.shape[dim]:
        vals, idx = _manips.split_topk(a.larray, dim, a.shape[dim], int(k), bool(largest),
                                       a.comm)
        vals_d = _wrap(vals.movedim(-1, dim), a.split, a)
        idx_d = _wrap(idx.movedim(-1, dim), a.split, a)
    else:
        logical = a._logical() if a.split == dim else a.larray
        moved = logical.movedim(dim, -1)
        i = _manips.topk_order(_manips.topk_keyed(moved, largest), k)
        vals = torch.gather(moved, -1, i).movedim(-1, dim)
        idx = i.movedim(-1, dim)
        if a.split == dim:
            vals_d, idx_d = _wrap(vals, a.split, a), _wrap(idx, a.split, a)
        else:
            gshape = tuple(k if i == dim else s for i, s in enumerate(a.shape))
            vals_d = DNDarray(vals, gshape, a.dtype, a.split, a.device, a.comm)
            idx_d = DNDarray(idx, gshape, types.int64, a.split, a.device, a.comm)
    if out is not None:
        out[0].larray = vals_d.larray
        out[1].larray = idx_d.larray
        return out
    return vals_d, idx_d


def _unique_local(t: torch.Tensor, return_inverse: bool, return_counts: bool, axis):
    """``jnp.unique(..., equal_nan=False)`` of a whole tensor: a stable
    lexicographic sort of the slices along ``axis`` (flattened for None),
    first occurrences where a slice differs from its predecessor (so each
    NaN is its own), the inverse by the prefix count, the counts by the
    distances between first occurrences."""
    aux = t.reshape(-1) if axis is None else t.movedim(axis, 0)
    size = aux.shape[0]
    rows = aux.reshape(size, -1)
    order = torch.arange(size, device=t.device)
    for j in range(rows.shape[1] - 1, -1, -1):
        order = order[_argsort(rows[order, j], 0)]
    aux = aux[order]
    mask = torch.ones(size, dtype=torch.bool, device=t.device)
    if size:
        diff = aux[1:] != aux[:-1]
        mask[1:] = diff.reshape(size - 1, -1).any(1) if diff.ndim > 1 else diff
    res = aux[mask]
    out = [res if axis is None else res.movedim(0, axis)]
    if return_inverse:
        inv = torch.zeros(size, dtype=torch.int64, device=t.device)
        inv[order] = torch.cumsum(mask.to(torch.int64), 0) - 1
        out.append(inv.reshape(t.shape) if axis is None else inv)
    if return_counts:
        first = torch.nonzero(mask).reshape(-1)
        out.append(torch.diff(first, append=first.new_tensor([size])))
    return out


def _unique_split_1d(a: DNDarray, return_inverse: bool, return_counts: bool):
    """The distributed pipeline of a 1-D split array (heat_tpu
    ``_setops.distributed_unique``); results split 0."""
    from . import _setops

    n_unique, uniq, *rest = _setops.distributed_unique(a.larray, a.shape[0], return_inverse,
                                                       return_counts, a.comm)
    out = [DNDarray(uniq, (n_unique,), a.dtype, 0, a.device, a.comm)]
    if return_inverse:
        out.append(DNDarray(rest.pop(0), a.gshape, types.int64, 0, a.device, a.comm))
    if return_counts:
        out.append(DNDarray(rest.pop(0), (n_unique,), types.int64, 0, a.device, a.comm))
    return tuple(out) if len(out) > 1 else out[0]


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False,
           axis: Optional[int] = None, return_counts: bool = False):
    """Unique elements, sorted (heat_tpu ``manipulations.py:1086``), with
    the inverse and the counts on request.

    At world size > 1 a split array runs the distributed pipelines of
    :mod:`._setops` (network sort, halo compare, one host read of the
    count, network compaction), never gathering it: a 1-D array directly,
    an N-D one flattened first (its inverse reshaped back), and with
    ``axis`` the rows pipeline over the slices along ``axis``. The results
    are split. Otherwise ``jnp.unique``'s result on the logical array,
    replicated. Each NaN is its own unique."""
    dist = _distributed(a) and a.size > 0
    if axis is None and dist and a.ndim == 1:
        return _unique_split_1d(a, return_inverse, return_counts)
    if axis is None and dist:
        res = _unique_split_1d(flatten(a), return_inverse, return_counts)
        if not return_inverse:
            return res
        out = list(res)
        out[1] = reshape(out[1], a.shape)
        return tuple(out)
    if axis is not None and dist and not a.larray.is_complex():
        from . import _setops

        ax = sanitize_axis(a.shape, axis)
        if a.ndim == 1:
            return _unique_split_1d(a, return_inverse, return_counts)
        b = moveaxis(a, ax, 0) if ax != 0 else a
        if b.split != 0:
            b = b.resplit(0)
        n = b.shape[0]
        trailing = tuple(b.shape[1:])
        w = int(np.prod(trailing))
        n_unique, uniq, *rest = _setops.distributed_unique_rows(
            b.larray.reshape(b.larray.shape[0], w), n, return_inverse, return_counts, b.comm)
        out = DNDarray(uniq.reshape((uniq.shape[0],) + trailing), (n_unique,) + trailing,
                       b.dtype, 0, b.device, b.comm)
        if ax != 0:
            out = moveaxis(out, 0, ax)
        outs = [out]
        if return_inverse:
            outs.append(DNDarray(rest.pop(0), (n,), types.int64, 0, b.device, b.comm))
        if return_counts:
            outs.append(DNDarray(rest.pop(0), (n_unique,), types.int64, 0, b.device, b.comm))
        return tuple(outs) if len(outs) > 1 else out
    logical = a._logical()
    res = _unique_local(logical, return_inverse, return_counts, axis)
    if return_inverse and axis is not None:
        res[1] = res[1].reshape(-1)
    out = [_wrap(r, None, a) for r in res]
    return tuple(out) if len(out) > 1 else out[0]


def _as_array(ar, like: Optional[DNDarray] = None) -> DNDarray:
    if isinstance(ar, DNDarray):
        return ar
    if like is None:
        return factories.array(ar)
    return factories.array(ar, device=like.device, comm=like.comm)


def union1d(ar1: DNDarray, ar2: DNDarray) -> DNDarray:
    """Sorted union (``numpy.union1d``; heat_tpu ``manipulations.py:1025``):
    one unique over the concatenated flattened inputs."""
    ar1 = _as_array(ar1)
    ar2 = _as_array(ar2, ar1)
    return unique(concatenate([flatten(ar1), flatten(ar2)], axis=0), sorted=True)


def intersect1d(ar1: DNDarray, ar2, assume_unique: bool = False) -> DNDarray:
    """Sorted intersection (``numpy.intersect1d``; heat_tpu ``:1038``):
    unique, then the members of ``ar2`` selected by a mask (staying split).
    ``assume_unique`` skips the unique and sorts the selection."""
    from . import logical

    ar1 = _as_array(ar1)
    if assume_unique:
        sel = flatten(ar1)
        return sort(sel[logical.isin(sel, ar2)], axis=0)[0]
    u = unique(flatten(ar1), sorted=True)
    return u[logical.isin(u, ar2)]


def setdiff1d(ar1: DNDarray, ar2, assume_unique: bool = False) -> DNDarray:
    """Sorted values of ``ar1`` not in ``ar2`` (``numpy.setdiff1d``;
    heat_tpu ``:1055``); ``assume_unique`` keeps the input order."""
    from . import logical

    ar1 = _as_array(ar1)
    u = flatten(ar1) if assume_unique else unique(flatten(ar1), sorted=True)
    return u[logical.isin(u, ar2, invert=True)]


def setxor1d(ar1: DNDarray, ar2, assume_unique: bool = False) -> DNDarray:
    """Sorted symmetric difference (``numpy.setxor1d``; heat_tpu ``:1068``):
    the elements of both inputs' uniques that occur once."""
    ar1 = _as_array(ar1)
    ar2 = _as_array(ar2, ar1)
    if assume_unique:
        u1, u2 = flatten(ar1), flatten(ar2)
    else:
        u1 = unique(flatten(ar1), sorted=True)
        u2 = unique(flatten(ar2), sorted=True)
    u, counts = unique(concatenate([u1, u2], axis=0), sorted=True, return_counts=True)
    return u[counts == 1]
