"""Index-producing operations (heat_tpu ``core/indexing.py``)."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["compress", "extract", "indices", "nonzero", "put_along_axis",
           "ravel_multi_index", "take", "take_along_axis", "trim_zeros", "unravel_index",
           "where"]


def _nonzero_distributed(x: DNDarray) -> DNDarray:
    """heat_tpu ``indexing.py:28``: the compress of ``x[mask]`` over the
    global flat positions of a split-0 array (one resplit first where
    ``x`` is split elsewhere): one exclusive scan, one all-reduce of the
    count (the host reads it: the output's length), p - 1 ring steps. The
    coordinates never leave the ranks that own them in the result."""
    from . import _indexing

    comm = x.comm
    src = x if x.split == 0 else x.resplit(0)
    local = src.larray
    row = int(np.prod(x.gshape[1:], dtype=np.int64))
    offset, _, _ = comm.chunk(x.gshape, 0)
    flat = torch.arange(offset * row, offset * row + local.numel(), dtype=torch.int64,
                        device=local.device)
    mask = local.reshape(-1) != 0
    pos, m = _indexing.mask_positions(mask, comm)
    if m == 0:
        return DNDarray.from_global(local.new_zeros((0, x.ndim), dtype=torch.int64), None,
                                    x.device, comm)
    kept = _indexing.ring_compress(flat, 0, comm.chunk_size(x.gshape[0]) * row, pos, m, comm)
    coords = torch.stack([(kept // int(np.prod(x.gshape[j + 1:], dtype=np.int64)))
                          % x.gshape[j] for j in range(x.ndim)], 1)
    return DNDarray(coords, (m, x.ndim), types.int64, 0, x.device, comm)


def nonzero(x: DNDarray) -> DNDarray:
    """Indices of the nonzero elements as an ``(nnz, ndim)`` array (heat_tpu
    ``indexing.py:81``); a split array's result is split along axis 0."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if x.split is not None and x.comm.size > 1 and x.size > 0 and x.ndim > 0:
        return _nonzero_distributed(x)
    logical = x._logical()
    if x.ndim == 0:
        stacked = logical.new_zeros((0, 0), dtype=torch.int64)
    else:
        stacked = torch.nonzero(logical)
    return DNDarray.from_global(stacked, 0 if x.split is not None else None, x.device, x.comm)


def _beside(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` on ``c``'s device. The engine passes a python scalar as a 0-d
    CPU tensor, which ``torch.where`` would copy to the card, waiting for
    the card: it is filled there instead."""
    if v.device != c.device and v.ndim == 0:
        return torch.full((), v.item(), dtype=v.dtype, device=c.device)
    return v


def _pick_true(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(c != 0, _beside(c, v), 0)


def _pick_false(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(c != 0, 0, _beside(c, v))


def where(cond, x=None, y=None) -> DNDarray:
    """``cond ? x : y`` (heat_tpu ``indexing.py:110``), built as heat_tpu
    builds it, so its result type is heat_tpu's: ``where(cond, x, 0) +
    where(cond, 0, y)``, each through the binary-op engine. Without ``x``
    and ``y``, :func:`nonzero`."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    if not isinstance(cond, DNDarray):
        raise TypeError(f"expected cond to be a DNDarray, but was {type(cond)}")
    from . import arithmetics

    c = cond.astype(types.bool)
    return arithmetics.add(_operations._binary_op(_pick_true, c, x),
                           _operations._binary_op(_pick_false, c, y))


def take(a: DNDarray, indices, axis=None, out=None) -> DNDarray:
    """``numpy.take`` (heat_tpu ``indexing.py:128``), through the
    distributed fancy getitem."""
    from . import factories, manipulations

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    idx = indices.astype(types.int64) if isinstance(indices, DNDarray) else np.asarray(indices)
    if axis is None:
        result = manipulations.flatten(a)[idx]
    else:
        axis = sanitize_axis(a.shape, axis)
        result = a[(slice(None),) * axis + (idx,)]
    return _operations._finalize(result, out)


def compress(condition, a: DNDarray, axis=None, out=None) -> DNDarray:
    """``numpy.compress`` (heat_tpu ``indexing.py:148``): the kept positions
    of the host condition, through :func:`take`."""
    (idx,) = np.nonzero(np.asarray(condition, dtype=bool).ravel())
    return take(a, idx, axis=axis, out=out)


def extract(condition, arr: DNDarray) -> DNDarray:
    """``numpy.extract`` (heat_tpu ``indexing.py:157``): the boolean
    selection of the flattened array (stays split)."""
    from . import factories, manipulations

    if not isinstance(arr, DNDarray):
        arr = factories.array(arr)
    if not isinstance(condition, DNDarray):
        condition = factories.array(np.asarray(condition), split=arr.split, device=arr.device,
                                    comm=arr.comm)
    flat = manipulations.flatten(arr)
    mask = manipulations.flatten(condition) != 0
    if mask.split != flat.split:
        mask = mask.resplit(flat.split)
    return flat[mask]


def trim_zeros(filt: DNDarray, trim: str = "fb") -> DNDarray:
    """``numpy.trim_zeros`` of a 1-D array (heat_tpu ``indexing.py:174``):
    the first and last nonzero positions are read on the host."""
    from . import factories

    if not isinstance(filt, DNDarray):
        filt = factories.array(filt)
    if filt.ndim != 1:
        raise ValueError("trim_zeros expects a 1-D array")
    trim = trim.lower()
    nz = nonzero(filt != 0)
    if nz.size == 0:
        return filt[0:0]
    start = int(nz[0].item()) if "f" in trim else 0
    stop = int(nz[-1].item()) + 1 if "b" in trim else filt.shape[0]
    return filt[start:stop]


def unravel_index(indices, shape):
    """``numpy.unravel_index`` (heat_tpu ``indexing.py:193``): elementwise
    arithmetic on the (possibly split) index array."""
    from . import factories

    if not isinstance(indices, DNDarray):
        indices = factories.array(np.asarray(indices))
    total = int(np.prod(shape))
    if indices.size:
        hi, lo = int(indices.max().item()), int(indices.min().item())
        if hi >= total or lo < 0:
            raise ValueError(f"index {hi if hi >= total else lo} is out of bounds for array "
                             f"with size {total}")
    out, stride = [], total
    for dim in shape:
        stride //= int(dim)
        out.append((indices // stride) % int(dim))
    return tuple(out)


def ravel_multi_index(multi_index, dims) -> DNDarray:
    """``numpy.ravel_multi_index`` (heat_tpu ``indexing.py:216``)."""
    from . import factories

    arrs = [a if isinstance(a, DNDarray) else factories.array(np.asarray(a))
            for a in multi_index]
    if len(arrs) != len(dims):
        raise ValueError("multi_index length must match dims")
    flat, stride = None, int(np.prod(dims))
    for a, dim in zip(arrs, dims):
        if a.size and (int(a.max().item()) >= int(dim) or int(a.min().item()) < 0):
            raise ValueError(f"invalid entry in coordinates array for dimension of size {dim}")
        stride //= int(dim)
        term = a * stride
        flat = term if flat is None else flat + term
    return flat


def indices(dimensions, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``numpy.indices`` (heat_tpu ``indexing.py:239``): shape ``(len(dims),
    *dims)``, ``split`` counting the leading grid axis."""
    from . import factories

    grids = np.indices(tuple(int(d) for d in dimensions))
    return factories.array(grids, dtype=dtype or types.int64, split=split, device=device,
                           comm=comm)


def _align_indices(arr: DNDarray, indices, axis: int) -> DNDarray:
    """Indices as a DNDarray split like ``arr`` (their shapes may differ
    along ``axis`` only; an axis of extent 1 stays replicated), with
    numpy's out-of-bounds error (heat_tpu ``indexing.py:248``)."""
    from . import factories

    def can_split(shape):
        return arr.split is not None and len(shape) > arr.split and \
            shape[arr.split] == arr.shape[arr.split]

    if not isinstance(indices, DNDarray):
        ind = np.asarray(indices)
        indices = factories.array(ind, split=arr.split if can_split(ind.shape) else None,
                                  device=arr.device, comm=arr.comm)
    elif indices.split != arr.split:
        indices = indices.resplit(arr.split if can_split(indices.gshape) else None)
    if indices.size:
        hi, lo = int(indices.max().item()), int(indices.min().item())
        n = arr.shape[axis]
        if hi >= n or lo < -n:
            raise IndexError(f"index {hi if hi >= n else lo} is out of bounds for axis {axis} "
                             f"with size {n}")
    return indices


def _local_indices(arr: DNDarray, indices: DNDarray, axis: int) -> torch.Tensor:
    """This rank's index tensor, broadcast against ``arr``'s shard on every
    axis but ``axis``, negatives normalized."""
    idx = indices.larray.to(device=arr.larray.device, dtype=torch.int64)
    idx = torch.where(idx < 0, idx + arr.shape[axis], idx)
    shape = [max(a, b) if i != axis else b for i, (a, b) in
             enumerate(zip(arr.larray.shape, idx.shape))]
    return idx.expand(shape)


def take_along_axis(arr: DNDarray, indices, axis) -> DNDarray:
    """``numpy.take_along_axis`` (heat_tpu ``indexing.py:278``): a local
    gather once the split is off the gather axis (at most one resplit)."""
    from . import factories, manipulations

    if not isinstance(arr, DNDarray):
        arr = factories.array(arr)
    if axis is None:
        return take_along_axis(manipulations.flatten(arr), indices, 0)
    axis = sanitize_axis(arr.shape, axis)
    if arr.split == axis and arr.comm.size > 1:
        arr = arr.resplit((axis + 1) % arr.ndim if arr.ndim > 1 else None)
    indices = _align_indices(arr, indices, axis)
    idx = _local_indices(arr, indices, axis)
    src_shape = [s if i == axis else idx.shape[i] for i, s in enumerate(arr.larray.shape)]
    res = torch.gather(arr.larray.expand(src_shape), axis, idx)
    gshape = tuple(np.broadcast_shapes(
        tuple(1 if i == axis else s for i, s in enumerate(arr.shape)), indices.gshape))
    return DNDarray(res, gshape, arr.dtype, arr.split, arr.device, arr.comm)


def put_along_axis(arr: DNDarray, indices, values, axis) -> None:
    """``numpy.put_along_axis`` (heat_tpu ``indexing.py:302``): updates
    ``arr`` (its shard replaced) by a local scatter once the split is off
    the axis."""
    if not isinstance(arr, DNDarray):
        raise TypeError("put_along_axis updates in place and requires a DNDarray")
    if axis is None:
        raise NotImplementedError("put_along_axis with axis=None (flattened in-place update) "
                                  "is not supported on the canonical layout; reshape "
                                  "explicitly")
    axis = sanitize_axis(arr.shape, axis)
    work = arr
    if work.split == axis and work.comm.size > 1:
        work = work.resplit((axis + 1) % work.ndim if work.ndim > 1 else None)
    indices = _align_indices(work, indices, axis)
    idx = _local_indices(work, indices, axis)
    tdt = work.larray.dtype
    if isinstance(values, DNDarray):
        if values.gshape == indices.gshape and values.split == work.split:
            vals = values.larray.to(tdt)
        else:
            vals = values._logical().to(tdt)
    else:
        vals = torch.as_tensor(np.asarray(values)).to(device=work.larray.device, dtype=tdt)
    if vals.shape != idx.shape:
        if vals.ndim == idx.ndim and work.split is not None and work.comm.size > 1 and \
                vals.shape[work.split] == work.shape[work.split] != idx.shape[work.split]:
            _, _, slices = work.comm.chunk(vals.shape, work.split)
            vals = vals[slices]
        vals = torch.broadcast_to(vals, idx.shape)
    res = work.larray.clone().scatter_(axis, idx, vals)
    updated = DNDarray(res, work.gshape, work.dtype, work.split, work.device, work.comm)
    if updated.split != arr.split:
        updated = updated.resplit(arr.split)
    arr.larray = updated.larray
