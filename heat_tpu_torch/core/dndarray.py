"""The distributed n-dimensional array over ``torch.distributed``
(heat_tpu ``core/dndarray.py``).

A DNDarray is a global array with NumPy semantics, optionally *split*
along one axis across the ranks of a :class:`TorchCommunication`. As in the
original Heat, ``larray`` is the process-local ``torch.Tensor`` shard — in
heat_tpu it is the padded physical global array instead. Shards follow the
ceil-chunk layout of :meth:`TorchCommunication.chunk` and carry no padding,
so logical values, ``gshape``, ``split`` and ``lshape_map`` agree with
heat_tpu while the storage differs.

This slice carries what the KMeans/cdist path uses: construction and
metadata, ``resplit`` between ``None`` and a split axis, indexing by an
integer array or basic slices, ``astype``/``numpy``/``item`` and the
``min``/``argmin``/``sum``/``+``/``**`` operations. Other index forms raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, sanitize_comm
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed n-dimensional array.

    Parameters
    ----------
    array : torch.Tensor
        This rank's shard (the whole array when ``split`` is None).
    gshape : tuple of int
        Logical global shape.
    dtype : heat type
    split : int or None
    device : Device
    comm : TorchCommunication
    """

    def __init__(self, array: torch.Tensor, gshape, dtype, split, device, comm):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm

    @staticmethod
    def from_global(tensor: torch.Tensor, split=None, device=None, comm=None,
                    dtype=None) -> "DNDarray":
        """Wrap a global tensor that every rank holds: each rank keeps its own
        chunk along ``split`` (no communication)."""
        comm = sanitize_comm(comm)
        device = devices.sanitize_device(device)
        if dtype is not None:
            dtype = types.canonical_heat_type(dtype)
            tensor = tensor.to(dtype.torch_type())
        else:
            dtype = types.canonical_heat_type(tensor.dtype)
        gshape = tuple(tensor.shape)
        if tensor.ndim == 0:
            split = None
        if split is not None:
            split = sanitize_axis(gshape, split)
            _, _, slices = comm.chunk(gshape, split)
            tensor = tensor[slices]
        tensor = tensor.to(device.torch_device)
        if tensor.numel() < int(np.prod(gshape)):
            tensor = tensor.clone()  # the shard must not pin the global buffer
        return DNDarray(tensor, gshape, dtype, split, device, comm)

    # ------------------------------------------------------------------ #
    # properties                                                         #
    # ------------------------------------------------------------------ #
    @property
    def larray(self) -> torch.Tensor:
        """This rank's shard."""
        return self.__array

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def device(self):
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape)) if self.__gshape else 1

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def lshape(self) -> Tuple[int, ...]:
        """This rank's shard shape."""
        return tuple(self.__array.shape)

    @property
    def lshape_map(self) -> np.ndarray:
        """``(size, ndim)`` per-rank shard shapes (heat_tpu ``dndarray.py:390``)."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    def counts_displs(self):
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        return self.__comm.counts_displs(self.__gshape[self.__split])

    def __repr__(self) -> str:
        return (f"DNDarray(gshape={self.__gshape}, dtype={self.__dtype.__name__}, "
                f"split={self.__split}, device={self.__device})")

    # ------------------------------------------------------------------ #
    # distribution                                                       #
    # ------------------------------------------------------------------ #
    def _logical(self) -> torch.Tensor:
        """The global array on every rank (an all-gather when split)."""
        if self.__split is None or self.__comm.size == 1:
            return self.__array
        counts, _ = self.counts_displs()
        return self.__comm.Allgather(self.__array, self.__split, counts)

    def _resplit_tensor(self, axis):
        if axis == self.__split:
            return self.__array
        full = self._logical()
        if axis is None:
            return full
        _, _, slices = self.__comm.chunk(self.__gshape, axis)
        return full[slices].clone()

    def resplit_(self, axis=None) -> "DNDarray":
        """In-place split change (heat_tpu ``dndarray.py:433``). ``None`` to
        split is a local slice; split to ``None`` is one all-gather; split to
        another split goes through the gathered array."""
        if axis is not None:
            axis = sanitize_axis(self.__gshape, axis)
        self.__array = self._resplit_tensor(axis)
        self.__split = axis
        return self

    def resplit(self, axis=None) -> "DNDarray":
        """Out-of-place split change (heat_tpu ``dndarray.py:474``)."""
        if axis is not None:
            axis = sanitize_axis(self.__gshape, axis)
        return DNDarray(self._resplit_tensor(axis), self.__gshape, self.__dtype, axis,
                        self.__device, self.__comm)

    # ------------------------------------------------------------------ #
    # conversion                                                         #
    # ------------------------------------------------------------------ #
    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype`` (heat_tpu ``dndarray.py:605``)."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.__array.to(dtype.torch_type())
        if copy:
            return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm)
        self.__array = casted
        self.__dtype = dtype
        return self

    def numpy(self) -> np.ndarray:
        """The logical global array on the host (heat_tpu ``dndarray.py:631``).
        numpy has no bfloat16: bf16 arrays come back as float32."""
        t = self._logical().detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def item(self):
        """Scalar extraction (heat_tpu ``dndarray.py:642``)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to scalars")
        return self._logical().reshape(()).item()

    # ------------------------------------------------------------------ #
    # indexing                                                           #
    # ------------------------------------------------------------------ #
    def __getitem__(self, key) -> "DNDarray":
        """Indexing (heat_tpu ``dndarray.py:678``) by a 1-D integer array
        along axis 0, or by basic keys (ints, slices, ``...``). Rows along
        the split axis are gathered from their owners; any other key form
        raises ``NotImplementedError``."""
        idx = _int_array_key(key)
        if idx is not None:
            return self._take_rows(idx)
        return self._basic_getitem(_normalize_basic_key(key, self.ndim))

    def _take_rows(self, idx: np.ndarray) -> "DNDarray":
        n = self.__gshape[0] if self.ndim else 0
        if idx.size and (idx.min() < -n or idx.max() >= n):
            raise IndexError(f"index out of bounds for axis 0 with size {n}")
        idx = np.where(idx < 0, idx + n, idx)
        if self.__split != 0:
            rows = self.__array[torch.as_tensor(idx, device=self.__array.device)]
            return DNDarray(rows, (len(idx),) + self.__gshape[1:], self.__dtype,
                            self.__split, self.__device, self.__comm)
        rows = self._gather_rows(idx)
        return DNDarray.from_global(rows, 0, self.__device, self.__comm, self.__dtype)

    def _gather_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Global rows ``idx`` of a split-0 array, on every rank: each rank
        contributes the rows it owns, one all-reduce assembles them."""
        local = self.__array
        if self.__comm.size == 1:
            return local[torch.as_tensor(idx, device=local.device)]
        offset, lshape, _ = self.__comm.chunk(self.__gshape, 0)
        mine = (idx >= offset) & (idx < offset + lshape[0])
        out = torch.zeros((len(idx),) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        where = torch.as_tensor(np.flatnonzero(mine), device=local.device)
        src = torch.as_tensor(idx[mine] - offset, device=local.device)
        out[where] = local[src]
        if out.dtype == torch.bool:
            return self.__comm.Allreduce(out.to(torch.uint8), "max").bool()
        return self.__comm.Allreduce(out, "sum")

    def _basic_getitem(self, key: tuple) -> "DNDarray":
        split = self.__split
        if split is None:
            sub = self.__array[key]
            return DNDarray(sub, tuple(sub.shape), self.__dtype, None, self.__device,
                            self.__comm)
        k = key[split]
        if isinstance(k, slice) and k == slice(None):
            sub = self.__array[key]
            new_split = split - sum(1 for i in range(split) if isinstance(key[i], int))
            gshape = list(sub.shape)
            gshape[new_split] = self.__gshape[split]
            return DNDarray(sub, tuple(gshape), self.__dtype, new_split, self.__device,
                            self.__comm)
        if split != 0:
            raise NotImplementedError(
                "basic indexing along a split axis other than 0 waits for a later slice")
        # the key selects along the split axis: gather the selected rows on
        # every rank, apply the rest of the key, re-chunk a kept axis 0
        sel = np.arange(self.__gshape[0])[k]
        rows = self._gather_rows(np.atleast_1d(sel))
        if isinstance(k, int):
            sub = rows[0][key[1:]]
            return DNDarray(sub, tuple(sub.shape), self.__dtype, None, self.__device,
                            self.__comm)
        sub = rows[(slice(None),) + key[1:]]
        return DNDarray.from_global(sub, 0, self.__device, self.__comm, self.__dtype)

    # ------------------------------------------------------------------ #
    # operations                                                         #
    # ------------------------------------------------------------------ #
    def sum(self, axis=None, keepdims: bool = False) -> "DNDarray":
        from . import _operations

        return _operations._reduce_op(self, torch.sum, 0, axis, keepdims, "sum")

    def min(self, axis=None, keepdims: bool = False) -> "DNDarray":
        from . import _operations

        return _operations._reduce_op(self, torch.amin, _max_value(self.__array.dtype),
                                      axis, keepdims, "min")

    def argmin(self, axis=None) -> "DNDarray":
        """Index of the minimum (heat_tpu ``dndarray.py:947``); ties take the
        first index, across ranks too."""
        if axis is None:
            flat = self._logical().reshape(-1)
            return DNDarray.from_global(torch.argmin(flat), None, self.__device, self.__comm)
        axis = sanitize_axis(self.__gshape, axis)
        gshape = tuple(s for i, s in enumerate(self.__gshape) if i != axis)
        if axis != self.__split:
            res = torch.argmin(self.__array, dim=axis)
            split = None if self.__split is None else self.__split - (axis < self.__split)
            return DNDarray(res, gshape, types.int64, split, self.__device, self.__comm)
        return self._argmin_split_axis(axis, gshape)

    def _argmin_split_axis(self, axis, gshape) -> "DNDarray":
        local = self.__array
        if local.shape[axis] == 0:
            shp = list(local.shape)
            shp[axis] = 1
            local = torch.full(shp, _max_value(local.dtype), dtype=local.dtype,
                               device=local.device)
        vals, idx = torch.min(local, dim=axis)
        offset, _, _ = self.__comm.chunk(self.__gshape, axis)
        idx = idx + offset
        allv = self.__comm.Allgather(vals.unsqueeze(0), 0)
        alli = self.__comm.Allgather(idx.unsqueeze(0), 0)
        # the first rank holding the minimum wins: lower ranks own lower indices
        best = torch.argmin(allv, dim=0, keepdim=True)
        res = torch.gather(alli, 0, best)[0]
        return DNDarray(res, gshape, types.int64, None, self.__device, self.__comm)

    def __add__(self, other) -> "DNDarray":
        from . import _operations

        return _operations._binary_op(torch.add, self, other)

    def __radd__(self, other) -> "DNDarray":
        from . import _operations

        return _operations._binary_op(torch.add, other, self)

    def __pow__(self, other) -> "DNDarray":
        from . import _operations

        return _operations._binary_op(_pow, self, other)

    def __rpow__(self, other) -> "DNDarray":
        from . import _operations

        return _operations._binary_op(_pow, other, self)


def _pow(a, b):
    """``torch.pow`` with bool tensors taken as int32, as ``jnp.power``
    promotes them (heat_tpu: bool ** bool is int32)."""
    if isinstance(a, torch.Tensor) and a.dtype == torch.bool:
        a = a.to(torch.int32)
    if isinstance(b, torch.Tensor) and b.dtype == torch.bool:
        b = b.to(torch.int32)
    return torch.pow(a, b)


def _max_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _int_array_key(key) -> Optional[np.ndarray]:
    if isinstance(key, DNDarray):
        key = key.numpy()
    elif isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    elif isinstance(key, list):
        key = np.asarray(key)
    if isinstance(key, np.ndarray):
        if key.ndim != 1 or not np.issubdtype(key.dtype, np.integer):
            raise NotImplementedError(
                "only 1-D integer index arrays are supported in this slice")
        return key.astype(np.int64)
    return None


def _normalize_basic_key(key, ndim: int) -> tuple:
    if not isinstance(key, tuple):
        key = (key,)
    for k in key:
        if not (k is Ellipsis or isinstance(k, (slice, int, np.integer))) or isinstance(k, bool):
            raise NotImplementedError(f"index of type {type(k).__name__} is not supported")
    if sum(k is Ellipsis for k in key) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (ndim - len(key) + 1) + key[i + 1:]
    if len(key) > ndim:
        raise IndexError(f"too many indices for array of dimension {ndim}")
    key = key + (slice(None),) * (ndim - len(key))
    return tuple(int(k) if isinstance(k, (int, np.integer)) else k for k in key)
