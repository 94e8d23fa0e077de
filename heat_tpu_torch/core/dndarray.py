"""The distributed n-dimensional array over ``torch.distributed``
(heat_tpu ``core/dndarray.py``).

A DNDarray is a global array with NumPy semantics, optionally *split*
along one axis across the ranks of a :class:`TorchCommunication`. As in the
original Heat, ``larray`` is the process-local ``torch.Tensor`` shard — in
heat_tpu it is the padded physical global array instead. Shards follow the
ceil-chunk layout of :meth:`TorchCommunication.chunk` and carry no padding,
so logical values, ``gshape``, ``split`` and ``lshape_map`` agree with
heat_tpu while the storage differs.

Operations run eagerly, one torch call on the shard each (heat_tpu's fusion
tape is not ported). Split changes go through :mod:`.resharding`: split to
split is ONE all-to-all. Indexing takes an integer array along axis 0, or
basic keys (ints, slices, ``...``) along any axis; boolean masks and the
other advanced forms raise ``NotImplementedError``.
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

    @larray.setter
    def larray(self, tensor: torch.Tensor):
        """Replace this rank's shard; its shape must be this rank's chunk."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        if tuple(tensor.shape) != tuple(lshape):
            raise ValueError(f"local tensor shape {tuple(tensor.shape)} does not match this "
                             f"rank's chunk {tuple(lshape)}")
        self.__array = tensor

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

    @property
    def T(self) -> "DNDarray":
        """All axes reversed (heat_tpu ``dndarray.py:403``); the split axis
        moves with its axis, no communication."""
        split = None if self.__split is None else self.ndim - 1 - self.__split
        return DNDarray(self.__array.permute(*reversed(range(self.ndim))),
                        self.__gshape[::-1], self.__dtype, split, self.__device, self.__comm)

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    def __repr__(self) -> str:
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__

    # ------------------------------------------------------------------ #
    # distribution                                                       #
    # ------------------------------------------------------------------ #
    def _logical(self) -> torch.Tensor:
        """The global array on every rank (an all-gather when split)."""
        if self.__split is None or self.__comm.size == 1:
            return self.__array
        counts, _ = self.counts_displs()
        return self.__comm.Allgather(self.__array, self.__split, counts)

    def resplit_(self, axis=None) -> "DNDarray":
        """In-place split change (heat_tpu ``dndarray.py:433``) through
        :func:`.resharding.reshard`: None to split is a local slice, split to
        None one all-gather, split to split ONE all-to-all."""
        from . import resharding

        if axis is not None:
            axis = sanitize_axis(self.__gshape, axis)
        self.__array = resharding.reshard(self.__array, self.__gshape, self.__split, axis,
                                          self.__comm)
        self.__split = axis
        return self

    def resplit(self, axis=None) -> "DNDarray":
        """Out-of-place split change (heat_tpu ``dndarray.py:474``)."""
        from . import resharding

        if axis is not None:
            axis = sanitize_axis(self.__gshape, axis)
        local = resharding.reshard(self.__array, self.__gshape, self.__split, axis, self.__comm)
        return DNDarray(local, self.__gshape, self.__dtype, axis, self.__device, self.__comm)

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

    def tolist(self) -> list:
        return self.numpy().tolist()

    def item(self):
        """Scalar extraction (heat_tpu ``dndarray.py:642``)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to scalars")
        return self._logical().reshape(()).item()

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        return int(self.item())

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    # ------------------------------------------------------------------ #
    # indexing                                                           #
    # ------------------------------------------------------------------ #
    def __getitem__(self, key) -> "DNDarray":
        """Indexing (heat_tpu ``dndarray.py:678``) by a 1-D integer array
        along axis 0, or by basic keys (ints, slices, ``...``) along any
        axis. Elements selected along the split axis reach their new owners
        through one all-reduce; any other key form raises
        ``NotImplementedError``."""
        idx = _int_array_key(key)
        if idx is not None:
            return self._take_rows(idx)
        return self._basic_getitem(_normalize_basic_key(key, self.__gshape))

    def _take_rows(self, idx: np.ndarray) -> "DNDarray":
        n = self.__gshape[0] if self.ndim else 0
        if idx.size and (idx.min() < -n or idx.max() >= n):
            raise IndexError(f"index out of bounds for axis 0 with size {n}")
        idx = np.where(idx < 0, idx + n, idx)
        if self.__split != 0:
            rows = self.__array[torch.as_tensor(idx, device=self.__array.device)]
            return DNDarray(rows, (len(idx),) + self.__gshape[1:], self.__dtype,
                            self.__split, self.__device, self.__comm)
        rows = self._gather_along(self.__array, 0, idx)
        return DNDarray.from_global(rows, 0, self.__device, self.__comm, self.__dtype)

    def _gather_along(self, local: torch.Tensor, axis: int, sel: np.ndarray) -> torch.Tensor:
        """The global elements ``sel`` along the split axis ``axis`` of
        ``local`` (this rank's shard, other axes already keyed), on every
        rank: each rank writes the ones it owns into zeros, one all-reduce
        assembles them."""
        if self.__comm.size == 1:
            return local.index_select(axis, torch.as_tensor(sel, device=local.device))
        offset, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        mine = (sel >= offset) & (sel < offset + lshape[self.__split])
        shape = list(local.shape)
        shape[axis] = len(sel)
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        where = torch.as_tensor(np.flatnonzero(mine), device=local.device)
        src = torch.as_tensor(sel[mine] - offset, device=local.device)
        out.index_copy_(axis, where, local.index_select(axis, src))
        return self.__comm.Allreduce(out, "max" if out.dtype == torch.bool else "sum")

    def _basic_getitem(self, key: tuple) -> "DNDarray":
        split = self.__split
        if split is None:
            sub = _apply_basic(self.__array, key)
            return DNDarray(sub, tuple(sub.shape), self.__dtype, None, self.__device,
                            self.__comm)
        new_split = split - sum(1 for i in range(split) if isinstance(key[i], int))
        k = key[split]
        if isinstance(k, slice) and k == slice(None):
            sub = _apply_basic(self.__array, key)
            gshape = list(sub.shape)
            gshape[new_split] = self.__gshape[split]
            return DNDarray(sub, tuple(gshape), self.__dtype, new_split, self.__device,
                            self.__comm)
        # the key selects along the split axis: key the other axes locally,
        # gather the selected elements on every rank, re-chunk a kept axis
        sel = np.ascontiguousarray(np.atleast_1d(np.arange(self.__gshape[split])[k]))
        sub = _apply_basic(self.__array, key[:split] + (slice(None),) + key[split + 1:])
        sub = self._gather_along(sub, new_split, sel)
        if isinstance(k, int):
            sub = sub.select(new_split, 0)
            return DNDarray(sub, tuple(sub.shape), self.__dtype, None, self.__device,
                            self.__comm)
        return DNDarray.from_global(sub, new_split, self.__device, self.__comm, self.__dtype)

    def __setitem__(self, key, value):
        """Assignment by basic keys (heat_tpu ``dndarray.py:683``): ints,
        slices and ``...``, with a scalar or a DNDarray value broadcast to
        the keyed shape. Each rank writes the part of the key that falls in
        its chunk, into a new shard; no communication unless ``value`` is a
        split DNDarray (gathered first). Other key forms raise
        ``NotImplementedError``."""
        key = _normalize_basic_key(key, self.__gshape)
        local = self.__array
        if isinstance(value, DNDarray):
            value = value._logical()
        value = torch.as_tensor(value, device=local.device).to(local.dtype)
        # the keyed shape, and the axis of it that the split axis becomes
        rshape = tuple(len(range(*k.indices(n))) for k, n in zip(key, self.__gshape)
                       if isinstance(k, slice))
        value = torch.broadcast_to(value, rshape)
        split = self.__split
        if split is not None:
            offset, lshape, _ = self.__comm.chunk(self.__gshape, split)
            sel = np.atleast_1d(np.arange(self.__gshape[split])[key[split]])
            mine = np.flatnonzero((sel >= offset) & (sel < offset + lshape[split]))
            if mine.size == 0:
                return
            k = key[split]
            if isinstance(k, int):
                key = key[:split] + (int(sel[0] - offset),) + key[split + 1:]
            else:
                ax = split - sum(1 for i in range(split) if isinstance(key[i], int))
                value = value.index_select(ax, torch.as_tensor(mine, device=local.device))
                # the owned part of a slice is a slice of the shard
                lo = int(sel[mine[0]] - offset)
                step = k.indices(self.__gshape[split])[2]
                key = key[:split] + (slice(lo, lo + step * mine.size, step)
                                     if step > 0 else slice(lo, None if lo + step * mine.size < 0
                                                            else lo + step * mine.size, step),) \
                    + key[split + 1:]
        tkey, flips = _torch_key(key, local.shape)
        # the shard may be shared with another DNDarray (a resplit or ``.T``
        # at world size 1, a replicated getitem, ``real`` of a real array):
        # write into a copy, as heat_tpu's ``.at[].set`` makes a new array
        local = local.clone()
        local[tkey] = value.flip(flips) if flips else value
        self.__array = local

    # ------------------------------------------------------------------ #
    # operator protocol — delegates to the ops namespaces                #
    # ------------------------------------------------------------------ #
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __sub__(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        from . import arithmetics

        return arithmetics.sub(other, self)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        from . import arithmetics

        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        from . import arithmetics

        return arithmetics.div(other, self)

    def __floordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        from . import arithmetics

        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        from . import arithmetics

        return arithmetics.mod(other, self)

    def __divmod__(self, other):
        from . import arithmetics

        return (arithmetics.floordiv(self, other), arithmetics.mod(self, other))

    def __rdivmod__(self, other):
        from . import arithmetics

        return (arithmetics.floordiv(other, self), arithmetics.mod(other, self))

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __pos__(self):
        from . import arithmetics

        return arithmetics.pos(self)

    def __abs__(self):
        from . import rounding

        return rounding.abs(self)

    def __invert__(self):
        from . import arithmetics

        return arithmetics.invert(self)

    def __and__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(self, other)

    def __rand__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(other, self)

    def __or__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(self, other)

    def __ror__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(other, self)

    def __xor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(self, other)

    def __rxor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(other, self)

    def __lshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(self, other)

    def __rlshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(other, self)

    def __rshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(self, other)

    def __rrshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(other, self)

    @staticmethod
    def _is_operand(other) -> bool:
        """True for what the binary-op engine takes
        (``_operations.OPERAND_TYPES``). Anything else makes a comparison
        return ``NotImplemented``, so Python falls back to identity: a
        DNDarray in a tuple of strings compares unequal instead of raising
        (heat_tpu ``dndarray.py:843``)."""
        from . import _operations

        return isinstance(other, _operations.OPERAND_TYPES)

    def __eq__(self, other):
        from . import relational

        return relational.eq(self, other) if self._is_operand(other) else NotImplemented

    def __ne__(self, other):
        from . import relational

        return relational.ne(self, other) if self._is_operand(other) else NotImplemented

    def __lt__(self, other):
        from . import relational

        return relational.lt(self, other) if self._is_operand(other) else NotImplemented

    def __le__(self, other):
        from . import relational

        return relational.le(self, other) if self._is_operand(other) else NotImplemented

    def __gt__(self, other):
        from . import relational

        return relational.gt(self, other) if self._is_operand(other) else NotImplemented

    def __ge__(self, other):
        from . import relational

        return relational.ge(self, other) if self._is_operand(other) else NotImplemented

    __hash__ = None

    # ------------------------------------------------------------------ #
    # methods over the flat namespace (heat_tpu ``dndarray.py:897-1090``) #
    # ------------------------------------------------------------------ #
    def sum(self, axis=None, out=None, keepdims=False):
        from . import arithmetics

        return arithmetics.sum(self, axis=axis, out=out, keepdims=keepdims)

    def prod(self, axis=None, out=None, keepdims=False):
        from . import arithmetics

        return arithmetics.prod(self, axis=axis, out=out, keepdims=keepdims)

    def cumsum(self, axis=0):
        from . import arithmetics

        return arithmetics.cumsum(self, axis)

    def cumprod(self, axis=0):
        from . import arithmetics

        return arithmetics.cumprod(self, axis)

    def mean(self, axis=None):
        from . import statistics

        return statistics.mean(self, axis)

    def var(self, axis=None, ddof=0):
        from . import statistics

        return statistics.var(self, axis, ddof=ddof)

    def std(self, axis=None, ddof=0):
        from . import statistics

        return statistics.std(self, axis, ddof=ddof)

    def min(self, axis=None, out=None, keepdims=False):
        from . import statistics

        return statistics.min(self, axis=axis, out=out, keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=False):
        from . import statistics

        return statistics.max(self, axis=axis, out=out, keepdims=keepdims)

    def argmin(self, axis=None, out=None):
        from . import statistics

        return statistics.argmin(self, axis=axis, out=out)

    def argmax(self, axis=None, out=None):
        from . import statistics

        return statistics.argmax(self, axis=axis, out=out)

    def all(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.all(self, axis=axis, out=out, keepdims=keepdims)

    def any(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.any(self, axis=axis, out=out, keepdims=keepdims)

    def abs(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out, dtype)

    def exp(self, out=None):
        from . import exponential

        return exponential.exp(self, out)

    def log(self, out=None):
        from . import exponential

        return exponential.log(self, out)

    def sqrt(self, out=None):
        from . import exponential

        return exponential.sqrt(self, out)

    def sin(self, out=None):
        from . import trigonometrics

        return trigonometrics.sin(self, out)

    def cos(self, out=None):
        from . import trigonometrics

        return trigonometrics.cos(self, out)

    def clip(self, a_min, a_max, out=None):
        from . import rounding

        return rounding.clip(self, a_min, a_max, out)

    def allclose(self, other, rtol: float = 1e-05, atol: float = 1e-08,
                 equal_nan: bool = False) -> bool:
        from . import logical

        return logical.allclose(self, other, rtol=rtol, atol=atol, equal_nan=equal_nan)

    def isclose(self, other, rtol: float = 1e-05, atol: float = 1e-08,
                equal_nan: bool = False):
        from . import logical

        return logical.isclose(self, other, rtol=rtol, atol=atol, equal_nan=equal_nan)


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


def _normalize_basic_key(key, gshape) -> tuple:
    """A key of ints, slices and at most one ``...`` as one int or slice per
    axis, the ints non-negative and in bounds."""
    ndim = len(gshape)
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
    out = []
    for k, n in zip(key, gshape):
        if isinstance(k, (int, np.integer)):
            if not -n <= k < n:
                raise IndexError(f"index {int(k)} is out of bounds for axis with size {n}")
            k = int(k) % n
        out.append(k)
    return tuple(out)


def _torch_key(key: tuple, shape) -> Tuple[tuple, list]:
    """A normalized key as torch takes it: every slice with a positive step
    (torch has no negative steps), and the axes of the keyed result to flip
    where a negative step was replaced."""
    out, flips, dim = [], [], 0
    for k, n in zip(key, shape):
        if isinstance(k, int):
            out.append(k)
            continue
        start, stop, step = k.indices(n)
        if step < 0:
            count = len(range(start, stop, step))
            last = start + step * (count - 1) if count else 0
            out.append(slice(last, last + (-step) * count, -step) if count else slice(0, 0))
            flips.append(dim)
        else:
            out.append(slice(start, stop, step))
        dim += 1
    return tuple(out), flips


def _apply_basic(tensor: torch.Tensor, key: tuple) -> torch.Tensor:
    tkey, flips = _torch_key(key, tensor.shape)
    sub = tensor[tkey]
    return sub.flip(flips) if flips else sub
