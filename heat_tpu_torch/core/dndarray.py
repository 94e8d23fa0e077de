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
split is ONE all-to-all. Indexing takes every NumPy key and follows
heat_tpu's dispatch: integer arrays and boolean masks along the split axis
run the ring programs of :mod:`._indexing`, split-axis slices one window
fetch of :mod:`._manips`, keys that keep the split axis whole the shard
alone, and only the remaining forms gather the logical array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, sanitize_comm
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class LocalIndex:
    """``lloc``: indexing of this rank's shard (heat_tpu ``dndarray.py:65``;
    the original Heat's local indexing). A write replaces the owner's shard
    with a written copy, since a shard may be shared with another array."""

    def __init__(self, owner: "DNDarray"):
        self._owner = owner

    @property
    def obj(self) -> torch.Tensor:
        return self._owner.larray

    def __getitem__(self, key):
        return self._owner.larray[key]

    def __setitem__(self, key, value):
        t = self._owner.larray.clone()
        t[key] = value
        self._owner.larray = t


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
        if self.__array is None:
            raise RuntimeError("this DNDarray was donated to a step program "
                               "(trace_step donate_argnums) and can no longer be read")
        return self.__array

    def is_deleted(self) -> bool:
        """Whether a step program took this array by donation
        (``fusion.trace_step(..., donate_argnums=...)``), after which any read
        raises (heat_tpu's donated buffers)."""
        return self.__array is None

    def _donate(self) -> None:
        self.__array = None

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

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        """:attr:`lshape_map` (heat_tpu ``dndarray.py:395``)."""
        return self.lshape_map

    @property
    def balanced(self) -> bool:
        """Always True: the canonical layout (heat_tpu ``dndarray.py:317``)."""
        return True

    @property
    def pad(self) -> int:
        """Rows the canonical layout pads the split axis with to a multiple
        of the world size (heat_tpu ``dndarray.py:203``, its physical
        padding); the port's shards store none of them."""
        if self.__split is None:
            return 0
        n = self.__gshape[self.__split]
        return self.__comm.padded_size(n) - n

    @property
    def itemsize(self) -> int:
        return self.__dtype.torch_type().itemsize

    @property
    def gnumel(self) -> int:
        return self.size

    @property
    def gnbytes(self) -> int:
        return self.size * self.itemsize

    @property
    def nbytes(self) -> int:
        return self.size * self.itemsize

    @property
    def lnumel(self) -> int:
        """Elements in this rank's shard (heat_tpu ``dndarray.py:1263``)."""
        return int(np.prod(self.lshape)) if self.lshape else 1

    @property
    def lnbytes(self) -> int:
        return self.lnumel * self.itemsize

    def stride(self) -> Tuple[int, ...]:
        """Row-major element strides of this rank's shard (heat_tpu
        ``dndarray.py:1267``)."""
        st, acc = [], 1
        for s in reversed(self.lshape):
            st.append(acc)
            acc *= max(s, 1)
        return tuple(reversed(st))

    @property
    def strides(self) -> Tuple[int, ...]:
        """NumPy byte strides of this rank's shard (heat_tpu ``:1278``)."""
        return tuple(s * self.itemsize for s in self.stride())

    @property
    def lloc(self) -> LocalIndex:
        return LocalIndex(self)

    def filled(self, fill_value) -> torch.Tensor:
        """heat_tpu ``dndarray.py:251`` returns its physical array with the
        padding set to ``fill_value``; the port's shard has no padding, so
        this is the shard itself."""
        return self.__array

    def valid_mask(self) -> torch.Tensor:
        """True on every element of the shard (heat_tpu ``dndarray.py:279``:
        the logical, not the padding, positions)."""
        return torch.ones(self.__array.shape, dtype=torch.bool, device=self.__array.device)

    def cpu(self) -> "DNDarray":
        """heat_tpu ``dndarray.py:1257``: the array itself."""
        return self

    def fill_diagonal(self, value) -> "DNDarray":
        """Set the main diagonal of the first two axes to ``value``, in place
        (heat_tpu ``dndarray.py:1297``): each rank writes the diagonal
        positions its shard holds, no communication."""
        if self.ndim < 2:
            raise ValueError("fill_diagonal requires at least a 2-D array")
        n = min(self.__gshape[:2])
        local = self.__array.clone()
        idx = torch.arange(n, device=local.device)
        rows, cols = idx, idx
        if self.__split in (0, 1):
            offset, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
            if self.__split == 0:
                rows = idx - offset
            else:
                cols = idx - offset
            keep = (rows >= 0) & (rows < lshape[0]) & (cols >= 0) & (cols < lshape[1])
            rows, cols = rows[keep], cols[keep]
        local[rows, cols] = torch.as_tensor(value, dtype=local.dtype, device=local.device)
        self.__array = local
        return self

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

    def is_balanced(self, force_check: bool = False) -> bool:
        """Always True: the canonical layout is balanced (heat_tpu
        ``dndarray.py:423``)."""
        return True

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.size > 1

    def balance_(self) -> None:
        """No-op: the canonical layout is always balanced (heat_tpu
        ``dndarray.py:426``)."""
        return None

    def balance(self) -> "DNDarray":
        """Out-of-place balance (heat_tpu ``dndarray.py:1235``): a copy."""
        from . import memory

        return memory.copy(self)

    def redistribute_(self, lshape_map=None, target_map=None) -> None:
        """heat_tpu ``dndarray.py:505``: the canonical map is accepted as a
        no-op; any other target map raises ``NotImplementedError``, as
        heat_tpu does (its layout is the canonical one)."""
        if target_map is None:
            return None
        if np.array_equal(np.asarray(target_map), self.lshape_map):
            return None
        raise NotImplementedError(
            "heat_tpu_torch uses the canonical ceil-chunk layout; arbitrary "
            "redistribution maps are not supported")

    def redistribute(self, lshape_map=None, target_map=None) -> "DNDarray":
        """Out-of-place redistribute (heat_tpu ``dndarray.py:1242``)."""
        from . import manipulations

        return manipulations.redistribute(self, lshape_map=lshape_map, target_map=target_map)

    # ------------------------------------------------------------------ #
    # halo exchange (heat_tpu ``dndarray.py:523-594``)                   #
    # ------------------------------------------------------------------ #
    def _halo_exchange(self, halo_size: int):
        """The neighbours' edges ``(from_prev, from_next)`` of this rank's
        shard: the last ``halo_size`` rows along the split axis of rank-1's
        ceil-chunk and the first ``halo_size`` of rank+1's, zeros on the
        outer ranks and where a neighbour's chunk is short, as in heat_tpu's
        zero-padded blocks. Two :meth:`~TorchCommunication.Permute` rounds,
        one each way. None when nothing is exchanged (replicated,
        ``halo_size == 0`` or world size 1)."""
        if not isinstance(halo_size, int) or halo_size < 0:
            raise TypeError("halo_size must be a non-negative integer")
        comm = self.__comm
        if self.__split is None or halo_size == 0 or comm.size == 1:
            return None
        k = self.__split
        p = comm.size
        chunk = comm.chunk_size(self.__gshape[k])
        if halo_size > chunk:
            raise ValueError(f"halo_size {halo_size} exceeds chunk size {chunk}")
        x = self.__array
        lc = x.shape[k]
        if lc < chunk:  # the ceil-chunk heat_tpu pads with zeros
            pad = list(x.shape)
            pad[k] = chunk - lc
            x = torch.cat([x, x.new_zeros(pad)], dim=k)
        edge = list(x.shape)
        edge[k] = halo_size
        lo = x.narrow(k, 0, halo_size)
        hi = x.narrow(k, chunk - halo_size, halo_size)
        from_prev = comm.Permute(hi, [(i, i + 1) for i in range(p - 1)], edge)
        from_next = comm.Permute(lo, [(i + 1, i) for i in range(p - 1)], edge)
        return (x.new_zeros(edge) if from_prev is None else from_prev,
                x.new_zeros(edge) if from_next is None else from_next)

    def array_with_halos(self, halo_size: int) -> torch.Tensor:
        """This rank's shard extended by its neighbours' edges along the
        split axis, ``[from_prev; shard; from_next]`` (heat_tpu
        ``dndarray.py:559``, whose shards carry their padding; the port's
        do not). The shard itself when nothing is exchanged."""
        parts = self._halo_exchange(halo_size)
        if parts is None:
            return self.__array
        return torch.cat([parts[0], self.__array, parts[1]], dim=self.__split)

    def get_halo(self, halo_size: int) -> None:
        """Compute and keep the neighbours' edges as ``halo_prev`` (from
        rank-1) and ``halo_next`` (from rank+1), this rank's tensors of
        ``halo_size`` rows along the split axis, zeros on the outer ranks
        (heat_tpu ``dndarray.py:579``); both None when nothing is
        exchanged."""
        parts = self._halo_exchange(halo_size)
        self.halo_prev, self.halo_next = (None, None) if parts is None else parts
        return None

    # ------------------------------------------------------------------ #
    # files (heat_tpu ``dndarray.py:1282-1295``)                         #
    # ------------------------------------------------------------------ #
    def save(self, path: str, *args, **kwargs) -> None:
        from . import io

        return io.save(self, path, *args, **kwargs)

    def save_hdf5(self, path: str, dataset: str = "data", **kwargs) -> None:
        from . import io

        return io.save_hdf5(self, path, dataset, **kwargs)

    def save_netcdf(self, path: str, variable: str = "data", **kwargs) -> None:
        from . import io

        return io.save_netcdf(self, path, variable, **kwargs)

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

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """``np.asarray(x)``: :meth:`numpy`, cast to ``dtype`` when asked
        (heat_tpu ``dndarray.py:635``)."""
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

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
        """Indexing with NumPy semantics (heat_tpu ``dndarray.py:678``),
        through heat_tpu's key dispatch (``_getitem_impl``, ``:1900``); see
        :func:`_getitem_impl`."""
        return _getitem_impl(self, key)

    def __setitem__(self, key, value):
        """Assignment with NumPy semantics (heat_tpu ``dndarray.py:683``),
        through heat_tpu's setitem routes; see :func:`_setitem_impl`. The
        shard is replaced, never written in place: it may be shared with
        another DNDarray (a resplit, ``.T``, a reshape at world size 1),
        and heat_tpu's ``.at[].set`` makes a new array."""
        _setitem_impl(self, key, value)

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

    def __matmul__(self, other):
        from .linalg import matmul

        return matmul(self, other)

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

    def average(self, axis=None, weights=None, returned: bool = False):
        from . import statistics

        return statistics.average(self, axis=axis, weights=weights, returned=returned)

    def kurtosis(self, axis=None, unbiased: bool = True, Fischer: bool = True):
        from . import statistics

        return statistics.kurtosis(self, axis=axis, unbiased=unbiased, Fischer=Fischer)

    def skew(self, axis=None, unbiased: bool = True):
        from . import statistics

        return statistics.skew(self, axis=axis, unbiased=unbiased)

    def median(self, axis=None, keepdim: bool = False, keepdims=None):
        from . import statistics

        return statistics.median(self, axis=axis,
                                 keepdims=keepdim if keepdims is None else keepdims)

    def unique(self, sorted=True, return_inverse=False, axis=None, return_counts=False):
        from . import manipulations

        return manipulations.unique(self, sorted=sorted, return_inverse=return_inverse,
                                    axis=axis, return_counts=return_counts)

    # -- linear algebra (heat_tpu ``dndarray.py:1169-1191``) --
    def norm(self):
        from .linalg import norm as _norm

        return _norm(self)

    def qr(self, tiles_per_proc: int = 1, calc_q: bool = True, overwrite_a: bool = False):
        from .linalg import qr as _qr

        return _qr(self, tiles_per_proc=tiles_per_proc, calc_q=calc_q, overwrite_a=overwrite_a)

    def trace(self, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None):
        from .linalg import trace as _trace

        return _trace(self, offset=offset, axis1=axis1, axis2=axis2, dtype=dtype, out=out)

    def tril(self, k: int = 0):
        from .linalg import tril as _tril

        return _tril(self, k)

    def triu(self, k: int = 0):
        from .linalg import triu as _triu

        return _triu(self, k)

    # -- elementwise methods (heat_tpu ``dndarray.py:1053-1230``) --
    def absolute(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out, dtype)

    def ceil(self, out=None):
        from . import rounding

        return rounding.ceil(self, out)

    def floor(self, out=None):
        from . import rounding

        return rounding.floor(self, out)

    def trunc(self, out=None):
        from . import rounding

        return rounding.trunc(self, out)

    def round(self, decimals: int = 0, out=None, dtype=None):
        from . import rounding

        return rounding.round(self, decimals, out, dtype)

    def fabs(self, out=None):
        from . import rounding

        return rounding.fabs(self, out)

    def modf(self, out=None):
        from . import rounding

        return rounding.modf(self, out)

    def sign(self, out=None):
        from . import rounding

        return rounding.sign(self, out)

    def sgn(self, out=None):
        from . import rounding

        return rounding.sgn(self, out)

    def acos(self, out=None):
        from . import trigonometrics

        return trigonometrics.arccos(self, out)

    def asin(self, out=None):
        from . import trigonometrics

        return trigonometrics.arcsin(self, out)

    def atan(self, out=None):
        from . import trigonometrics

        return trigonometrics.arctan(self, out)

    def atan2(self, x2):
        from . import trigonometrics

        return trigonometrics.arctan2(self, x2)

    def tan(self, out=None):
        from . import trigonometrics

        return trigonometrics.tan(self, out)

    def sinh(self, out=None):
        from . import trigonometrics

        return trigonometrics.sinh(self, out)

    def cosh(self, out=None):
        from . import trigonometrics

        return trigonometrics.cosh(self, out)

    def tanh(self, out=None):
        from . import trigonometrics

        return trigonometrics.tanh(self, out)

    def exp2(self, out=None):
        from . import exponential

        return exponential.exp2(self, out)

    def expm1(self, out=None):
        from . import exponential

        return exponential.expm1(self, out)

    def log2(self, out=None):
        from . import exponential

        return exponential.log2(self, out)

    def log10(self, out=None):
        from . import exponential

        return exponential.log10(self, out)

    def log1p(self, out=None):
        from . import exponential

        return exponential.log1p(self, out)

    def square(self, out=None):
        from . import exponential

        return exponential.square(self, out)

    def conj(self, out=None):
        from . import complex_math

        return complex_math.conjugate(self, out)

    # ------------------------------------------------------------------ #
    # methods over manipulations and indexing (heat_tpu ``dndarray.py``)  #
    # ------------------------------------------------------------------ #
    def copy(self) -> "DNDarray":
        from . import memory

        return memory.copy(self)

    def reshape(self, *shape, new_split=None) -> "DNDarray":
        from . import manipulations

        return manipulations.reshape(self, *shape, new_split=new_split)

    def flatten(self) -> "DNDarray":
        from . import manipulations

        return manipulations.flatten(self)

    def ravel(self) -> "DNDarray":
        from . import manipulations

        return manipulations.ravel(self)

    def squeeze(self, axis=None) -> "DNDarray":
        from . import manipulations

        return manipulations.squeeze(self, axis)

    def expand_dims(self, axis) -> "DNDarray":
        from . import manipulations

        return manipulations.expand_dims(self, axis)

    def transpose(self, axes=None) -> "DNDarray":
        from . import manipulations

        return manipulations._transpose(self, axes)

    def swapaxes(self, axis1, axis2) -> "DNDarray":
        from . import manipulations

        return manipulations.swapaxes(self, axis1, axis2)

    def flip(self, axis=None) -> "DNDarray":
        from . import manipulations

        return manipulations.flip(self, axis)

    def rot90(self, k: int = 1, axes=(0, 1)) -> "DNDarray":
        from . import manipulations

        return manipulations.rot90(self, k, axes)

    def nonzero(self) -> "DNDarray":
        from . import indexing

        return indexing.nonzero(self)


# ---------------------------------------------------------------------- #
# indexing: heat_tpu's key dispatch (``dndarray.py:1328-2161``)           #
# ---------------------------------------------------------------------- #
def _as_key(k):
    """One key element as the dispatch takes it: numpy integers and bools
    as python ones, tensors and lists as numpy arrays (an empty list as an
    integer array); DNDarrays, arrays, slices, ``None`` and ``...`` as
    they are."""
    if isinstance(k, torch.Tensor):
        return k.detach().cpu().numpy()
    if isinstance(k, list):
        a = np.asarray(k)
        return a.astype(np.intp) if a.size == 0 else a
    if isinstance(k, np.bool_):
        return bool(k)
    if isinstance(k, np.integer):
        return int(k)
    if isinstance(k, np.ndarray) and k.ndim == 0 and k.dtype != np.bool_:
        return int(k)
    return k


def _key_list(key) -> list:
    return [_as_key(k) for k in (key if isinstance(key, tuple) else (key,))]


def _is_int(k) -> bool:
    return isinstance(k, int) and not isinstance(k, bool)


def _is_array(k) -> bool:
    return isinstance(k, (DNDarray, np.ndarray))


def _is_bool_array(k) -> bool:
    return _is_array(k) and (k.dtype is types.bool if isinstance(k, DNDarray)
                             else k.dtype == np.bool_)


def _is_int_array(k) -> bool:
    if isinstance(k, DNDarray):
        return types.heat_type_is_exact(k.dtype) and k.dtype is not types.bool
    return isinstance(k, np.ndarray) and np.issubdtype(k.dtype, np.integer)


def _index_axis_span(k) -> int:
    """How many array axes one key element consumes (NumPy's arity rules):
    a boolean mask its ``ndim``, ``None`` and a python bool none, anything
    else one."""
    if k is None or isinstance(k, bool):
        return 0
    if _is_bool_array(k):
        return k.ndim
    return 1


def _expand_ellipsis(keys: list, ndim: int):
    """Replace a single ``...`` by the full slices it stands for; None when
    a second one makes the key invalid."""
    if any(k is Ellipsis for k in keys):
        i = next(j for j, k in enumerate(keys) if k is Ellipsis)
        n_explicit = sum(_index_axis_span(k) for k in keys if k is not Ellipsis)
        keys[i:i + 1] = [slice(None)] * (ndim - n_explicit)
        if any(k is Ellipsis for k in keys):
            return None
    return keys


def _padded_keys(x: "DNDarray", keys: list):
    """The key expanded to one element per axis (``...`` replaced, trailing
    full slices added), or None where it does not fit that form."""
    keys = list(keys)
    if _expand_ellipsis(keys, x.ndim) is None:
        return None
    keys += [slice(None)] * (x.ndim - sum(_index_axis_span(k) for k in keys))
    return keys if len(keys) == x.ndim else None


def _slice_len(sl: slice, n: int) -> int:
    return len(range(*sl.indices(n)))


def _full_span(k, n: int) -> bool:
    return isinstance(k, slice) and k.indices(n) == (0, n, 1)


def _distributed(x: "DNDarray") -> bool:
    return x.split is not None and x.comm.size > 1 and x.ndim > 0


def _match_split_axis_array_key(x: "DNDarray", keys: list):
    """A key whose one non-trivial element is a 1-D integer array or 1-D
    boolean mask at the split axis, every other element a full slice
    (heat_tpu ``dndarray.py:1472``): ``("int"|"bool", array)`` or None."""
    if not _distributed(x) or any(k is None for k in keys):
        return None
    keys = _padded_keys(x, keys)
    if keys is None:
        return None
    hit = None
    for axis, k in enumerate(keys):
        if _is_array(k):
            if k.ndim != 1 or axis != x.split or hit is not None:
                return None
            if _is_bool_array(k):
                if k.shape[0] != x.gshape[x.split]:
                    return None
                hit = ("bool", k)
            elif _is_int_array(k):
                hit = ("int", k)
            else:
                return None
        elif not (isinstance(k, slice) and k == slice(None)):
            return None
    return hit


def _match_mixed_key(x: "DNDarray", keys: list):
    """Exactly one 1-D integer array or boolean mask with basic ints and
    slices, the non-slice elements at consecutive axes (heat_tpu
    ``dndarray.py:1515``): ``(keys, arr_pos, kind, arr)`` or None."""
    if not _distributed(x) or any(k is None or isinstance(k, bool) for k in keys):
        return None
    keys = _padded_keys(x, keys)
    if keys is None:
        return None
    arr_pos = kind = arr = None
    for axis, k in enumerate(keys):
        if _is_array(k):
            if k.ndim != 1 or arr_pos is not None:
                return None
            if _is_bool_array(k):
                if k.shape[0] != x.gshape[axis]:
                    return None
                kind = "bool"
            elif _is_int_array(k):
                kind = "int"
            else:
                return None
            arr_pos, arr = axis, k
        elif isinstance(k, slice):
            continue
        elif _is_int(k):
            n = x.gshape[axis]
            kk = k + n if k < 0 else k
            if not 0 <= kk < n:
                raise IndexError(f"index {k} is out of bounds for axis {axis} with size {n}")
            keys[axis] = kk
        else:
            return None
    if arr_pos is None:
        return None
    adv = [i for i, k in enumerate(keys) if not isinstance(k, slice)]
    if any(b - a != 1 for a, b in zip(adv, adv[1:])):
        return None  # separated advanced indices: NumPy moves their dims first
    return keys, arr_pos, kind, arr


def _empty_rows(x: "DNDarray", axis: int) -> "DNDarray":
    gshape = tuple(0 if i == axis else s for i, s in enumerate(x.gshape))
    return DNDarray.from_global(x.larray.new_zeros(gshape), None, x.device, x.comm, x.dtype)


def _index_chunk(x: "DNDarray", arr):
    """``(idx, m, check)``: this rank's chunk (split 0 over ``m``) of the
    global positions ``arr`` along the split axis, negatives normalized.
    An index given on the host is bounds-checked on every rank; a split
    DNDarray index is left for the ring program to check (``check``), which
    every rank's chunk passes through."""
    comm, n, dev = x.comm, x.gshape[x.split], x.larray.device
    if isinstance(arr, DNDarray) and arr.split == 0:
        idx = arr.larray.to(device=dev, dtype=torch.int64)
        return torch.where(idx < 0, idx + n, idx), arr.gshape[0], True
    if isinstance(arr, DNDarray):
        arr = arr.larray.cpu().numpy()
    idx = np.asarray(arr, dtype=np.int64).reshape(-1)
    m = idx.shape[0]
    idx = np.where(idx < 0, idx + n, idx)
    if m and ((idx < 0).any() or (idx >= n).any()):
        raise IndexError(f"index out of bounds for axis {x.split} with size {n}")
    _, _, (sl,) = comm.chunk((m,), 0)
    return torch.as_tensor(idx[sl], device=dev), m, False


def _mask_chunk(x: "DNDarray", arr) -> torch.Tensor:
    """This rank's chunk of a boolean mask along the split axis."""
    n, dev = x.gshape[x.split], x.larray.device
    if isinstance(arr, DNDarray):
        if arr.split == 0:
            return arr.larray.to(device=dev, dtype=torch.bool)
        arr = arr.larray
    else:
        arr = torch.as_tensor(np.asarray(arr, dtype=bool))
    _, _, (sl,) = x.comm.chunk((n,), 0)
    return arr[sl].to(device=dev, dtype=torch.bool)


def _mask_to_indices(arr) -> np.ndarray:
    """A boolean mask's kept positions on the host (a split DNDarray mask is
    gathered, counted)."""
    if isinstance(arr, DNDarray):
        arr = arr.numpy()
    return np.nonzero(np.asarray(arr, bool))[0]


def _getitem_split_axis_advanced(x: "DNDarray", kind, arr) -> "DNDarray":
    """``x[idx]``/``x[mask]`` along the split axis through the ring
    programs (heat_tpu ``dndarray.py:1869``): ``x[idx]`` is p - 1 ring
    steps; ``x[mask]`` one exclusive scan, one all-reduce of the count and
    p - 1 ring steps."""
    from . import _indexing

    comm, axis = x.comm, x.split
    n = x.gshape[axis]
    if kind == "int":
        idx, m, check = _index_chunk(x, arr)
        if m == 0:
            return _empty_rows(x, axis)
        rows = _indexing.ring_gather(x.larray, axis, n, idx, comm, check)
    else:
        pos, m = _indexing.mask_positions(_mask_chunk(x, arr), comm)
        if m == 0:
            return _empty_rows(x, axis)
        rows = _indexing.ring_compress(x.larray, axis, comm.chunk_size(n), pos, m, comm)
    gshape = tuple(m if i == axis else s for i, s in enumerate(x.gshape))
    return DNDarray(rows, gshape, x.dtype, axis, x.device, comm)


def _sub_meta(x: "DNDarray", keys: list, keep_axis: int):
    """``(gshape, new_split)`` of ``x`` keyed by ints and slices on every
    axis but ``keep_axis`` (kept whole)."""
    gshape, new_split = [], None
    for i, k in enumerate(keys):
        if i == keep_axis:
            if i == x.split:
                new_split = len(gshape)
            gshape.append(x.gshape[i])
        elif isinstance(k, slice):
            if i == x.split:
                new_split = len(gshape)
            gshape.append(_slice_len(k, x.gshape[i]))
    return tuple(gshape), new_split


def _getitem_mixed(x: "DNDarray", keys, arr_pos, kind, arr):
    """A mixed key without the logical array (heat_tpu
    ``dndarray.py:1653``): the array at the split axis runs the ring
    programs after the basic elements apply to the shard; an array on
    another axis, with the split axis whole, applies to the shard."""
    split = x.split
    if arr_pos == split:
        pre = [slice(None) if i == split else k for i, k in enumerate(keys)]
        if all(isinstance(k, slice) and k == slice(None) for k in pre):
            sub = x
        else:
            gshape, new_split = _sub_meta(x, keys, split)
            sub = DNDarray(_torch_getitem(x.larray, pre), gshape, x.dtype, new_split,
                           x.device, x.comm)
        return _getitem_split_axis_advanced(sub, kind, arr)
    if not (isinstance(keys[split], slice) and keys[split] == slice(None)):
        return None
    n_axis = x.gshape[arr_pos]
    if kind == "bool":
        idx = _mask_to_indices(arr)
    else:
        if isinstance(arr, DNDarray):
            arr = arr.numpy()
        idx = np.asarray(arr, dtype=np.int64).reshape(-1)
        idx = np.where(idx < 0, idx + n_axis, idx)
        if idx.size and ((idx < 0).any() or (idx >= n_axis).any()):
            raise IndexError(f"index out of bounds for axis {arr_pos} with size {n_axis}")
    key2 = [idx if i == arr_pos else k for i, k in enumerate(keys)]
    sub = _torch_getitem(x.larray, key2)
    gshape, new_split = [], None
    for i, k in enumerate(keys):
        if i == arr_pos:
            gshape.append(idx.shape[0])
        elif isinstance(k, slice):
            if i == split:
                new_split = len(gshape)
                gshape.append(x.gshape[i])
            else:
                gshape.append(_slice_len(k, x.gshape[i]))
    return DNDarray(sub, tuple(gshape), x.dtype, new_split, x.device, x.comm)


def _getitem_paired_arrays(x: "DNDarray", keys: list):
    """Integer arrays paired over the leading axes, the split axis among
    them (heat_tpu ``dndarray.py:1579``): one flat index through
    ``ravel_multi_index``, the leading axes merged by the distributed
    reshape, then the one-array ring."""
    if not _distributed(x) or x.ndim < 2 or any(k is None or isinstance(k, bool)
                                                for k in keys):
        return None
    keys = _padded_keys(x, keys)
    if keys is None:
        return None

    def as_idx(k):
        if _is_int(k):
            return np.asarray(k)
        if isinstance(k, DNDarray):
            if not _is_int_array(k):
                return None
            k = k.numpy()
        if isinstance(k, np.ndarray):
            if k.ndim > 1 or not np.issubdtype(k.dtype, np.integer):
                return None
            return k.astype(np.int64)
        return None

    adv = [i for i, k in enumerate(keys) if not isinstance(k, slice)]
    if sum(1 for i in adv if not _is_int(keys[i])) < 2 or adv != list(range(len(adv))):
        return None
    g = len(adv)
    if not x.split < g:
        return None
    idxs = []
    for i in range(g):
        a = as_idx(keys[i])
        if a is None:
            return None
        n_i = x.gshape[i]
        a = np.where(a < 0, a + n_i, a)
        if a.size and ((a < 0).any() or (a >= n_i).any()):
            raise IndexError(f"index out of bounds for axis {i} with size {n_i}")
        idxs.append(a)
    try:
        m = np.broadcast_shapes(*[a.shape for a in idxs])
    except ValueError:
        return None
    if len(m) != 1:
        return None
    combined = np.ravel_multi_index(tuple(np.broadcast_to(a, m) for a in idxs), x.gshape[:g])
    from . import manipulations

    flat_shape = (int(np.prod(x.gshape[:g], dtype=np.int64)),) + x.gshape[g:]
    xm = manipulations.reshape(x, flat_shape, new_split=0)
    return _getitem_impl(xm, (combined,) + tuple(keys[g:]))


def _parse_split_slice_key(x: "DNDarray", keys: list):
    """Basic keys whose split-axis element is a slice of less than the
    whole axis, or an int (heat_tpu ``dndarray.py:1715``): ``(keys, start,
    step, L, is_int)`` or None; an int out of range raises."""
    if not _distributed(x):
        return None
    for k in keys:
        if not (k is Ellipsis or isinstance(k, slice) or _is_int(k)):
            return None
    keys = _padded_keys(x, keys)
    if keys is None:
        return None
    ks, n = keys[x.split], x.gshape[x.split]
    if isinstance(ks, slice):
        start, stop, step = ks.indices(n)
        if start == 0 and step == 1 and stop >= n:
            return None  # the whole axis: the shard-local path
        return keys, start, step, _slice_len(ks, n), False
    kk = ks + n if ks < 0 else ks
    if not 0 <= kk < n:
        raise IndexError(f"index {ks} is out of bounds for axis {x.split} with size {n}")
    return keys, kk, 1, 1, True


def _getitem_split_slice(x: "DNDarray", keys: list):
    """A split-axis slice as ONE scheduled window fetch (heat_tpu
    ``dndarray.py:1748``: ``start + go*step`` is affine); the other axes
    apply to the shard. An int on the split axis takes its row from the
    rank that owns it: one all-gather (heat_tpu fetches the row to rank 0,
    then gathers the logical array)."""
    parsed = _parse_split_slice_key(x, keys)
    if parsed is None:
        return None
    keys, start, step, length, is_int = parsed
    n = x.gshape[x.split]
    pre = []
    for i, k in enumerate(keys):
        if i == x.split:
            pre.append(slice(None))
        elif _is_int(k):
            ni = x.gshape[i]
            kk = k + ni if k < 0 else k
            if not 0 <= kk < ni:
                raise IndexError(f"index {k} is out of bounds for axis {i} with size {ni}")
            pre.append(kk)
        else:
            pre.append(k)
    sub = _torch_getitem(x.larray, pre)
    gshape1, new_split = _sub_meta(x, pre, x.split)
    comm = x.comm
    if is_int:
        offset, lshape, _ = comm.chunk(x.gshape, x.split)
        mine = offset <= start < offset + lshape[x.split]
        row = sub.narrow(new_split, start - offset if mine else 0, 1 if mine else 0)
        counts = [0] * comm.size
        counts[start // comm.chunk_size(n)] = 1
        row = comm.Allgather(row, new_split, counts).squeeze(new_split)
        return DNDarray(row, tuple(row.shape), x.dtype, None, x.device, comm)
    gshape = tuple(length if i == new_split else s for i, s in enumerate(gshape1))
    if length == 0:
        return DNDarray.from_global(sub.new_zeros(gshape), new_split, x.device, comm, x.dtype)
    from . import _manips

    out = _manips.ring_slice(sub, new_split, n, start, step, length, comm)
    return DNDarray(out, gshape, x.dtype, new_split, x.device, comm)


def _result_split_basic(x: "DNDarray", keys: list):
    """The split of ``x`` keyed by basic elements that keep its split axis
    (heat_tpu ``dndarray.py:1444``), None where an int takes it."""
    if x.split is None:
        return None
    keys = list(keys)
    if any(k is Ellipsis for k in keys):
        i = next(j for j, k in enumerate(keys) if k is Ellipsis)
        n_explicit = sum(1 for k in keys if k is not Ellipsis and k is not None)
        keys[i:i + 1] = [slice(None)] * (x.ndim - n_explicit)
    out_pos = dim = 0
    for k in keys:
        if k is None:
            out_pos += 1
            continue
        if dim == x.split:
            return out_pos if isinstance(k, slice) else None
        if isinstance(k, slice):
            out_pos += 1
        dim += 1
    if dim <= x.split:
        return out_pos + (x.split - dim)
    return None


def _is_basic(keys: list) -> bool:
    return all(k is None or k is Ellipsis or isinstance(k, slice) or _is_int(k) for k in keys)


def _split_kept(x: "DNDarray", keys: list) -> bool:
    """True for basic keys that leave the split axis whole: they apply to
    the shard, with no communication (heat_tpu's fast path, which in the
    port also takes ``None`` and ``...``, as its shards carry no
    padding)."""
    if x.split is None or not _is_basic(keys):
        return False
    if sum(k is Ellipsis for k in keys) > 1:
        return False
    expanded = list(keys)
    _expand_ellipsis(expanded, x.ndim)
    dim = 0
    for k in expanded:
        if k is None:
            continue
        if dim == x.split:
            return _full_span(k, x.gshape[dim])
        dim += 1
    return True


def _kept_key(x: "DNDarray", keys: list) -> list:
    """A split-kept key with its split-axis element made ``slice(None)``
    (so that it applies to a shard of any length)."""
    expanded = list(keys)
    _expand_ellipsis(expanded, x.ndim)
    out, dim = [], 0
    for k in expanded:
        if k is not None:
            if dim == x.split:
                k = slice(None)
            dim += 1
        out.append(k)
    return out


def _getitem_impl(x: "DNDarray", key) -> "DNDarray":
    """heat_tpu's key dispatch (``_getitem_impl``, ``dndarray.py:1900``),
    in its order, for a split array on more than one rank:

    1. a 1-D integer array or mask at the split axis: the ring programs;
    2. a mixed key (one such array with ints and slices);
    3. integer arrays paired over the leading axes;
    4. a split-axis slice or int: one window fetch (an int: one all-gather);

    then, for every array, 5. basic keys that keep the split axis whole
    apply to the shard, and 6. any other key gathers the logical array
    once (one counted all-gather), applies, and re-chunks. Results take
    heat_tpu's split."""
    keys = _key_list(key)
    if _distributed(x):
        adv = _match_split_axis_array_key(x, keys)
        if adv is not None:
            return _getitem_split_axis_advanced(x, *adv)
        mixed = _match_mixed_key(x, keys)
        if mixed is not None:
            res = _getitem_mixed(x, *mixed)
            if res is not None:
                return res
        paired = _getitem_paired_arrays(x, keys)
        if paired is not None:
            return paired
        sliced = _getitem_split_slice(x, keys)
        if sliced is not None:
            return sliced
    _check_int_bounds(x, keys)
    if _split_kept(x, keys):
        sub = _torch_getitem(x.larray, _kept_key(x, keys))
        new_split = _result_split_basic(x, keys)
        gshape = list(sub.shape)
        gshape[new_split] = x.gshape[x.split]
        return DNDarray(sub, tuple(gshape), x.dtype, new_split, x.device, x.comm)
    sub = _torch_getitem(x._logical(), keys)
    new_split = None
    if x.split is not None and sub.ndim > 0:
        if _is_basic(keys):
            new_split = _result_split_basic(x, keys)
            if new_split is not None and new_split >= sub.ndim:
                new_split = None
        else:
            new_split = 0  # advanced keys: the result is split along its first axis
    if x.split is None or x.comm.size == 1:
        return DNDarray(sub, tuple(sub.shape), x.dtype, new_split, x.device, x.comm)
    return DNDarray.from_global(sub, new_split, x.device, x.comm, x.dtype)


def _check_int_bounds(x: "DNDarray", keys: list) -> None:
    """NumPy's IndexError for an int or an integer array out of range
    (a CUDA tensor indexed out of range would fault instead), and for too
    many indices."""
    n_addr = sum(_index_axis_span(k) for k in keys if k is not Ellipsis)
    if n_addr > x.ndim:
        raise IndexError(f"too many indices: array is {x.ndim}-dimensional, key addresses "
                         f"{n_addr}")
    if sum(k is Ellipsis for k in keys) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    pre, post, seen = [], [], False
    for k in keys:
        if k is Ellipsis:
            seen = True
        else:
            (post if seen else pre).append(k)

    def check(segment, axis):
        for k in segment:
            if axis < x.ndim and (_is_int(k) or _is_int_array(k)):
                n = x.gshape[axis]
                if _is_int(k):
                    lo = hi = k
                elif k.size and isinstance(k, DNDarray):
                    # reduced where it lives: one pair of scalars crosses to the host
                    lo, hi = torch.stack(torch.aminmax(k._logical().reshape(-1))).tolist()
                elif k.size:
                    lo, hi = int(k.min()), int(k.max())
                else:
                    lo = hi = 0
                if lo < -n or hi >= n:
                    raise IndexError(f"index {hi if hi >= n else lo} is out of bounds for "
                                     f"axis {axis} with size {n}")
            axis += _index_axis_span(k)

    check(pre, 0)
    check(post, x.ndim - sum(_index_axis_span(k) for k in post))


def _torch_key(t: torch.Tensor, keys: list):
    """A NumPy-semantics key as torch takes it, with the axes of ``t`` to
    flip first: torch has no negative slice steps, so a slice with one
    addresses the flipped axis with a positive step. Arrays become tensors
    on ``t``'s device (a DNDarray its logical tensor)."""
    keys = list(keys)
    if _expand_ellipsis(keys, t.ndim) is None:
        raise IndexError("an index can only have a single ellipsis ('...')")
    out, flips, dim = [], [], 0
    for k in keys:
        if isinstance(k, DNDarray):
            k = k._logical()
        elif isinstance(k, np.ndarray):
            k = torch.as_tensor(k)
        if isinstance(k, torch.Tensor):
            k = k.to(t.device)
            if k.dtype != torch.bool:
                k = k.to(torch.int64)
            out.append(k)
            dim += k.ndim if k.dtype == torch.bool else 1
            continue
        if isinstance(k, slice) and dim < t.ndim:
            n = t.shape[dim]
            start, stop, step = k.indices(n)
            if step < 0:
                count = len(range(start, stop, step))
                first = n - 1 - start
                k = slice(first, first - step * count, -step) if count else slice(0, 0)
                flips.append(dim)
        out.append(k)
        if k is not None and not isinstance(k, bool):
            dim += 1
    return tuple(out), flips


def _torch_getitem(t: torch.Tensor, keys) -> torch.Tensor:
    tkey, flips = _torch_key(t, list(keys))
    return (t.flip(flips) if flips else t)[tkey]


def _torch_setitem(t: torch.Tensor, keys, value) -> torch.Tensor:
    """``t`` with ``t[keys] = value`` (NumPy semantics), as a new tensor."""
    tkey, flips = _torch_key(t, list(keys))
    out = t.flip(flips) if flips else t.clone()
    out[tkey] = value
    return out.flip(flips) if flips else out


# ---------------------------------------------------------------------- #
# assignment: heat_tpu's setitem routes                                   #
# ---------------------------------------------------------------------- #
def _value_tensor(x: "DNDarray", value) -> torch.Tensor:
    """A value that every rank holds whole, as a tensor of ``x``'s type (a
    split DNDarray value is gathered, counted: it is only taken so where
    it does not span the split axis of the target)."""
    dtype, device = x.dtype.torch_type(), x.larray.device
    if isinstance(value, DNDarray):
        value = value.resplit(None).larray if value.split is not None else value.larray
    elif isinstance(value, (bool, int, float, complex)):
        try:
            # filled on the device: a host copy of a scalar would wait for the card
            return torch.full((), value, dtype=dtype, device=device)
        except (RuntimeError, TypeError):  # out of the type's range: cast as numpy does
            value = torch.as_tensor(value)
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    return value.to(device=device, dtype=dtype)


def _aligned_value(x: "DNDarray", value, target, axis: int):
    """This rank's chunk, along ``axis`` of the ``target`` shape it
    broadcasts to, of an assignment's value. A DNDarray value that spans
    that axis keeps its shards (moved there by one all-to-all if split
    elsewhere); no split value is gathered unless it broadcasts along the
    axis. None when the value does not broadcast to ``target``."""
    comm = x.comm
    lead = len(target) - (value.ndim if isinstance(value, DNDarray) else np.ndim(value))
    if isinstance(value, DNDarray) and value.split is not None and lead >= 0 and \
            axis - lead >= 0 and value.gshape[axis - lead] == target[axis]:
        vax = axis - lead
        if value.split != vax:
            value = value.resplit(vax)
        local = value.larray.to(dtype=x.dtype.torch_type(), device=x.larray.device)
        _, lshape, _ = comm.chunk(target, axis)
        try:
            return torch.broadcast_to(local, lshape)
        except RuntimeError:
            return None
    v = _value_tensor(x, value)
    try:
        v = torch.broadcast_to(v, tuple(target))
    except RuntimeError:
        return None
    _, _, slices = comm.chunk(target, axis)
    return v[slices]


def _setitem_split_axis_advanced(x: "DNDarray", kind, arr, value) -> bool:
    """``x[idx] = v`` / ``x[mask] = v`` along the split axis (heat_tpu
    ``dndarray.py:1956``): a mask with a value that does not vary along the
    axis is a local ``where``; integer positions rotate (index, value-row)
    pairs around the ring (p - 1 ring steps). False where the value's shape
    needs the general path."""
    from . import _indexing

    comm, axis = x.comm, x.split
    n = x.gshape[axis]
    if kind == "bool":
        val = _value_tensor(x, value)
        j = axis - (x.ndim - val.ndim)
        if val.ndim <= x.ndim and (j < 0 or val.shape[j] == 1):
            target_one = tuple(1 if i == axis else s for i, s in enumerate(x.gshape))
            try:
                np.broadcast_shapes(tuple(val.shape), target_one)
            except ValueError:
                return False
            sel = _mask_chunk(x, arr).reshape(tuple(-1 if i == axis else 1
                                                    for i in range(x.ndim)))
            x.larray = torch.where(sel, val, x.larray)
            return True
        return _setitem_split_axis_advanced(x, "int", _mask_to_indices(arr), value)
    idx, m, _ = _index_chunk(x, arr)
    if m == 0:
        return True
    target = tuple(m if i == axis else s for i, s in enumerate(x.gshape))
    rows = _aligned_value(x, value, target, axis)
    if rows is None:
        return False
    x.larray = _indexing.ring_scatter(x.larray, axis, n, idx, rows.movedim(axis, 0), m, comm)
    return True


def _check_value_shape(value, target) -> None:
    vshape = value.gshape if isinstance(value, DNDarray) else np.shape(value)
    try:
        np.broadcast_shapes(tuple(vshape), tuple(target))
    except ValueError:
        raise ValueError(f"could not broadcast value of shape {tuple(vshape)} to indexing "
                         f"result of shape {tuple(target)}") from None


def _setitem_mixed(x: "DNDarray", keys, arr_pos, kind, arr, value) -> bool:
    """``x[idx, 2:5] = v`` (heat_tpu ``dndarray.py:2042``): read, modify,
    write through the rings — gather the addressed rows, write the basic
    elements into them locally, scatter them back."""
    if arr_pos != x.split:
        return False
    if kind == "bool":
        arr, kind = _mask_to_indices(arr), "int"
    rows = _getitem_split_axis_advanced(x, kind, arr)
    if rows.ndim == 0 or rows.gshape[x.split] == 0:
        target = tuple(_slice_len(k, x.gshape[i]) if isinstance(k, slice)
                       else (0 if i == arr_pos else None) for i, k in enumerate(keys))
        _check_value_shape(value, tuple(t for t in target if t is not None))
        return True
    rows_key = tuple(slice(None) if i == arr_pos else k for i, k in enumerate(keys))
    _setitem_impl(rows, rows_key, value)
    if not _setitem_split_axis_advanced(x, "int", arr, rows):
        raise AssertionError("the scatter declined the rows it gathered")
    return True


def _setitem_split_slice(x: "DNDarray", keys: list, value) -> bool:
    """``x[a:b:c] = v`` and ``x[i] = v`` along the split axis (heat_tpu
    ``dndarray.py:2084``). A value that every rank holds whole (a scalar,
    host data, a replicated DNDarray) is written shard-locally: each rank
    writes the positions that fall in its rows. A split value goes as
    heat_tpu's: the positions are affine, so the write is the scatter ring;
    other-axis elements go read-modify-write through the window-fetch
    getitem first."""
    parsed = _parse_split_slice_key(x, keys)
    if parsed is None:
        return False
    keys, start, step, length, is_int = parsed
    ks = keys[x.split]
    if length == 0:
        target = tuple(0 if i == x.split else (_slice_len(k, x.gshape[i])
                                               if isinstance(k, slice) else None)
                       for i, k in enumerate(keys))
        _check_value_shape(value, tuple(t for t in target if t is not None))
        return True
    if not (isinstance(value, DNDarray) and value.split is not None):
        _setitem_slice_local(x, keys, start, step, length, value)
        return True
    idx = np.arange(length, dtype=np.int64) * step + start
    if any(not (isinstance(k, slice) and k == slice(None))
           for i, k in enumerate(keys) if i != x.split):
        gather_ks = ks if isinstance(ks, slice) else slice(start, start + 1)
        rows = _getitem_impl(x, tuple(gather_ks if i == x.split else slice(None)
                                      for i in range(x.ndim)))
        _setitem_impl(rows, tuple(slice(None) if i == x.split else k
                                  for i, k in enumerate(keys)), value)
        value = rows
    elif is_int:
        row_shape = tuple(s for i, s in enumerate(x.gshape) if i != x.split)
        try:
            value = torch.broadcast_to(_value_tensor(x, value), row_shape).unsqueeze(x.split)
        except RuntimeError:
            return False
    return _setitem_split_axis_advanced(x, "int", idx, value)


def _setitem_slice_local(x: "DNDarray", keys: list, start: int, step: int, length: int,
                         value) -> None:
    """``x[keys] = value`` for a split-axis slice (or int) of ``length``
    positions ``start + k*step`` and a value every rank holds: this rank
    writes positions ``k0 <= k < k1``, those in its rows, with the value's
    matching part. No communication."""
    split = x.split
    offset, lshape, _ = x.comm.chunk(x.gshape, split)
    rows = lshape[split]
    if step > 0:
        k0, k1 = -(-(offset - start) // step), -(-(offset + rows - start) // step)
    else:
        k0, k1 = (start - offset - rows) // -step + 1, (start - offset) // -step + 1
    k0, k1 = max(k0, 0), min(k1, length)
    target = tuple(_slice_len(k, x.gshape[i]) for i, k in enumerate(keys)
                   if isinstance(k, slice))
    _check_value_shape(value, target)
    v = _value_tensor(x, value)
    lead = max(v.ndim - len(target), 0)
    if any(d != 1 for d in v.shape[:lead]):
        raise ValueError(f"could not broadcast value of shape {tuple(v.shape)} to indexing "
                         f"result of shape {target}")
    if k0 >= k1:
        return
    v = torch.broadcast_to(v.reshape(v.shape[lead:]), target)
    first = start + k0 * step - offset
    if isinstance(keys[split], slice):
        last = start + (k1 - 1) * step - offset
        stop = last + (1 if step > 0 else -1)
        local_key = slice(first, None if stop < 0 else stop, step)
        rs = sum(1 for k in keys[:split] if isinstance(k, slice))
        v = v.narrow(rs, k0, k1 - k0)
    else:
        local_key = first
    x.larray = _torch_setitem(x.larray, keys[:split] + [local_key] + keys[split + 1:], v)


def _setitem_impl(x: "DNDarray", key, value) -> None:
    """heat_tpu's setitem routes (``_setitem_impl``, ``dndarray.py:2139``),
    in its order, for a split array on more than one rank: the split-axis
    array, the mixed key, the split-axis slice; then, for every array,
    basic keys that keep the split axis whole write into the shard (the
    value's own shards where it spans that axis), and any other key
    gathers the logical array once (counted), writes, and re-chunks."""
    keys = _key_list(key)
    if _distributed(x):
        adv = _match_split_axis_array_key(x, keys)
        if adv is not None and _setitem_split_axis_advanced(x, *adv, value):
            return
        mixed = _match_mixed_key(x, keys)
        if mixed is not None and _setitem_mixed(x, *mixed, value):
            return
        if _setitem_split_slice(x, keys, value):
            return
    _check_int_bounds(x, keys)
    if _split_kept(x, keys):
        kept = _kept_key(x, keys)
        rs = _result_split_basic(x, keys)
        region = _torch_getitem(x.larray, kept)
        target = list(region.shape)
        target[rs] = x.gshape[x.split]
        v = _aligned_value(x, value, tuple(target), rs)
        if v is None:
            raise ValueError(f"could not broadcast value to indexing result of shape "
                             f"{tuple(target)}")
        x.larray = _torch_setitem(x.larray, kept, v)
        return
    v = _value_tensor(x, value)
    if x.split is None or x.comm.size == 1:
        x.larray = _torch_setitem(x.larray, keys, v)
        return
    full = _torch_setitem(x._logical(), keys, v)
    _, _, slices = x.comm.chunk(x.gshape, x.split)
    x.larray = full[slices].clone()
