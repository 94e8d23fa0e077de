"""Array creation routines (heat_tpu ``core/factories.py``).

With ``split=`` given, each rank creates only its own chunk on its device;
nothing global is built for ``arange``, ``zeros``/``ones``/``empty``/
``full`` and their ``_like`` forms, ``eye``, ``linspace``/``logspace`` and
``meshgrid`` (whose outputs are local broadcasts of their vectors).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import devices, types
from .communication import sanitize_comm
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "asarray", "empty", "empty_like", "eye", "from_partitioned",
           "full", "full_like", "linspace", "logspace", "meshgrid", "ones", "ones_like", "tri",
           "tril_indices", "triu_indices", "vander", "zeros", "zeros_like"]


def array(obj, dtype=None, copy: bool = True, split: Optional[int] = None,
          device=None, comm=None) -> DNDarray:
    """Create a DNDarray from array-like data every rank holds (heat_tpu
    ``factories.py:94``). Python data infers like heat_tpu: floats give
    float32, complex gives complex64, ints stay int64; numpy arrays and
    tensors keep their dtype."""
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    if isinstance(obj, DNDarray):
        if dtype is not None and types.canonical_heat_type(dtype) is not obj.dtype:
            obj = obj.astype(dtype)
        elif copy:
            obj = DNDarray(obj.larray.clone(), obj.gshape, obj.dtype, obj.split,
                           obj.device, obj.comm)
        if split is not None:
            split = sanitize_axis(obj.shape, split)
        return obj.resplit(split) if split != obj.split else obj

    if isinstance(obj, torch.Tensor):
        tensor = obj.detach().clone() if copy else obj.detach()
    elif isinstance(obj, np.ndarray):
        tensor = torch.from_numpy(np.array(obj, copy=True) if copy else obj)
    else:
        arr = np.asarray(obj)
        if arr.dtype == np.float64 and not _has_numpy64_leaf(obj):
            arr = arr.astype(np.float32)
        elif arr.dtype == np.complex128 and not _has_numpy64_leaf(obj):
            arr = arr.astype(np.complex64)
        tensor = torch.from_numpy(arr)
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
        tensor = tensor.to(dtype.torch_type())
    return DNDarray.from_global(tensor, split, device, comm)


def _has_numpy64_leaf(obj) -> bool:
    """numpy float64/complex128 scalars keep their dtype, bare or nested."""
    if isinstance(obj, (np.float64, np.complex128)):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_has_numpy64_leaf(o) for o in obj)
    return False


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values (heat_tpu ``factories.py:185``); int64 for integer
    arguments, float32 otherwise."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(f"arange takes 1 to 3 positional arguments, got {len(args)}")
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    if dtype is None:
        ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int64 if ints else types.float32
    dtype = types.canonical_heat_type(dtype)
    tdt = dtype.torch_type()
    n = max(0, int(np.ceil((stop - start) / step)))
    gshape = (n,)
    if split is not None:
        split = sanitize_axis(gshape, split)
    offset, (count,), _ = comm.chunk(gshape, split)
    dev = device.torch_device
    if not tdt.is_floating_point:
        lo = int(start) + offset * int(step)
        local = torch.arange(lo, lo + count * int(step), int(step), dtype=tdt, device=dev)
    else:
        local = (torch.arange(offset, offset + count, dtype=tdt, device=dev)
                 * torch.tensor(step, dtype=tdt, device=dev)
                 + torch.tensor(start, dtype=tdt, device=dev))
    return DNDarray(local, gshape, dtype, split, device, comm)


def _factory(shape, dtype, split, device, comm, make) -> DNDarray:
    shape = sanitize_shape(shape)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    dtype = types.canonical_heat_type(dtype)
    if split is not None:
        split = None if len(shape) == 0 else sanitize_axis(shape, split)
    _, lshape, _ = comm.chunk(shape, split)
    local = make(lshape, dtype=dtype.torch_type(), device=device.torch_device)
    return DNDarray(local, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uninitialized array (heat_tpu ``factories.py:243``)."""
    return _factory(shape, dtype, split, device, comm, torch.empty)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Zeros (heat_tpu ``factories.py:249``)."""
    return _factory(shape, dtype, split, device, comm, torch.zeros)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Ones (heat_tpu ``factories.py:255``)."""
    return _factory(shape, dtype, split, device, comm, torch.ones)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    """No copy where possible (heat_tpu ``factories.py:179``); ``is_split``
    is taken as ``split`` of the global object, as heat_tpu takes it."""
    return array(obj, dtype=dtype, copy=bool(copy), split=is_split, device=device)


def full(shape, fill_value, dtype=types.float32, split=None, device=None, comm=None,
         order="C") -> DNDarray:
    """A constant fill (heat_tpu ``factories.py:261``): float32 by default,
    whatever the fill's type; ``dtype=None`` takes the fill's type. A
    complex fill makes a non-complex type complex64."""
    if isinstance(fill_value, (complex, np.complexfloating)):
        if dtype is None and isinstance(fill_value, np.generic):
            dtype = types.heat_type_of(fill_value)
        elif dtype is None or not types.heat_type_is_complexfloating(
                types.canonical_heat_type(dtype)):
            dtype = types.complex64
    elif dtype is None:
        dtype = types.heat_type_of(fill_value)
    return _factory(shape, dtype, split, device, comm,
                    lambda s, dtype, device: torch.full(s, fill_value, dtype=dtype, device=device))


def _factory_like(a, dtype, split, device, comm, factory, **kwargs) -> DNDarray:
    """heat_tpu ``factories.py:291``: ``a``'s shape, and its type, split,
    device and communicator unless given."""
    shape = a.shape if hasattr(a, "shape") else np.asarray(a).shape
    if dtype is None:
        dtype = a.dtype if isinstance(a, DNDarray) else types.canonical_heat_type(
            np.asarray(a).dtype)
    if isinstance(a, DNDarray):
        split = a.split if split is None else split
        device = a.device if device is None else device
        comm = a.comm if comm is None else comm
    return factory(tuple(shape), dtype=dtype, split=split, device=device, comm=comm, **kwargs)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """heat_tpu ``factories.py:305``."""
    return _factory_like(a, dtype, split, device, comm, empty)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """heat_tpu ``factories.py:310``."""
    return _factory_like(a, dtype, split, device, comm, zeros)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """heat_tpu ``factories.py:315``."""
    return _factory_like(a, dtype, split, device, comm, ones)


def full_like(a, fill_value, dtype=types.float32, split=None, device=None, comm=None,
              order="C") -> DNDarray:
    """heat_tpu ``factories.py:320``: float32 by default, not ``a``'s type;
    ``dtype=None`` takes the fill's."""
    if dtype is None:
        dtype = types.heat_type_of(fill_value)
    return _factory_like(a, dtype, split, device, comm, full, fill_value=fill_value)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones on the diagonal (heat_tpu ``factories.py:329``); each rank sets
    the diagonal of its own chunk."""
    if isinstance(shape, (int, np.integer)):
        n = m = int(shape)
    else:
        shape = tuple(shape)
        n, m = (int(shape[0]), int(shape[0])) if len(shape) == 1 else (int(shape[0]),
                                                                       int(shape[1]))

    def make(lshape, dtype, device):
        comm_ = sanitize_comm(comm)
        split_ = None if split is None else sanitize_axis((n, m), split)
        offset, _, _ = comm_.chunk((n, m), split_)
        r0, c0 = (offset, 0) if split_ == 0 else (0, offset) if split_ == 1 else (0, 0)
        rows = torch.arange(r0, r0 + lshape[0], device=device).unsqueeze(1)
        cols = torch.arange(c0, c0 + lshape[1], device=device).unsqueeze(0)
        return (rows == cols).to(dtype)

    return _factory((n, m), dtype, split, device, comm, make)


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False,
             dtype=None, split=None, device=None, comm=None):
    """Evenly spaced samples (heat_tpu ``factories.py:345``), each rank its
    chunk, computed as ``jnp.linspace`` computes them:
    ``start·(1 - i/div) + stop·(i/div)`` in the type, the last sample
    ``stop`` where ``endpoint``."""
    num = int(num)
    if num <= 0:
        raise ValueError(f"number of samples 'num' must be positive, got {num}")
    div = (num - 1) if endpoint else num
    step = (stop - start) / max(1, div)
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = (num,)
    if split is not None:
        split = sanitize_axis(gshape, split)
    offset, (count,), _ = comm.chunk(gshape, split)
    tdt = dtype.torch_type()
    ct = tdt if tdt.is_floating_point or tdt.is_complex else torch.float64
    dev = device.torch_device
    i = torch.arange(offset, offset + count, dtype=ct, device=dev)
    lo = torch.tensor(start, dtype=ct, device=dev)
    hi = torch.tensor(stop, dtype=ct, device=dev)
    if num > 1:
        frac = i / torch.tensor(div, dtype=ct, device=dev)
        local = lo * (1 - frac) + hi * frac
        if endpoint:
            local = torch.where(i == div, hi, local)
    else:
        local = lo.expand(count).clone()
    if not (tdt.is_floating_point or tdt.is_complex):
        local = torch.floor(local)
    result = DNDarray(local.to(tdt), gshape, dtype, split, device, comm)
    return (result, step) if retstep else result


def logspace(start, stop, num: int = 50, endpoint: bool = True, base: float = 10.0,
             dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``base ** linspace(...)`` (heat_tpu ``factories.py:385``)."""
    from . import arithmetics

    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    result = arithmetics.pow(float(base), y)
    return result.astype(types.canonical_heat_type(dtype)) if dtype is not None else result


def meshgrid(*arrays, indexing: str = "xy"):
    """Coordinate matrices (heat_tpu ``factories.py:408``). The first split
    input decides the outputs' split (its grid axis); each output is its
    vector broadcast on the rank, a split vector keeping its chunk along
    that axis, any other vector whole (a split one gathered, counted)."""
    if indexing not in ("xy", "ij"):
        raise ValueError("indexing must be 'xy' or 'ij'")
    if not arrays:
        return []
    nd = len(arrays)
    grid_of = list(range(nd))
    if indexing == "xy" and nd >= 2:
        grid_of[0], grid_of[1] = 1, 0
    out_split = next((grid_of[i] for i, a in enumerate(arrays)
                      if isinstance(a, DNDarray) and a.split is not None), None)
    like = next((a for a in arrays if isinstance(a, DNDarray)), None)
    device = like.device if like is not None else devices.sanitize_device(None)
    comm = like.comm if like is not None else sanitize_comm(None)
    vecs = []
    for a in arrays:
        if not isinstance(a, DNDarray):
            a = DNDarray.from_global(torch.as_tensor(np.asarray(a)).reshape(-1), None, device,
                                     comm)
        vecs.append(a if a.ndim == 1 else a.reshape((a.size,)))
    shape = [0] * nd
    for i, v in enumerate(vecs):
        shape[grid_of[i]] = v.shape[0]
    shape = tuple(shape)
    _, lshape, _ = comm.chunk(shape, out_split)
    outs = []
    for i, v in enumerate(vecs):
        pos = grid_of[i]
        if pos == out_split and v.split == 0:
            base = v.larray
        elif pos == out_split:
            _, _, (sl,) = comm.chunk((v.shape[0],), 0)
            base = v._logical()[sl]
        else:
            base = v.resplit(None).larray if v.split is not None else v.larray
        view = base.reshape(tuple(-1 if d == pos else 1 for d in range(nd))).expand(lshape)
        outs.append(DNDarray(view, shape, v.dtype, out_split, device, comm))
    return outs


def from_partitioned(x, comm=None) -> DNDarray:
    """Adopt an existing array (heat_tpu ``factories.py:481``): a tensor or
    array-like every rank holds whole; an unsharded array has no split, as
    in heat_tpu."""
    comm = sanitize_comm(comm)
    tensor = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return DNDarray.from_global(tensor, None, devices.sanitize_device(None), comm)


def tri(N: int, M=None, k: int = 0, dtype=types.float32, split=None, device=None,
        comm=None) -> DNDarray:
    """``numpy.tri`` (heat_tpu ``factories.py:498``)."""
    M = N if M is None else M
    return array(np.tri(int(N), int(M), int(k)), dtype=dtype, split=split, device=device,
                 comm=comm)


def tril_indices(n: int, k: int = 0, m=None, split=None, device=None, comm=None):
    """``numpy.tril_indices`` (heat_tpu ``factories.py:506``)."""
    rows, cols = np.tril_indices(int(n), int(k), None if m is None else int(m))
    return (array(rows, dtype=types.int64, split=split, device=device, comm=comm),
            array(cols, dtype=types.int64, split=split, device=device, comm=comm))


def triu_indices(n: int, k: int = 0, m=None, split=None, device=None, comm=None):
    """``numpy.triu_indices`` (heat_tpu ``factories.py:513``)."""
    rows, cols = np.triu_indices(int(n), int(k), None if m is None else int(m))
    return (array(rows, dtype=types.int64, split=split, device=device, comm=comm),
            array(cols, dtype=types.int64, split=split, device=device, comm=comm))


def vander(x, N=None, increasing: bool = False) -> DNDarray:
    """``numpy.vander`` (heat_tpu ``factories.py:520``): broadcast powers, a
    split vector giving a row-split matrix."""
    from . import arithmetics

    if not isinstance(x, DNDarray):
        x = array(np.asarray(x))
    if x.ndim != 1:
        raise ValueError("vander expects a 1-D array")
    N = x.shape[0] if N is None else int(N)
    exps = np.arange(N) if increasing else np.arange(N - 1, -1, -1)
    return arithmetics.pow(x.reshape((x.shape[0], 1)),
                           array(exps[None, :], dtype=x.dtype, device=x.device, comm=x.comm))
