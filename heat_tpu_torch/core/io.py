"""File I/O (heat_tpu ``core/io.py``): HDF5, NetCDF, CSV and ``.npy``.

The port keeps the original Heat's process model, so I/O is per rank, as
in the original Heat (``heat/core/io.py``): a load has each rank read only
its own rows of the file — :meth:`TorchCommunication.chunk` of the split
axis — and move them to its device, with no collective; a save has no rank
gather the array: ranks write their own rows in rank order, rank 0 creating
the file and each later rank appending after the one before it (the
original Heat's write without MPI-IO), one :meth:`TorchCommunication.Barrier` a
turn, so every rank returns once the file is whole.

NetCDF takes ``netCDF4`` where it imports and scipy's classic NetCDF-3
reader and writer otherwise, as heat_tpu does. ``stream=True`` on the HDF5
and NetCDF loads returns a :class:`DataStream`, the out-of-core source of
``fit_stream``. CSV parses through the port's native parser
(:mod:`heat_tpu_torch.native`) where it builds, and ``numpy.genfromtxt``
otherwise or for encodings that are no ASCII superset; ``csv_routes``
counts which route each load took.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional

import numpy as np
import torch

from . import devices, factories, types
from .communication import sanitize_comm
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "DataStream",
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "load_npy_from_path",
    "save",
    "save_csv",
    "save_hdf5",
    "save_netcdf",
    "supports_hdf5",
    "supports_netcdf",
]

# which parser each load_csv took
csv_routes = {"native": 0, "genfromtxt": 0}

try:
    import h5py

    _HDF5 = True
except ImportError:
    _HDF5 = False

try:
    import netCDF4 as nc

    _NETCDF: Optional[str] = "netCDF4"
except ImportError:
    # classic NetCDF-3 through scipy, as heat_tpu falls back (io.py:127-140)
    try:
        from scipy.io import netcdf_file as _scipy_nc

        _NETCDF = "scipy"
    except ImportError:
        _NETCDF = None


def supports_hdf5() -> bool:
    """True if HDF5 I/O is available (heat_tpu ``io.py:143``)."""
    return _HDF5


def supports_netcdf() -> bool:
    """True if NetCDF I/O is available, with netCDF4 or with scipy's classic
    NetCDF-3 backend (heat_tpu ``io.py:148``)."""
    return _NETCDF is not None


def _np_dtype(dtype) -> np.dtype:
    """numpy's dtype for reading or storing a heat type: bfloat16 as float32
    (numpy, h5py and NetCDF have none)."""
    tt = dtype.torch_type()
    return np.dtype(np.float32) if tt == torch.bfloat16 else np.dtype(str(tt).split(".")[1])


def _to_device(block: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(block)).to(
        device=device.torch_device, dtype=dtype.torch_type())


def _shard_and_wrap(load_chunk, gshape, dtype, split, device, comm) -> DNDarray:
    """A DNDarray of which each rank reads only its own chunk
    (heat_tpu ``io.py:154``; the original Heat's per-rank ``comm.chunk``
    read): ``load_chunk(slices) -> np.ndarray`` reads one block of the file.
    No collective."""
    gshape = tuple(int(s) for s in gshape)
    np_dtype = _np_dtype(dtype)
    if split is None:
        data = np.asarray(load_chunk(tuple(slice(0, s) for s in gshape)), np_dtype)
        return DNDarray(_to_device(data, dtype, device), gshape, dtype, None, device, comm)
    split = sanitize_axis(gshape, split)
    _, lshape, slices = comm.chunk(gshape, split)
    if lshape[split] == 0:
        data = np.empty(lshape, np_dtype)
    else:
        data = np.asarray(load_chunk(slices), np_dtype)
    return DNDarray(_to_device(data, dtype, device), gshape, dtype, split, device, comm)


class DataStream:
    """A re-iterable out-of-core chunk source: the ``stream=True`` mode of
    :func:`load_hdf5` and :func:`load_netcdf` (heat_tpu ``io.py:45``).

    :meth:`iter_chunks` reopens the file and yields consecutive row blocks
    as split-0 ``DNDarray`` chunks, each rank reading only its rows of each
    chunk; a new call streams the same data again (the epoch re-read of an
    out-of-core ``fit_stream``). ``chunks_read`` and ``bytes_read``
    accumulate over the stream's life and ``peak_chunk_bytes`` is the
    largest chunk's payload, counted as heat_tpu counts it: the chunk's
    rows padded to whole ceil-chunks of the ranks, times a row's bytes. The
    process-wide counters ``io.stream_chunks`` and ``io.stream_bytes`` of
    :mod:`heat_tpu_torch.utils.metrics` mirror the totals (heat_tpu
    ``io.py:114-115``).
    """

    def __init__(self, open_fn, gshape, dtype, device, comm, name=""):
        self._open = open_fn
        self.shape = tuple(int(s) for s in gshape)
        self.dtype = dtype
        self.device = device
        self.comm = comm
        self.name = name
        self.chunks_read = 0
        self.bytes_read = 0
        self.peak_chunk_bytes = 0

    def __repr__(self) -> str:
        return (f"DataStream({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, chunks_read={self.chunks_read})")

    def iter_chunks(self, rows_per_chunk: int):
        """Yield the dataset as consecutive split-0 chunks of at most
        ``rows_per_chunk`` rows (the last one may be shorter)."""
        rows = int(rows_per_chunk)
        if rows <= 0:
            raise ValueError(f"rows_per_chunk must be positive, got {rows_per_chunk!r}")
        n = self.shape[0]
        row_bytes = int(np.prod(self.shape[1:], dtype=np.int64)) \
            * torch.empty((), dtype=self.dtype.torch_type()).element_size()

        def gen():
            from ..utils import metrics

            with self._open() as read:
                for lo in range(0, n, rows):
                    hi = min(lo + rows, n)

                    def load(slices, _lo=lo):
                        return read((slice(slices[0].start + _lo, slices[0].stop + _lo),)
                                    + tuple(slices[1:]))

                    chunk = _shard_and_wrap(load, (hi - lo,) + self.shape[1:], self.dtype, 0,
                                            self.device, self.comm)
                    nbytes = self.comm.padded_size(hi - lo) * row_bytes
                    self.chunks_read += 1
                    self.bytes_read += nbytes
                    self.peak_chunk_bytes = max(self.peak_chunk_bytes, nbytes)
                    metrics.inc("io.stream_chunks")
                    metrics.inc("io.stream_bytes", nbytes)
                    yield chunk

        return gen()


def _stream_split(split) -> None:
    if split not in (None, 0):
        raise ValueError(f"stream=True yields row-split chunks; split={split!r} is not supported")


def load_hdf5(path: str, dataset: str, dtype=types.float32, load_fraction: float = 1.0,
              split=None, device=None, comm=None, stream: bool = False):
    """Load an HDF5 dataset, each rank its own rows (heat_tpu ``io.py:205``);
    with ``stream=True`` a :class:`DataStream` of it instead."""
    if not supports_hdf5():
        raise RuntimeError("hdf5 is required for HDF5 operations, but h5py is not available")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, not {type(dataset)}")
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    dtype = types.canonical_heat_type(dtype)
    with h5py.File(path, "r") as handle:
        data = handle[dataset]
        gshape = tuple(data.shape)
        if load_fraction < 1.0:
            ax = split if split is not None else 0
            gshape = tuple(int(s * load_fraction) if i == ax else s
                           for i, s in enumerate(gshape))
        if not stream:
            return _shard_and_wrap(lambda slices: data[slices], gshape, dtype, split, device,
                                   comm)
    _stream_split(split)

    @contextlib.contextmanager
    def _open():
        with h5py.File(path, "r") as handle:
            yield lambda slices: handle[dataset][slices]

    return DataStream(_open, gshape, dtype, device, comm, name=f"{path}:{dataset}")


def _netcdf_missing():
    return RuntimeError("netcdf is required for NetCDF operations — install netCDF4, "
                        "or scipy for classic NetCDF-3 files")


def _netcdf_reader(var):
    """Reads blocks of a NetCDF variable: masked cells as NaN for floats and
    as the variable's fill value for integers, on either backend (heat_tpu
    ``io.py:344``)."""
    def read(slices):
        block = var[slices]
        if isinstance(block, np.ma.MaskedArray):
            block = (block.filled(np.nan) if np.issubdtype(block.dtype, np.floating)
                     else block.filled())
        return np.asarray(block)

    return read


def load_netcdf(path: str, variable: str, dtype=types.float32, split=None, device=None,
                comm=None, stream: bool = False):
    """Load a NetCDF variable, each rank its own rows (heat_tpu ``io.py:329``);
    with ``stream=True`` a :class:`DataStream` of it instead."""
    if not supports_netcdf():
        raise _netcdf_missing()
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    dtype = types.canonical_heat_type(dtype)

    @contextlib.contextmanager
    def _open_var():
        if _NETCDF == "netCDF4":
            with nc.Dataset(path, "r") as handle:
                yield handle.variables[variable]
        else:
            # maskandscale: netCDF4's default semantics (scale, offset, mask);
            # mmap=False reads the whole variable as the file opens
            with _scipy_nc(path, "r", mmap=False, maskandscale=True) as handle:
                yield handle.variables[variable]

    if stream:
        _stream_split(split)
        with _open_var() as var:
            gshape = tuple(var.shape)

        @contextlib.contextmanager
        def _open():
            with _open_var() as var:
                yield _netcdf_reader(var)

        return DataStream(_open, gshape, dtype, device, comm, name=f"{path}:{variable}")
    with _open_var() as var:
        return _shard_and_wrap(_netcdf_reader(var), tuple(var.shape), dtype, split, device,
                               comm)


def _own_block(data: DNDarray):
    """``(global slices, numpy block)`` of the rows this rank writes, or
    None: its shard of a split array, the whole of a replicated one on rank
    0 only (heat_tpu's ``_iter_shard_blocks``, ``io.py:265``, per rank)."""
    if data.split is None:
        if data.comm.rank != 0:
            return None
        slices = tuple(slice(0, s) for s in data.gshape)
    else:
        _, lshape, slices = data.comm.chunk(data.gshape, data.split)
        if lshape[data.split] == 0:
            return None
    t = data.larray.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return slices, np.asarray(t.cpu().numpy(), _np_dtype(data.dtype))


def _rank_ordered(data: DNDarray, write) -> None:
    """Ranks write in rank order: ``write(first, block)`` on rank ``r`` in
    turn ``r``, ``first`` on rank 0 (which creates the file); a
    :meth:`~TorchCommunication.Barrier` ends each turn, and every rank
    raises if a turn failed."""
    comm = data.comm
    block = _own_block(data)
    device = data.larray.device
    for turn in range(comm.size):
        failed = None
        if comm.rank == turn:
            try:
                write(turn == 0, block)
            except Exception as err:  # every rank must leave the turn
                failed = err
        if comm.Barrier(failed is not None, device):
            if failed is not None:
                raise failed
            raise RuntimeError(f"rank {turn} failed to write its rows")


def _write_block(var, block, ndim: int) -> None:
    if block is None:
        return
    slices, values = block
    if ndim == 0:
        var[()] = values
    else:
        var[slices] = values


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Save to HDF5 rank by rank (heat_tpu ``io.py:309``): rank 0 creates the
    dataset at the global shape, each rank writes its own rows."""
    if not supports_hdf5():
        raise RuntimeError("hdf5 is required for HDF5 operations, but h5py is not available")
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")

    def write(first, block):
        with h5py.File(path, mode if first else "r+") as handle:
            if first:
                dset = handle.create_dataset(dataset, shape=data.gshape,
                                             dtype=_np_dtype(data.dtype), **kwargs)
            else:
                dset = handle[dataset]
            _write_block(dset, block, data.ndim)

    _rank_ordered(data, write)


def _dim_names(handle, dims_sizes):
    """Positional ``dim_{i}`` names, creating missing dimensions; a
    same-named dimension of another size, or the unlimited one, gets a
    size-suffixed name instead (heat_tpu ``io.py:407``)."""
    names = []
    for i, s in enumerate(dims_sizes):
        name = f"dim_{i}"
        if name not in handle.dimensions:
            handle.createDimension(name, s)
        else:
            d = handle.dimensions[name]
            # scipy: name -> size (None = unlimited); netCDF4: a Dimension
            size = len(d) if hasattr(d, "__len__") else d
            unlimited = size is None or (hasattr(d, "isunlimited") and d.isunlimited())
            if unlimited or size != s:
                name = f"dim_{i}_{s}"
                if name not in handle.dimensions:
                    handle.createDimension(name, s)
        names.append(name)
    return tuple(names)


def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", **kwargs) -> None:
    """Save to NetCDF rank by rank (heat_tpu ``io.py:396``): rank 0 creates
    the variable at the global shape, each rank writes its own rows. The
    scipy backend takes modes ``w``, ``a`` and ``r+`` and the types classic
    NetCDF-3 holds."""
    if not supports_netcdf():
        raise _netcdf_missing()
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    np_dt = _np_dtype(data.dtype)
    if _NETCDF == "netCDF4":
        def write(first, block):
            with nc.Dataset(path, mode if first else "a") as handle:
                var = (handle.createVariable(variable, np_dt, _dim_names(handle, data.gshape))
                       if first else handle.variables[variable])
                _write_block(var, block, data.ndim)

        _rank_ordered(data, write)
        return
    if mode in ("a", "r+"):
        scipy_mode = "a"
    elif mode == "w":
        scipy_mode = "w"
    else:
        raise ValueError(f"mode {mode!r} is not supported by the classic NetCDF-3 (scipy) "
                         "backend; use 'w', 'a' or 'r+'")
    if np_dt not in (np.dtype(t) for t in ("int8", "int16", "int32", "float32", "float64")):
        raise ValueError(
            f"dtype {np_dt} cannot be stored in a classic NetCDF-3 file (scipy backend; "
            "NetCDF-3 has no 8-byte or unsigned integers) — cast the array first, e.g. to "
            "int32 or float64")

    def write(first, block):
        with _scipy_nc(path, scipy_mode if first else "a", mmap=False) as handle:
            var = (handle.createVariable(variable, np_dt, _dim_names(handle, data.gshape))
                   if first else handle.variables[variable])
            _write_block(var, block, data.ndim)

    _rank_ordered(data, write)


def _native_csv(path: str, header_lines: int, sep: str) -> np.ndarray:
    """The native parse with ``genfromtxt``'s shapes for one cell (0-d), one
    row ``(1, c)`` and one column ``(r,)`` (heat_tpu ``io.py:496-509``)."""
    from .. import native

    start = 0
    if header_lines:
        with open(path, "rb") as handle:
            for _ in range(header_lines):
                handle.readline()
            start = handle.tell()
    data = native.parse_csv_chunk(path, start=start, sep=sep)
    if data.shape == (1, 1):
        return data.reshape(())
    if data.shape[1] == 1 and data.shape[0] != 1:
        return data[:, 0]
    return data


def load_csv(path: str, header_lines: int = 0, sep: str = ",", dtype=types.float32,
             encoding: str = "utf-8", split=None, device=None, comm=None) -> DNDarray:
    """Load a numeric CSV file (heat_tpu ``io.py:468``). Every rank parses the
    file and keeps its own rows, as :func:`factories.array` does with host
    data. The native parser reads bytes, so it takes only encodings that are
    an ASCII superset; the others, and a machine where the parser does not
    build, take ``numpy.genfromtxt`` with the same NaN and shape rules."""
    from .. import native

    ascii_superset = encoding.lower().replace("-", "").replace("_", "") in (
        "utf8", "ascii", "latin1", "iso88591")
    if ascii_superset and native.available():
        # a ragged file raises ValueError, as genfromtxt does
        data = _native_csv(path, header_lines, sep)
        csv_routes["native"] += 1
    else:
        csv_routes["genfromtxt"] += 1
        data = np.genfromtxt(path, delimiter=sep, skip_header=header_lines, encoding=encoding)
        if data.ndim == 1:
            # one data row gives (1, c), one column (r,): count the data lines
            with open(path, encoding=encoding) as handle:
                n_lines = sum(1 for line in handle if line.strip()) - header_lines
            if n_lines == 1 and data.size > 1:
                data = data.reshape(1, -1)
    return factories.array(data, dtype=dtype, split=split, device=device, comm=comm)


def save_csv(data: DNDarray, path: str, header_lines: Optional[Iterable[str]] = None,
             sep: str = ",", decimals: int = -1, trunc: bool = False, **kwargs) -> None:
    """Save to CSV rank by rank in global row order (heat_tpu ``io.py:527``):
    rank 0 writes the header and its rows, each later rank appends its own.
    A column-split array resplits to rows first (one all-to-all)."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if data.ndim > 1 and data.split not in (None, 0):
        data = data.resplit(0)

    def write(first, block):
        with open(path, "w" if first else "a", encoding="utf-8") as handle:
            if first and header_lines:
                handle.write("\n".join(header_lines) + "\n")
            if block is None:
                return
            values = block[1]
            if decimals >= 0:
                values = np.round(values, decimals)
            np.savetxt(handle, np.atleast_1d(values), delimiter=sep)

    _rank_ordered(data, write)


def load_npy_from_path(path: str, dtype=types.float32, split=0, device=None,
                       comm=None) -> DNDarray:
    """Load and concatenate the ``.npy`` files of a directory in name order
    (heat_tpu ``io.py:553``)."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not files:
        raise ValueError(f"no .npy files under {path}")
    data = np.concatenate([np.load(os.path.join(path, f)) for f in files], axis=0)
    return factories.array(data, dtype=dtype, split=split, device=device, comm=comm)


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (heat_tpu ``io.py:563``)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        return load_netcdf(path, *args, **kwargs)
    if ext == ".csv":
        return load_csv(path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension (heat_tpu ``io.py:577``)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return save_hdf5(data, path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        return save_netcdf(data, path, *args, **kwargs)
    if ext == ".csv":
        return save_csv(data, path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")
