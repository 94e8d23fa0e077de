"""Pairwise distance matrices (heat_tpu ``spatial/distance.py``).

heat_tpu's ``_dist`` carries over: a replicated ``Y`` takes one local tile
per shard with no communication (the KMeans case); two split-0 operands run
the systolic ring — ``X`` stays, ``Y`` blocks travel one rank per step — and
at world size 1 the one tile is the whole output. The quadratic-expansion
tile is the ``cdist_tile`` kernel; the difference form and ``manhattan`` are
plain torch, as heat_tpu computes them outside Pallas too. ``rbf`` takes the
kernel's float32 output (heat_tpu's ``keep_acc``), so the exp sees unrounded
squared distances also for half-precision input.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.kernels import cdist_tile

__all__ = ["cdist", "manhattan", "rbf"]


def _l2_tile(x: torch.Tensor, y: torch.Tensor, expand: bool, sqrt: bool,
             keep_acc: bool = False) -> torch.Tensor:
    """One block of pairwise L2 distances (heat_tpu ``distance.py:36``),
    accumulated in ``accumulation_dtype``, returned in the input dtype, or
    in the accumulation dtype with ``keep_acc``."""
    acc = types.accumulation_dtype(x.dtype)
    out_dt = acc if keep_acc else x.dtype
    if expand:  # the kernel takes contiguous rows; a column slice is a strided view
        return cdist_tile(x.contiguous(), y.contiguous(), sqrt=sqrt, out_dtype=out_dt)
    diff = x.to(acc)[:, None, :] - y.to(acc)[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return (torch.sqrt(d2) if sqrt else d2).to(out_dt)


def _euclidean_tile(x, y, expand: bool):
    return _l2_tile(x, y, expand, sqrt=True)


def _manhattan_tile(x, y, expand: bool):
    """heat_tpu ``distance.py:68``: summed absolute differences, in the
    accumulation dtype."""
    acc = types.accumulation_dtype(x.dtype)
    diff = torch.abs(x.to(acc)[:, None, :] - y.to(acc)[None, :, :])
    return torch.sum(diff, dim=-1).to(x.dtype)


def _gaussian_tile(sigma: float):
    """heat_tpu ``distance.py:74``: ``exp(-d² / (2σ²))`` of the float32
    squared distances, in place on the tile."""
    def tile(x, y, expand: bool):
        d2 = _l2_tile(x, y, expand, sqrt=False, keep_acc=True)
        return d2.div_(-(2.0 * sigma * sigma)).exp_().to(x.dtype)

    return tile


def _dist(X: DNDarray, Y: Optional[DNDarray], tile_fn: Callable, expand: bool) -> DNDarray:
    """Distance-matrix entry (heat_tpu ``distance.py:84``)."""
    if not isinstance(X, DNDarray):
        raise TypeError(f"X must be a DNDarray, got {type(X)}")
    if X.ndim != 2:
        raise NotImplementedError(f"X must be 2-dimensional, got {X.ndim}")
    if Y is None:
        Y = X
    if not isinstance(Y, DNDarray):
        raise TypeError(f"Y must be a DNDarray, got {type(Y)}")
    if Y.ndim != 2:
        raise NotImplementedError(f"Y must be 2-dimensional, got {Y.ndim}")
    if X.shape[1] != Y.shape[1]:
        raise ValueError(f"feature dimensions differ: {X.shape[1]} != {Y.shape[1]}")

    promoted = types.promote_types(X.dtype, Y.dtype)
    if types.heat_type_is_exact(promoted):
        promoted = types.float32
    dt = promoted.torch_type()
    n, m = X.shape[0], Y.shape[0]
    comm = X.comm

    if X.split == 1:
        X = X.resplit(0)
    if Y.split == 1:
        Y = Y.resplit(0)
    if X.split is None and Y.split is None:
        d = tile_fn(X.larray.to(dt), Y.larray.to(dt), expand)
        return DNDarray(d, (n, m), promoted, None, X.device, comm)
    if X.split is None:
        # the transposed problem on the row-split path, result split along 1
        dt_ = _dist(Y, X, tile_fn, expand)
        return DNDarray(dt_.larray.T.contiguous(), (n, m), promoted, 1, X.device, comm)
    if Y.split is None:
        d = _local_kernel(X, Y, tile_fn, expand, dt)
    else:
        d = _ring_kernel(X, Y, tile_fn, expand, dt)
    return DNDarray(d, (n, m), promoted, 0, X.device, comm)


def _local_kernel(X, Y, tile_fn, expand, dt) -> torch.Tensor:
    """Replicated ``Y``: one local tile per shard (heat_tpu ``distance.py:133``)."""
    return tile_fn(X.larray.to(dt), Y.larray.to(dt), expand)


def _ring_kernel(X, Y, tile_fn, expand, dt) -> torch.Tensor:
    """Systolic ring (heat_tpu ``distance.py:150``): ``size`` tile steps, the
    ``Y`` block moving to the next rank between them; at world size 1 the
    tile is the whole output."""
    comm = X.comm
    x = X.larray.to(dt)
    y = Y.larray.to(dt)
    if comm.size == 1:
        return tile_fn(x, y, expand)
    counts, displs = comm.counts_displs(Y.shape[0])
    width = max(counts)
    if y.shape[0] < width:  # the ring moves equal blocks
        y = torch.cat([y, y.new_zeros((width - y.shape[0], y.shape[1]))])
    out = None
    for step in range(comm.size):
        src = (comm.rank - step) % comm.size
        tile = tile_fn(x, y[:counts[src]], expand)
        if out is None:
            out = tile.new_empty((x.shape[0], Y.shape[0]))
        out[:, displs[src]:displs[src] + counts[src]] = tile
        if step != comm.size - 1:
            y = comm.ring_step(y)
    return out


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix (heat_tpu ``distance.py:195``)."""
    return _dist(X, Y, _euclidean_tile, quadratic_expansion)


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """Manhattan distance matrix (heat_tpu ``distance.py:200``)."""
    return _dist(X, Y, _manhattan_tile, False)


def rbf(X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0,
        quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian (RBF) kernel matrix (heat_tpu ``distance.py:205``)."""
    return _dist(X, Y, _gaussian_tile(sigma), quadratic_expansion)
