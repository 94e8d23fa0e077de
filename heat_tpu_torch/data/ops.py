"""Exact order statistics by bisection (heat_tpu ``data/ops.py:65-110``,
``:388-503``).

Each rank sorts the order keys of its shard once. Then ``bits`` rounds,
each ONE all-reduce of the (m,) counts of keys at or below the midpoints,
narrow every requested rank to its exact key: the count steps only at keys
the data holds, so the bisection lands on one. The keys decode bit-exactly.
No round gathers the data.

heat_tpu bisects on the unsigned line (its ``unsigned_key``: the total-order
key with the sign bit flipped). torch's unsigned types lack ``sort`` and
``searchsorted`` on the card, so the port carries the same keys signed: the
flip is exactly the map between the two lines, and the midpoint
``(lo >> 1) + (hi >> 1) + (lo & hi & 1)`` is the unsigned one moved by
``2^(bits-1)``, without overflow. The rounds, their count and their
answers are heat_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core._sort import _float_sort_key
from . import engine

__all__ = ["signed_key", "decode_key", "order_stats", "order_stat_take"]

_KEY_TYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def _key_bits(dtype: torch.dtype) -> int:
    """The width of a type's order key (heat_tpu ``data/ops.py:100``)."""
    if dtype.is_floating_point:
        return 64 if dtype.itemsize == 8 else 32
    return max(dtype.itemsize * 8, 8)


def _orderable(dtype: torch.dtype) -> bool:
    """Floats and integers, not bool (heat_tpu ``data/ops.py:106``)."""
    return dtype.is_floating_point or (not dtype.is_complex and dtype != torch.bool)


def signed_key(x: torch.Tensor) -> torch.Tensor:
    """heat_tpu's ``unsigned_key`` (``data/ops.py:65``) on the signed line:
    the total-order key of floats (NaN last, canonicalized), a signed
    integer itself, and an unsigned integer with its top bit flipped
    (``x - 2^(bits-1)``), each in a signed integer of the key's width."""
    if x.dtype.is_floating_point:
        return _float_sort_key(x)
    if x.dtype == torch.uint8:
        return (x.to(torch.int16) - 128).to(torch.int8)
    return x


def decode_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`signed_key`, bit-exact (heat_tpu
    ``data/ops.py:80``)."""
    if dtype.is_floating_point:
        imax = torch.iinfo(k.dtype).max
        b = torch.where(k >= 0, k, imax - k)  # self-inverse under wraparound
        f = b.view(torch.float64 if k.dtype == torch.int64 else torch.float32)
        return f.to(dtype)
    if dtype == torch.uint8:
        return (k.to(torch.int16) + 128).to(torch.uint8)
    return k.to(dtype)


def order_stats(local: torch.Tensor, ranks, comm) -> torch.Tensor:
    """Exact order statistics of the flattened split array whose shard is
    ``local``, at the sorted 0-based ``ranks``, in the array's type and
    the same on every rank (heat_tpu ``order_stats`` ``:438`` with
    ``_build_order_stats`` ``:388``): ``bits`` rounds, each one all-reduce
    of the (m,) counts."""
    dtype = local.dtype
    bits = _key_bits(dtype)
    kdt = _KEY_TYPES[bits]
    su = torch.sort(signed_key(local.reshape(-1))).values
    rk = torch.as_tensor(list(ranks), dtype=torch.int64, device=local.device)
    info = torch.iinfo(kdt)
    lo = torch.full(rk.shape, info.min, dtype=kdt, device=local.device)
    hi = torch.full(rk.shape, info.max, dtype=kdt, device=local.device)
    for _ in range(bits):
        done = lo >= hi
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = torch.searchsorted(su, mid, right=True).to(torch.int64)
        cnt = comm.Allreduce(cnt)
        ge = cnt >= rk + 1
        nlo = torch.where(ge, lo, mid + 1)
        nhi = torch.where(ge, mid, hi)
        lo = torch.where(done, lo, nlo)
        hi = torch.where(done, hi, nhi)
    return decode_key(lo, dtype)


def order_stat_take(local: torch.Tensor, n: int, q_arr, interpolation: str, floating: bool,
                    comm):
    """The engine route of the percentile's flat branch (heat_tpu
    ``order_stat_take`` ``:464``): the ranks the picks need, ONE bisection,
    and a ``take(i)`` returning the statistic of rank ``i`` as a 0-d
    tensor; None when the engine is off or the type is not orderable (the
    caller then takes the merge-split sort)."""
    if not engine.enabled() or n <= 0 or not _orderable(local.dtype):
        return None
    ranks = set()
    for qv in np.asarray(q_arr, dtype=np.float64).reshape(-1):
        f = (n - 1) * float(qv) / 100.0
        lo, hi = int(np.floor(f)), int(np.ceil(f))
        if interpolation == "lower":
            ranks.add(lo)
        elif interpolation == "higher":
            ranks.add(hi)
        elif interpolation == "nearest":
            ranks.add(int(np.round(f)))
        else:  # linear / midpoint interpolate between both neighbours
            ranks.update((lo, hi))
    if floating:
        ranks.add(n - 1)  # the NaN-poisoning probe
    ranks_t = tuple(sorted(ranks))
    vals = order_stats(local, ranks_t, comm)
    index = {r: i for i, r in enumerate(ranks_t)}
    return lambda i: vals[index[int(i)]]
