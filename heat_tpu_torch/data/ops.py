"""The data engine's in-memory primitives (heat_tpu ``data/ops.py``): groupby,
top-k, the inner hash join and exact order statistics, each shard-local
compute plus one planned exchange, never a gather of the data axis.

=================  ===================================================
op                 collectives at world size p > 1
=================  ===================================================
groupby            one ``packed_all_reduce`` of the (G, ...) partials
                   (sum, count; mean packs its sums and counts), or one
                   ``all_reduce`` (min, max)
top-k              one ``packed_all_reduce`` of the (p, k) candidate
                   table (keys and positions)
join               one ``all_to_all`` of the hash partitions (both
                   sides in one message), one ``all_reduce`` of the
                   per-rank match counts (the one host read of the
                   result's length), one ``all_to_all`` that routes the
                   matches to the result's split-0 layout
order statistics   ``bits`` ``all_reduce`` rounds of the (m,) counts
=================  ===================================================

heat_tpu's join sends nine collectives in its two programs (four
all-to-alls, an exclusive scan and a sum, three all-to-alls); the port
packs the same exchanges into three. Where the engine is off, or an input
is not split along 0, the ``_eager_*`` forms compute the same results on
the logical arrays, as heat_tpu's do.

Order statistics: each rank sorts the order keys of its shard once. Then
``bits`` rounds, each ONE all-reduce of the (m,) counts of keys at or
below the midpoints, narrow every requested rank to its exact key: the
count steps only at keys the data holds, so the bisection lands on one.
The keys decode bit-exactly.

heat_tpu orders on the unsigned line (its ``unsigned_key``: the
total-order key with the sign bit flipped). torch's unsigned types lack
``sort`` and ``searchsorted`` on the card, so the port carries the same
keys signed: the flip is exactly the map between the two lines, and the
midpoint ``(lo >> 1) + (hi >> 1) + (lo & hi & 1)`` is the unsigned one
moved by ``2^(bits-1)``, without overflow. The total order is ``-inf <
... < -0.0 < +0.0 < ... < +inf < NaN``, NaNs canonicalized.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fusion, types
from ..core._sort import _float_sort_key
from ..core.dndarray import DNDarray
from ..utils import metrics
from . import engine

__all__ = ["groupby", "GroupBy", "groupby_agg", "topk", "join", "signed_key", "decode_key",
           "order_stats", "order_stat_take"]

AGGS = ("sum", "mean", "count", "min", "max")

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
    of the (m,) counts, the whole one :func:`.engine.engine_call` program."""
    metrics.inc("data_engine.quantile_calls")
    dtype = local.dtype
    bits = _key_bits(dtype)
    kdt = _KEY_TYPES[bits]
    info = torch.iinfo(kdt)

    def body(local, rk):
        su = torch.sort(signed_key(local.reshape(-1))).values
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

    rk = torch.as_tensor(list(ranks), dtype=torch.int64, device=local.device)
    key = ("data.ostats", tuple(local.shape), str(dtype), len(rk), fusion._comm_key(comm),
           str(local.device))
    return engine.engine_call(key, lambda qk, ck, hk: body, (local, rk), body)


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


def _replicated(t: torch.Tensor, like: DNDarray) -> DNDarray:
    return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, like.device,
                    like.comm)


# ---------------------------------------------------------------------- #
# groupby-aggregate                                                      #
# ---------------------------------------------------------------------- #
def _neutral(dtype: torch.dtype, op: str):
    """The identity of ``min``/``max`` in ``dtype``: ±inf or the integer
    extreme (heat_tpu ``data/ops.py:164-170``)."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _group_partials(keys: torch.Tensor, values, G: int, op: str):
    """The (G, ...) partials of one block of rows (heat_tpu's
    ``_build_groupby`` body, ``data/ops.py:133-176``): keys outside
    ``[0, G)`` are dropped; ``mean`` gives its float64 sums and counts."""
    valid = (keys >= 0) & (keys < G)
    idx = torch.where(valid, keys, torch.zeros_like(keys)).to(torch.int64)
    if op == "count":
        return (torch.zeros(G, dtype=torch.int64, device=keys.device)
                .index_add_(0, idx, valid.to(torch.int64)),)
    vmask = valid.reshape(valid.shape + (1,) * (values.ndim - 1))
    gshape = (G,) + tuple(values.shape[1:])
    if op in ("sum", "mean"):
        dt = values.dtype if op == "sum" else torch.float64
        contrib = torch.where(vmask, values, torch.zeros((), dtype=values.dtype,
                                                        device=values.device)).to(dt)
        sums = torch.zeros(gshape, dtype=dt, device=values.device).index_add_(0, idx, contrib)
        if op == "sum":
            return (sums,)
        counts = torch.zeros(G, dtype=dt, device=values.device).index_add_(0, idx, valid.to(dt))
        return sums, counts
    neutral = _neutral(values.dtype, op)
    contrib = torch.where(vmask, values, torch.full((), neutral, dtype=values.dtype,
                                                    device=values.device))
    buf = torch.full(gshape, neutral, dtype=values.dtype, device=values.device)
    return (buf.scatter_reduce_(0, idx.reshape(vmask.shape).expand(values.shape), contrib,
                                reduce="amin" if op == "min" else "amax"),)


def _group_result(parts, op: str) -> torch.Tensor:
    if op != "mean":
        return parts[0]
    sums, counts = parts
    return sums / counts.reshape(counts.shape + (1,) * (sums.ndim - 1))  # empty: NaN


def _eager_groupby(keys: torch.Tensor, values, G: int, op: str) -> torch.Tensor:
    """heat_tpu's ``_eager_groupby`` (``data/ops.py:187``): the same
    mathematics on the logical arrays."""
    return _group_result(_group_partials(keys, values, G, op), op)


def groupby_agg(keys: DNDarray, num_groups: int, op: str, values: DNDarray = None) -> DNDarray:
    """Distributed groupby-aggregate (heat_tpu ``data/ops.py:220``): ``keys``
    (1-D integers; rows whose key lies outside ``[0, num_groups)`` are
    dropped) bucket ``values`` (1-D or 2-D, row-aligned) into a REPLICATED
    ``(num_groups, ...)`` result. Empty groups: sum and count 0, mean NaN,
    min and max the identity (±inf, the integer extreme). ``mean`` is
    float64, ``count`` int64. Split 0: each rank folds its rows, then one
    all-reduce (a ``packed_all_reduce`` for sum, mean and count, an
    ``all_reduce`` for min and max)."""
    if op not in AGGS:
        raise ValueError(f"unknown groupby aggregation {op!r}")
    if keys.ndim != 1:
        raise ValueError("groupby keys must be 1-D")
    kdt = keys.larray.dtype
    if kdt.is_floating_point or kdt.is_complex or kdt == torch.bool:
        raise TypeError("groupby keys must be integers")
    G = int(num_groups)
    if G <= 0:
        raise ValueError("num_groups must be positive")
    n = int(keys.shape[0])
    if op != "count":
        if values is None:
            raise ValueError(f"groupby agg {op!r} needs values")
        if values.ndim not in (1, 2) or int(values.shape[0]) != n:
            raise ValueError("groupby values must be (n,) or (n, d) row-aligned with keys")
        if values.larray.dtype == torch.bool:
            # heat_tpu's errors: a bool sum is refused by jax's add, a bool
            # min/max by the integer extremes its identity needs (torch would
            # add bools as a logical or)
            if op == "sum":
                raise TypeError("groupby sum does not accept dtype bool")
            if op in ("min", "max"):
                raise ValueError(f"groupby {op} has no identity for dtype bool")
        if values.split != keys.split:
            values = values.resplit(keys.split)
    metrics.inc("data_engine.groupby_calls")
    comm = keys.comm

    def eager(*_):
        return _eager_groupby(keys._logical(), None if values is None else values._logical(),
                              G, op)

    if engine.enabled() and keys.split == 0:
        def body(kp, *vp):
            parts = _group_partials(kp, vp[0] if vp else None, G, op)
            if op in ("min", "max"):
                parts = (comm.Allreduce(parts[0], op),)
            else:
                parts = fusion.packed_psum(parts, comm)
            return _group_result(parts, op)

        args = (keys.larray,) + (() if values is None else (values.larray,))
        key = ("data.groupby", tuple(tuple(a.shape) for a in args),
               tuple(str(a.dtype) for a in args), n, G, op, fusion._comm_key(comm),
               str(args[0].device))
        res = engine.engine_call(key, lambda qk, ck, hk: body, args, eager)
    else:
        res = eager()
    return _replicated(res, keys)


class GroupBy:
    """``groupby(keys, num_groups)``: ``.agg(op, values)`` and the named
    shorthands (heat_tpu ``data/ops.py:270``)."""

    def __init__(self, keys: DNDarray, num_groups: int):
        self.keys = keys
        self.num_groups = int(num_groups)

    def agg(self, op: str, values: DNDarray = None) -> DNDarray:
        return groupby_agg(self.keys, self.num_groups, op, values)

    def sum(self, values):
        return self.agg("sum", values)

    def mean(self, values):
        return self.agg("mean", values)

    def count(self):
        return self.agg("count")

    def min(self, values):
        return self.agg("min", values)

    def max(self, values):
        return self.agg("max", values)


def groupby(keys: DNDarray, num_groups: int) -> GroupBy:
    return GroupBy(keys, num_groups)


# ---------------------------------------------------------------------- #
# top-k                                                                  #
# ---------------------------------------------------------------------- #
def _selection_key(x: torch.Tensor, largest: bool):
    """int64 keys whose descending order is the order top-k picks in
    (heat_tpu's ``unsigned_key``, or its complement for the smallest), and
    the dtype of the order key they widen."""
    k = signed_key(x)
    sel = k.to(torch.int64)
    return (sel if largest else ~sel), k.dtype


def _decode_selection(sel: torch.Tensor, largest: bool, kdt, dtype) -> torch.Tensor:
    return decode_key((sel if largest else ~sel).to(kdt), dtype)


def _best_k(sel: torch.Tensor, pos: torch.Tensor, k: int):
    """The ``k`` entries first in (``sel`` descending, ``pos`` ascending)
    order (heat_tpu's ``jnp.lexsort((pos, ~sel))[:k]``)."""
    o = torch.argsort(pos, stable=True)
    o = o[torch.argsort(sel[o], descending=True, stable=True)[:k]]
    return sel[o], pos[o]


def _eager_topk(full: torch.Tensor, k: int, largest: bool):
    """heat_tpu's ``_eager_topk`` (``data/ops.py:341``) on the logical array."""
    sel, _ = _selection_key(full, largest)
    o = torch.argsort(sel, descending=True, stable=True)[:k]
    return full[o], o


def topk(x: DNDarray, k: int, largest: bool = True):
    """Top-k of a 1-D array under the engine's total order (NaN greatest,
    after +inf; heat_tpu ``data/ops.py:350``). Returns REPLICATED
    ``(values, indices)`` ordered by value, then position: the rows a stable
    top-k of the gathered array picks, without gathering it. Split 0 with
    ``k`` at most the chunk: each rank's own top ``k``, then ONE
    ``packed_all_reduce`` of the (p, k) table of keys and positions."""
    if x.ndim != 1:
        raise ValueError("topk expects a 1-D array")
    n = int(x.shape[0])
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for {n} elements")
    if not _orderable(x.larray.dtype):
        raise TypeError(f"topk: unordered dtype {x.dtype}")
    metrics.inc("data_engine.topk_calls")
    comm = x.comm

    def eager(*_):
        return _eager_topk(x._logical(), k, largest)

    if engine.enabled() and x.split == 0 and k <= comm.chunk_size(n):
        off = comm.counts_displs(n)[1][comm.rank]

        def body(xp):
            sel, kdt = _selection_key(xp, largest)
            o = torch.argsort(sel, descending=True, stable=True)[:k]
            sv, sp = sel[o], o + off
            if comm.size > 1:
                # a rank holding fewer than k rows fills with entries that
                # sort after every row (heat_tpu's pos = n, key 0)
                pad = k - sv.shape[0]
                sv = torch.cat([sv, sv.new_full((pad,), torch.iinfo(torch.int64).min)])
                sp = torch.cat([sp, sp.new_full((pad,), n)])
                bs = sv.new_zeros((comm.size, k))
                bp = sp.new_zeros((comm.size, k))
                bs[comm.rank], bp[comm.rank] = sv, sp
                bs, bp = fusion.packed_psum([bs, bp], comm)
                sv, sp = _best_k(bs.reshape(-1), bp.reshape(-1), k)
            return _decode_selection(sv, largest, kdt, xp.dtype), sp

        key = ("data.topk", tuple(x.larray.shape), str(x.larray.dtype), n, k, bool(largest),
               fusion._comm_key(comm), str(x.larray.device))
        vals, pos = engine.engine_call(key, lambda qk, ck, hk: body, (x.larray,), eager)
    else:
        vals, pos = eager()
    return _replicated(vals, x), _replicated(pos, x)


# ---------------------------------------------------------------------- #
# hash join (inner, integer keys)                                        #
# ---------------------------------------------------------------------- #
def _rows(*cols: torch.Tensor) -> torch.Tensor:
    """Row-aligned 1-D columns as one (n, bytes) uint8 table."""
    n = cols[0].shape[0]
    return torch.cat([c.contiguous().view(torch.uint8).reshape(n, c.element_size())
                      for c in cols], dim=1)


def _columns(rows: torch.Tensor, dtypes):
    """The inverse of :func:`_rows`."""
    out, at = [], 0
    for dt in dtypes:
        w = dt.itemsize
        out.append(rows[:, at:at + w].contiguous().view(dt).reshape(-1))
        at += w
    return out


def _partition(keys: torch.Tensor, vals: torch.Tensor, cap: int, p: int) -> torch.Tensor:
    """This rank's rows as a (p, cap · row bytes) send table: block ``d``
    holds, in row order, the rows whose key ``% p`` is ``d``; negative keys
    are dropped and unused slots carry key -1 (heat_tpu's static-capacity
    partition, ``data/ops.py:509-524``; a rank holds at most ``cap`` rows)."""
    valid = keys >= 0
    dest = torch.where(valid, keys % p, torch.full_like(keys, p)).to(torch.int64)
    order = torch.argsort(dest, stable=True)
    sd = dest[order]
    slot = torch.arange(sd.shape[0], device=keys.device) - torch.searchsorted(sd, sd)
    keep = sd < p
    flat = (sd * cap + slot)[keep]
    tk = keys.new_full((p * cap,), -1)
    tv = vals.new_zeros((p * cap,))
    tk[flat] = keys[order][keep]
    tv[flat] = vals[order][keep]
    return _rows(tk, tv).reshape(p, cap * (keys.element_size() + vals.element_size()))


def _probe(lk: torch.Tensor, rk: torch.Tensor, rv: torch.Tensor):
    """Each left key's match in the right side (heat_tpu ``data/ops.py:530-535``):
    ``found`` and the matched right values (garbage where not found)."""
    lk, rk = lk.to(torch.int64), rk.to(torch.int64)
    ordr = torch.argsort(rk, stable=True)
    srk, srv = rk[ordr], rv[ordr]
    if srk.shape[0] == 0:
        return torch.zeros_like(lk, dtype=torch.bool), rv.new_zeros(lk.shape)
    idx = torch.searchsorted(srk, lk)
    idxc = idx.clamp(max=srk.shape[0] - 1)
    found = (idx < srk.shape[0]) & (srk[idxc] == lk) & (lk >= 0)
    return found, srv[idxc]


def _eager_join(lk, lv, rk, rv, p: int):
    """heat_tpu's ``_eager_join`` (``data/ops.py:578``) on the logical
    arrays: the matched left rows ordered by (key % p, position)."""
    found, mrv = _probe(lk, rk, rv)
    order = torch.argsort(lk % p, stable=True)
    sel = order[found[order]]
    return lk[sel], lv[sel], mrv[sel]


def _overlap(a0: int, a1: int, b0: int, b1: int) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def _join_exchange(lk, lv, rk, rv, n_l: int, n_r: int, comm):
    """The engine route of :func:`join` on this rank's shards: the hash
    partition of both sides in ONE ``all_to_all``, the probe of the
    received right bucket, ONE ``all_reduce`` of the per-rank match counts
    (read on the host: the result's length) and ONE ``all_to_all`` that
    sends each match to its slot of the split-0 result. Returns this rank's
    shard of (keys, left values, right values) and the length."""
    p = comm.size
    if p == 1:
        found, mrv = _probe(lk, rk, rv)
        return lk[found], lv[found], mrv[found], int(found.sum())
    cl, cr = comm.chunk_size(n_l), comm.chunk_size(n_r)
    wl = lk.element_size() + lv.element_size()
    wr = rk.element_size() + rv.element_size()
    msg = torch.cat([_partition(lk, lv, cl, p), _partition(rk, rv, cr, p)], dim=1)
    got = comm.Alltoall(msg.unsqueeze(1), 0, 1, p)[0]  # row s: rank s's block for this rank
    bk, bv = _columns(got[:, :cl * wl].reshape(p * cl, wl), (lk.dtype, lv.dtype))
    found, mrv = _probe(bk, *_columns(got[:, cl * wl:].reshape(p * cr, wr),
                                       (rk.dtype, rv.dtype)))
    counts = torch.zeros(p, dtype=torch.int64, device=lk.device)
    counts[comm.rank] = found.sum()
    counts = comm.Allreduce(counts).tolist()  # the one host read
    M = int(sum(counts))
    if M == 0:
        return lk[:0], lv[:0], rv[:0], 0
    # this rank's matches fill [starts[me], starts[me + 1]) of the result
    starts = np.cumsum([0] + counts)
    out_counts, out_displs = comm.counts_displs(M)
    me = comm.rank
    send = [_overlap(starts[me], starts[me + 1], d0, d0 + c)
            for d0, c in zip(out_displs, out_counts)]
    lo, hi = out_displs[me], out_displs[me] + out_counts[me]
    recv = [_overlap(starts[s], starts[s + 1], lo, hi) for s in range(p)]
    rows = comm.Alltoallv(_rows(bk[found], bv[found], mrv[found]), send, recv)
    return tuple(_columns(rows, (lk.dtype, lv.dtype, rv.dtype))) + (M,)


def _summed_type(dtype: torch.dtype) -> torch.dtype:
    """The type of a sum over ``dtype`` (numpy's rule, which heat_tpu's
    compiled join follows when it routes the matches: ``data/ops.py:569``):
    bool and integers narrower than 64 bits widen to int64 (uint64 if
    unsigned)."""
    if dtype == torch.bool or (not dtype.is_floating_point and not dtype.is_complex
                               and dtype.itemsize < 8):
        return torch.int64 if dtype == torch.bool or dtype.is_signed else torch.uint64
    return dtype


def join(left_keys: DNDarray, left_values: DNDarray, right_keys: DNDarray,
         right_values: DNDarray):
    """Distributed inner hash join on NON-NEGATIVE integer keys (heat_tpu
    ``data/ops.py:595``). The right side is the build side and its keys must
    be unique (duplicate right keys give an unspecified pick). Returns
    split-0 ``(keys, left_values, right_values)`` of the matched rows,
    ordered by (key % p, left position); one host read fixes the length."""
    for a in (left_keys, left_values, right_keys, right_values):
        if a.ndim != 1:
            raise ValueError("join expects 1-D keys and 1-D values")
    for kk in (left_keys, right_keys):
        dt = kk.larray.dtype
        if dt.is_floating_point or dt.is_complex or not dt.is_signed:
            raise TypeError("join keys must be signed integers")
    n_l, n_r = int(left_keys.shape[0]), int(right_keys.shape[0])
    if int(left_values.shape[0]) != n_l or int(right_values.shape[0]) != n_r:
        raise ValueError("join values must be row-aligned with their keys")
    metrics.inc("data_engine.join_calls")
    comm = left_keys.comm
    sides = (left_keys, left_values, right_keys, right_values)
    if engine.enabled() and all(a.split == 0 for a in sides):
        out = _join_exchange(*(a.larray for a in sides), n_l, n_r, comm)
        M = out[3]
        engine.dispatched()
        # heat_tpu's routing sums the matches' one writer per slot, which
        # widens narrow types (its empty result keeps them)
        return tuple(DNDarray(t.to(_summed_type(t.dtype)) if M else t, (M,),
                              types.canonical_heat_type(_summed_type(t.dtype) if M else t.dtype),
                              0, left_keys.device, comm) for t in out[:3])
    kk, lv, rv = _eager_join(*(a._logical() for a in sides), comm.size)
    return tuple(DNDarray.from_global(t, 0, left_keys.device, comm, a.dtype)
                 for t, a in zip((kk, lv, rv), (left_keys, left_values, right_values)))
