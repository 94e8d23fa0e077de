"""Distributed sort over the ranks: a block merge-split network (heat_tpu
``core/_sort.py``).

Every rank keeps exactly ``c = ceil(n / p)`` elements of the sort axis at
every step: its shard, filled up to ``c`` past its end. A comparator
``(i, j)`` of a sorting network becomes "merge the two sorted blocks; ``i``
keeps the lower half, ``j`` the upper", which by the 0-1 principle turns
any sorting network on ``p`` inputs into a sorter of ``p`` sorted blocks
(Knuth TAOCP 5.3.4). The network is Batcher's odd-even mergesort:
``O(log^2 p)`` rounds, each a disjoint set of pairwise exchanges, so each
round is ONE :meth:`TorchCommunication.Permute` carrying the key and its
payloads packed into one message. Nothing gathers the sort axis; memory is
O(c) per rank.

For ``p`` that is no power of two the network is built for the next one and
the comparators that touch a rank ``>= p`` are dropped: every comparator is
ascending, so the virtual blocks, full of the ascending sentinel, never
leave the top positions. Ascending sorts fill past the shard with the
type's maximum (floats: an integer key above every value, NaN included), so
after the sort the fill lands in the trailing positions, and each rank's
first ``lshape`` elements are its shard of the sorted array again.

The rounds, the role tables, the sentinels, the float key and the merge
rule are heat_tpu's, so for the same ``(n, p)`` and inputs the values and
the indices are its, ties included.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["batcher_rounds", "distributed_sort", "distributed_flat_sort"]


def batcher_rounds(p: int) -> List[List[Tuple[int, int]]]:
    """Rounds of disjoint ascending comparator pairs ``(low, high)`` of
    Batcher's odd-even mergesort on ``p`` inputs (heat_tpu ``_sort.py:46``,
    copied).

    Built for the next power of two ``P >= p``; comparators touching an
    index ``>= p`` are dropped (no-ops on virtual sentinel blocks, see
    module docstring). Pairs within one round are disjoint, so each round
    is a single permutation.
    """
    P = 1
    while P < p:
        P *= 2
    rounds: List[List[Tuple[int, int]]] = []
    ph = 1
    while ph < P:
        k = ph
        while k >= 1:
            pairs = []
            j = k % ph
            while j + k < P:
                for i in range(k):
                    a, b = i + j, i + j + k
                    if b < P and (a // (ph * 2)) == (b // (ph * 2)) and b < p:
                        pairs.append((a, b))
                j += 2 * k
            if pairs:
                rounds.append(pairs)
            k //= 2
        ph *= 2
    return rounds


def _role_tables(rounds, p):
    """Per-round rank roles (heat_tpu ``_sort.py:198``): 0 = bystander,
    1 = keeps low, 2 = keeps high."""
    tables = []
    for pairs in rounds:
        role = np.zeros(p, np.int32)
        for a, b in pairs:
            role[a], role[b] = 1, 2
        tables.append(role)
    return tables


def _sentinel(dtype: torch.dtype, descending: bool):
    """The value that sorts to the END of the requested order for ``dtype``
    (heat_tpu ``_sort.py:78``)."""
    if dtype.is_floating_point:
        return -float("inf") if descending else float("inf")
    if dtype == torch.bool:
        return not descending
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


def _float_key_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int64 if dtype.itemsize == 8 else torch.int32


def _float_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone integer encoding of a float tensor's total order (heat_tpu
    ``_sort.py:92``): ``-inf < … < -0.0 < +0.0 < … < +inf < NaN``, NaNs
    canonicalized first, all strictly below the integer maximum, which is
    therefore a safe fill key. bf16 and float16 widen to float32 (exact and
    monotone). Negative floats map through ``imax - b``, which wraps onto
    ``[imin, -1]`` in two's complement, as it does in XLA."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    idt = _float_key_dtype(x.dtype)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(idt)
    imax = torch.iinfo(idt).max
    return torch.where(b >= 0, b, imax - b)


def _sortable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor torch sorts in the same order: bool as uint8."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _pack(tensors) -> torch.Tensor:
    """One byte message of several tensors (the key and its payloads)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(msg: torch.Tensor, like) -> list:
    """The tensors of :func:`_pack`, shaped and typed as ``like``."""
    out, off = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        piece = msg[off:off + nb]
        if off % t.element_size():  # a view of wider elements needs their alignment
            piece = piece.clone()
        out.append(piece.view(t.dtype).view(t.shape))
        off += nb
    return out


def _merge_split_network(key, payloads, rounds, roles, c, comm, merge, block_axis):
    """The Batcher merge-split round loop (heat_tpu ``_sort.py:118``).

    ``merge(key, payloads) -> (key, payloads)`` sorts one (possibly doubled)
    block along ``block_axis`` (-1 for scalar keys, 0 for row keys). Each
    round exchanges blocks between the pairs ``(a, b)`` and ``(b, a)`` in ONE
    :meth:`TorchCommunication.Permute` of the packed key and payloads, and
    each side merges and keeps its half. Both sides of a pair merge the
    SAME sequence, low-index block first: under tied keys a stable sort of
    [own, recv] and of [recv, own] disagree, and the kept halves would no
    longer be complementary (tied payloads duplicated or dropped)."""
    key, payloads = merge(key, tuple(payloads))
    me = comm.rank
    for pairs, role in zip(rounds, roles):
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]
        tensors = (key,) + payloads
        msg = _pack(tensors)
        got = comm.Permute(msg, perm, tuple(msg.shape))
        myrole = int(role[me])
        if myrole == 0:
            continue
        recv = _unpack(got, tensors)
        ordered = [torch.cat([r, t] if myrole == 2 else [t, r], dim=block_axis)
                   for t, r in zip(tensors, recv)]
        both_k, both_p = merge(ordered[0], tuple(ordered[1:]))
        keep = slice(0, c) if myrole == 1 else slice(c, 2 * c)
        if block_axis == 0:
            key, payloads = both_k[keep], tuple(q[keep] for q in both_p)
        else:
            key, payloads = both_k[..., keep], tuple(q[..., keep] for q in both_p)
    return key, payloads


def _network_sort(key, payloads, rounds, roles, c, descending, comm, tie=None):
    """Merge-split network sort of this rank's block (heat_tpu
    ``_sort.py:162``).

    ``key``: (..., c) sort keys, the last axis the block of the sort axis;
    ``payloads``: same-shaped tensors sorted with the keys. ``tie``: an
    optional secondary key sorted ASCENDING within equal keys, which keeps
    the fill (tie 1) after real elements (tie 0) when the data holds the
    sentinel value itself, so no index points at the fill. Returns the
    sorted key block and the tuple of sorted payload blocks."""
    has_tie = tie is not None

    def merge(vals, pls):
        if has_tie:
            # lexicographic (key, tie): stable sort by the tie, then stable
            # sort by the key, the two permutations composed
            o2 = torch.sort(_sortable(pls[0]), dim=-1, stable=True).indices
            v2 = torch.gather(vals, -1, o2)
            o1 = torch.sort(_sortable(v2), dim=-1, descending=descending, stable=True).indices
            order = torch.gather(o2, -1, o1)
        else:
            order = torch.sort(_sortable(vals), dim=-1, descending=descending,
                               stable=True).indices
        return (torch.gather(vals, -1, order),
                tuple(torch.gather(q, -1, order) for q in pls))

    pls = ((tie,) if has_tie else ()) + tuple(payloads)
    key, pls = _merge_split_network(key, pls, rounds, roles, c, comm, merge, -1)
    return key, (pls[1:] if has_tie else pls)


def _fill_to(t: torch.Tensor, c: int, value) -> torch.Tensor:
    """``t`` extended along its last axis to ``c`` with ``value``."""
    short = c - t.shape[-1]
    if short <= 0:
        return t
    fill = torch.full(tuple(t.shape[:-1]) + (short,), value, dtype=t.dtype, device=t.device)
    return torch.cat([t, fill], dim=-1)


def _positions(comm, c: int, device) -> torch.Tensor:
    """This rank's global positions ``rank*c + [0, c)`` of a c-block layout."""
    return comm.rank * c + torch.arange(c, dtype=torch.int64, device=device)


def distributed_sort(local: torch.Tensor, axis: int, n: int, descending: bool, comm):
    """This rank's shard of ``(sorted values, global indices)`` of a split
    array sorted along its split axis ``axis`` of length ``n`` (heat_tpu
    ``distributed_sort_fn``, ``_sort.py:209``).

    Floats sort integer keys (:func:`_float_sort_key`) with the values as a
    payload, the fill keyed past every data key; exact types sort the
    values, filled with the sentinel, with the fill flag as the tie key.
    Indices are int64 positions along ``axis`` into the input."""
    p = comm.size
    c = comm.chunk_size(n)
    rounds = batcher_rounds(p)
    roles = _role_tables(rounds, p)
    xl = local.movedim(axis, -1)
    lc = xl.shape[-1]
    gpos = _positions(comm, c, local.device).expand(tuple(xl.shape[:-1]) + (c,)).contiguous()
    if local.dtype.is_floating_point:
        kdt = _float_key_dtype(torch.float32 if local.dtype.itemsize < 4 else local.dtype)
        info = torch.iinfo(kdt)
        keys = _fill_to(_float_sort_key(xl), c, info.min if descending else info.max)
        _, (xl, gi) = _network_sort(keys, (_fill_to(xl, c, 0), gpos), rounds, roles, c,
                                    descending, comm)
    else:
        filled = _fill_to(xl, c, _sentinel(local.dtype, descending))
        tie = (gpos >= n).to(torch.int8)
        xl, (gi,) = _network_sort(filled, (gpos,), rounds, roles, c, descending, comm, tie=tie)
    return (xl[..., :lc].movedim(-1, axis).contiguous(),
            gi[..., :lc].movedim(-1, axis).contiguous())


def flat_block(gshape, split: int, comm) -> int:
    """Elements in each rank's block of the flattened bag: the c-chunk of
    the split axis times the other axes (heat_tpu's ``local``)."""
    rest = int(np.prod([s for i, s in enumerate(gshape) if i != split], dtype=np.int64))
    return comm.chunk_size(gshape[split]) * rest


def distributed_flat_sort(local: torch.Tensor, gshape, split: int, fill, comm) -> torch.Tensor:
    """This rank's block of the ascending sort of a split array as a 1-D
    bag (heat_tpu ``distributed_flat_sort_fn``, ``_sort.py:265``): each rank
    flattens its shard, fills it to :func:`flat_block` elements with
    ``fill`` (which must sort last), and the network sorts the values
    themselves. The first ``size`` positions of the result, rank after rank,
    are the sorted data; only the multiset is meaningful, not any index."""
    m = flat_block(gshape, split, comm)
    rounds = batcher_rounds(comm.size)
    roles = _role_tables(rounds, comm.size)
    flat = _fill_to(local.reshape(-1), m, fill)
    out, _ = _network_sort(flat, (), rounds, roles, m, False, comm)
    return out
