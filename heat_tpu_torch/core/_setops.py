"""Distributed unique over the ranks (heat_tpu ``core/_setops.py``).

Three phases built on the merge-split network of :mod:`._sort`; none
gathers the array:

A. the network sort of the values (carrying their positions), then a
   one-element halo exchange marks each first occurrence, and one
   all-reduce counts the uniques ``U``: the ONE number the host must read,
   since the result's size depends on the data.
B. compaction: each element gets its target position as the sort key and
   one more network pass puts it there; counts come from differencing
   neighbouring first-occurrence positions (one more halo exchange).
C. inverse, on demand: each sorted element's unique rank is a prefix count
   of the marks; network-sorting the ranks by the original positions is a
   distributed scatter back to the input layout.

heat_tpu compacts to the front of its padded ``n``-layout and re-chunks the
``U`` uniques outside its programs. The port's layout has no padding, so
phase B keys the uniques straight into their ``U``-layout slots, rank by
rank, and the other elements into the gaps: the same one exclusive scan
(of two counts) and the same rounds, and each rank's block starts with its
shard of the result.

NaN follows elementwise ``!=`` (each NaN is its own unique), as torch's
``unique`` that the original Heat wraps.
"""

from __future__ import annotations

import torch

from ._sort import (_fill_to, _float_key_dtype, _float_sort_key, _merge_split_network,
                    _network_sort, _positions, _role_tables, _sentinel, batcher_rounds)

__all__ = ["distributed_unique", "distributed_unique_rows"]


def _plan(comm):
    rounds = batcher_rounds(comm.size)
    return rounds, _role_tables(rounds, comm.size)


def _network_row_sort(key_rows, payloads, rounds, roles, c, comm):
    """Merge-split network over blocks of ROWS, ordered lexicographically
    (heat_tpu ``_setops.py:52``): ``key_rows`` (c, K) integer key columns,
    column 0 most significant; ``payloads`` (c, ...) tensors moved with the
    rows. A lexsort is stable sorts from the least significant column up."""
    K = key_rows.shape[1]

    def merge(kr, pls):
        order = torch.arange(kr.shape[0], device=kr.device)
        for j in range(K - 1, -1, -1):
            o = torch.sort(kr[order, j], stable=True).indices
            order = order[o]
        return kr[order], tuple(q[order] for q in pls)

    return _merge_split_network(key_rows, payloads, rounds, roles, c, comm, merge, 0)


def _row_keys(rows, gpos, n):
    """(c, 1+w) lexsort keys of a (c, w) block of rows (heat_tpu
    ``_setops.py:77``): the fill flag (most significant, 0 = real row), then
    each column in a NaN-safe monotone integer encoding."""
    if rows.dtype.is_floating_point:
        enc = _float_sort_key(rows)
    elif rows.dtype == torch.bool:
        enc = rows.to(torch.int8)
    else:
        enc = rows
    flag = (gpos >= n).to(enc.dtype)[:, None]
    return torch.cat([flag, enc], dim=1)


def _halo_prev(xl, comm):
    """The previous rank's last element (row) before this block (rank 0:
    zeros, its first position is forced "first")."""
    pairs = [(i, i + 1) for i in range(comm.size - 1)]
    got = comm.Permute(xl[-1:].contiguous(), pairs, tuple(xl[-1:].shape))
    return torch.zeros_like(xl[-1:]) if got is None else got


def _first_marks(xl, gpos, n, comm):
    """Phase A's tail: the first-occurrence mask of the sorted block and the
    global count of uniques (one all-reduce, read on the host)."""
    prev = torch.cat([_halo_prev(xl, comm), xl[:-1]])
    differs = xl != prev
    if differs.ndim > 1:
        differs = differs.any(dim=1)
    mask = (gpos < n) & ((gpos == 0) | differs)
    total = comm.Allreduce(mask.sum().reshape(1))
    return mask, int(total.item())


def _target_keys(mask, c, n_unique, comm):
    """Phase B's sort keys: unique ``j`` goes to slot ``j mod cU`` of rank
    ``j div cU`` (``cU = ceil(U / p)``), its place in the U-layout; the
    other elements fill the slots left over, in order. One exclusive scan
    of (marked, unmarked) counts."""
    p = comm.size
    cu = comm.chunk_size(n_unique)
    m = mask.to(torch.int64)
    counts = torch.stack([m.sum(), (1 - m).sum()])
    offs = comm.Exscan(counts)
    j = offs[0] + torch.cumsum(m, 0) - 1  # unique rank of a marked element
    f = offs[1] + torch.cumsum(1 - m, 0) - 1  # filler rank of an unmarked one
    # rank r's block holds count_r uniques, then c - count_r filler slots
    ranks = torch.arange(p, dtype=torch.int64, device=mask.device)
    count_r = (n_unique - ranks * cu).clamp(0, cu)
    gaps = c - count_r
    gap_start = torch.cumsum(gaps, 0) - gaps
    gap_rank = torch.searchsorted(torch.cumsum(gaps, 0), f, right=True).clamp(max=p - 1)
    filler = gap_rank * c + count_r[gap_rank] + (f - gap_start[gap_rank])
    uniq = (j // max(cu, 1)) * c + j % max(cu, 1)
    return torch.where(mask, uniq, filler), max(0, min(cu, n_unique - comm.rank * cu))


def _counts(spos_s, mine, n, n_unique, comm):
    """Occurrences of each of this rank's ``mine`` uniques: the distance to
    the next unique's first sorted position (one halo exchange from the
    next rank), the last unique's to ``n``."""
    pairs = [(i + 1, i) for i in range(comm.size - 1)]
    got = comm.Permute(spos_s[:1].contiguous(), pairs, (1,))
    nxt_first = torch.zeros_like(spos_s[:1]) if got is None else got
    cu = comm.chunk_size(n_unique)
    j = comm.rank * cu + torch.arange(mine, dtype=torch.int64, device=spos_s.device)
    first = spos_s[:mine]
    nxt = torch.cat([first[1:], nxt_first])
    return torch.where(j < n_unique - 1, nxt - first, n - first)


def _inverse(gi, mask, c, lc, comm, rounds, roles):
    """Phase C (heat_tpu ``_setops.py:309``): the unique rank of each sorted
    element, network-sorted by its original position back to the input
    layout."""
    m = mask.to(torch.int64)
    offs = comm.Exscan(m.sum())
    rank = offs + torch.cumsum(m, 0) - 1
    _, (rank_s,) = _network_sort(gi, (rank,), rounds, roles, c, False, comm)
    return rank_s[:lc]


def distributed_unique(local: torch.Tensor, n: int, return_inverse: bool,
                       return_counts: bool, comm):
    """Distributed unique of a 1-D split array's shard ``local`` of ``n``
    elements (heat_tpu ``_setops.py:342``). Returns ``(U, uniques[,
    inverse][, counts])``: this rank's shards of the sorted uniques and of
    the counts in the canonical layout of ``U``, and of the int64 inverse
    in the input's layout."""
    if local.is_complex():
        raise TypeError("distributed unique of a complex array is not supported")
    c = comm.chunk_size(n)
    lc = local.shape[0]
    rounds, roles = _plan(comm)
    gpos = _positions(comm, c, local.device)
    if local.dtype.is_floating_point:
        # NaN-safe key order; the value payload keeps the raw floats for the
        # != neighbour compare, so every NaN still counts as its own unique
        kdt = _float_key_dtype(torch.float32 if local.dtype.itemsize < 4 else local.dtype)
        keys = _fill_to(_float_sort_key(local), c, torch.iinfo(kdt).max)
        _, (xl, gi) = _network_sort(keys, (_fill_to(local, c, 0), gpos), rounds, roles, c,
                                    False, comm)
    else:
        filled = _fill_to(local, c, _sentinel(local.dtype, False))
        xl, (gi,) = _network_sort(filled, (gpos,), rounds, roles, c, False, comm)
    mask, n_unique = _first_marks(xl, gpos, n, comm)
    keys, mine = _target_keys(mask, c, n_unique, comm)
    _, (vals_s, spos_s) = _network_sort(keys, (xl, gpos), rounds, roles, c, False, comm)
    out = [n_unique, vals_s[:mine]]
    if return_inverse:
        out.append(_inverse(gi, mask, c, lc, comm, rounds, roles))
    if return_counts:
        out.append(_counts(spos_s, mine, n, n_unique, comm))
    return tuple(out)


def distributed_unique_rows(local: torch.Tensor, n: int, return_inverse: bool,
                            return_counts: bool, comm):
    """Distributed unique ROWS of a 2-D split-0 array's shard ``local``
    (``n`` rows of width ``w``; heat_tpu ``_setops.py:172``): the network's
    lexicographic row sort, the halo row compare, the one count, the
    compaction. Returns as :func:`distributed_unique`, with (mine, w)
    uniques."""
    c = comm.chunk_size(n)
    lc = local.shape[0]
    rounds, roles = _plan(comm)
    gpos = _positions(comm, c, local.device)
    rows = torch.cat([local, local.new_zeros((c - lc,) + tuple(local.shape[1:]))])
    keys = _row_keys(rows, gpos, n)
    _, (xl, gi) = _network_row_sort(keys, (rows, gpos), rounds, roles, c, comm)
    mask, n_unique = _first_marks(xl, gpos, n, comm)
    tkeys, mine = _target_keys(mask, c, n_unique, comm)
    _, (vals_s, spos_s) = _network_row_sort(tkeys[:, None], (xl, gpos), rounds, roles, c,
                                            comm)
    out = [n_unique, vals_s[:mine]]
    if return_inverse:
        out.append(_inverse(gi, mask, c, lc, comm, rounds, roles))
    if return_counts:
        out.append(_counts(spos_s, mine, n, n_unique, comm))
    return tuple(out)
