"""Split-axis manipulations as scheduled block-window fetches (heat_tpu
``core/_manips.py``).

Each operation is a static source map along the split axis: output row
``go`` reads input row ``src(go)`` (or nothing). The map is monotone over a
few segments, so the rows a rank's output chunk needs span only a few
input blocks. Which input block each rank needs is computed on the host
from ``(n, p)`` alone (:func:`_demand_blocks`), and the (sender block →
receiver rank) demands are greedily colored into rounds in which no rank
sends or receives twice (:func:`_schedule_block_fetch`). Both are heat_tpu's
functions, copied. heat_tpu runs each round as one ``ppermute`` inside a
compiled program; here every rank runs the same plan eagerly, each round as
one :meth:`TorchCommunication.Permute`. Every rank reads and writes only its
own shard: O(chunk) memory, and no all-gather anywhere.

The port's shards are heat_tpu's canonical blocks without their padding
(ceil chunks, the tail on the last ranks), so for the same ``(n, p)`` the
plans, and the number of rounds, are heat_tpu's. At world size 1 every
operation is the local torch call of its caller, and this module is not
reached.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = []


def _demand_blocks(src_at, glo: int, ghi: int, p: int, c_out: int, c_in: int):
    """Per-output-rank lists of the source blocks needed (heat_tpu
    ``_manips.py:47``). ``src_at(go) -> int`` is the source-position map,
    monotone over the valid output interval ``[glo, ghi)``; each rank's
    needed source rows therefore form a contiguous range, read off the
    clamped endpoints."""
    demands = []
    for e in range(p):
        lo = max(e * c_out, glo)
        hi = min((e + 1) * c_out, ghi) - 1
        if lo > hi:
            demands.append([])
            continue
        s0, s1 = src_at(lo), src_at(hi)
        b0, b1 = sorted((s0 // c_in, s1 // c_in))
        b0, b1 = max(b0, 0), min(b1, p - 1)
        demands.append(list(range(b0, b1 + 1)))
    return demands


def _schedule_block_fetch(demands, p: int):
    """Greedy edge-coloring of the (sender block -> receiver rank) demand
    graph into rounds where every round is a partial permutation (heat_tpu
    ``_manips.py:69``). Returns ``[(perm_pairs, owner_table)]`` with
    ``owner_table[e]`` = the block rank ``e`` receives that round (-1:
    none)."""
    remaining = [list(s) for s in demands]
    rounds = []
    while any(remaining):
        used = set()
        perm = []
        table = np.full(p, -1, np.int64)
        progressed = False
        for e in range(p):
            for s in remaining[e]:
                if s not in used:
                    used.add(s)
                    perm.append((s, e))
                    table[e] = s
                    remaining[e].remove(s)
                    progressed = True
                    break
        if not progressed:  # cannot happen, but never loop forever
            break
        rounds.append((perm, table))
    return rounds


def _chunk(n: int, p: int) -> int:
    return -(-n // p) if n > 0 else 0


def _union(*demand_lists):
    return [sorted(set().union(*parts)) for parts in zip(*demand_lists)]


# ---------------------------------------------------------------------- #
# the plans: rounds for each operation from (lengths, p) alone            #
# ---------------------------------------------------------------------- #
@lru_cache(maxsize=256)
def plan_roll(n: int, shift: int, p: int):
    """``out[(g + shift) % n] = in[g]`` (heat_tpu ``ring_roll_fn`` ``:142``):
    two affine segments, the wrap and the rest."""
    c = _chunk(n, p)
    s = shift % n
    seg1 = _demand_blocks(lambda go: go - s + n, 0, min(s, n), p, c, c)
    seg2 = _demand_blocks(lambda go: go - s, s, n, p, c, c)
    return _schedule_block_fetch(_union(seg1, seg2), p)


@lru_cache(maxsize=256)
def plan_flip(n: int, p: int):
    """``out[n - 1 - g] = in[g]`` (heat_tpu ``ring_flip_fn`` ``:167``)."""
    c = _chunk(n, p)
    return _schedule_block_fetch(_demand_blocks(lambda go: n - 1 - go, 0, n, p, c, c), p)


@lru_cache(maxsize=256)
def plan_concat(ns: tuple, p: int):
    """One plan per input of a concatenation (heat_tpu ``ring_concat_fn``
    ``:186``): input ``i``'s rows shift by ``sum(ns[:i])``."""
    c_out = _chunk(sum(ns), p)
    plans, off = [], 0
    for n_i in ns:
        dem = _demand_blocks(lambda go, off=off: go - off, off, off + n_i, p, c_out,
                             _chunk(n_i, p))
        plans.append(_schedule_block_fetch(dem, p))
        off += n_i
    return plans


@lru_cache(maxsize=256)
def plan_repeat(n: int, rep: int, p: int):
    """Row ``g`` fans out to rows ``g*rep .. g*rep+rep-1`` (heat_tpu
    ``ring_repeat_fn`` ``:232``)."""
    return _schedule_block_fetch(
        _demand_blocks(lambda go: go // rep, 0, n * rep, p, _chunk(n * rep, p), _chunk(n, p)), p)


@lru_cache(maxsize=256)
def plan_slice(n: int, start: int, step: int, length: int, p: int):
    """``out[go] = in[start + go*step]`` for ``go < length`` (heat_tpu
    ``ring_slice_fn`` ``:255``)."""
    return _schedule_block_fetch(
        _demand_blocks(lambda go: start + go * step, 0, length, p, _chunk(length, p),
                       _chunk(n, p)), p)


def pad_src(go: torch.Tensor, n: int, before: int, mode: str) -> torch.Tensor:
    """The source rows of output rows ``go`` of a ``reflect``/``symmetric``/
    ``edge``/``wrap`` pad of an axis of length ``n`` (heat_tpu
    ``ring_pad_fn``'s ``src_py``), on ``go``'s device."""
    rel = go - before
    if mode == "edge":
        return rel.clamp(0, n - 1)
    if mode == "wrap":
        return rel % n
    if mode == "symmetric":
        r = rel % (2 * n)
        return torch.where(r < n, r, 2 * n - 1 - r)
    period = max(2 * n - 2, 1)  # reflect: no repeated edge
    r = rel % period
    return torch.where(r < n, r, period - r)


@lru_cache(maxsize=256)
def plan_pad(n: int, before: int, after: int, mode: str, p: int):
    """The boundary-sourcing pads, ``reflect``/``symmetric``/``edge``/
    ``wrap`` (heat_tpu ``ring_pad_fn`` ``:278``): each region (margin, body,
    margin) is piecewise monotone; its demands are read off its endpoints
    and the period's fold points (every row of a short interval)."""
    c_in = _chunk(n, p)
    n_out = n + before + after
    c_out = _chunk(n_out, p)
    regions = [(0, before), (before, before + n), (before + n, n_out)]
    demands = [set() for _ in range(p)]
    for glo, ghi in regions:
        for e in range(p):
            lo = max(e * c_out, glo)
            hi = min((e + 1) * c_out, ghi) - 1
            if lo > hi:
                continue
            if hi - lo < 4096:
                cand = set(range(lo, hi + 1))
            else:
                cand = {lo, hi}
                if mode in ("reflect", "symmetric", "wrap"):
                    period = {"reflect": max(2 * n - 2, 1), "symmetric": 2 * n, "wrap": n}[mode]
                    k0 = (lo - before) // period
                    k1 = (hi - before) // period + 1
                    for k in range(k0, k1 + 1):
                        for boundary in (before + k * period, before + k * period + n - 1,
                                         before + k * period + n):
                            if lo <= boundary <= hi:
                                cand.add(boundary)
            srcs = pad_src(torch.tensor(sorted(cand)), n, before, mode)
            b0, b1 = max(int(srcs.min()) // c_in, 0), min(int(srcs.max()) // c_in, p - 1)
            demands[e].update(range(b0, b1 + 1))
    return _schedule_block_fetch([sorted(d) for d in demands], p)


@lru_cache(maxsize=256)
def plan_diff(n: int, p: int):
    """``out[g] = in[g+1] - in[g]`` for ``g < n-1`` (heat_tpu
    ``split_diff_fn`` ``:365``): one plan serves both source maps."""
    c_in, c_out = _chunk(n, p), _chunk(n - 1, p)
    d1 = _demand_blocks(lambda go: go, 0, n - 1, p, c_out, c_in)
    d2 = _demand_blocks(lambda go: go + 1, 0, n - 1, p, c_out, c_in)
    return _schedule_block_fetch(_union(d1, d2), p)


@lru_cache(maxsize=256)
def plan_reshape(rows_in: int, row_in: int, rows_out: int, row_out: int, p: int):
    """A reshape of split-0 arrays re-chunks the row-major flat sequence
    (heat_tpu ``ring_reshape_fn`` ``:479``): the identity map over flat
    positions, each rank's flat range ``chunk·row`` long."""
    total = rows_out * row_out
    return _schedule_block_fetch(
        _demand_blocks(lambda f: f, 0, total, p, _chunk(rows_out, p) * row_out,
                       _chunk(rows_in, p) * row_in), p)


# ---------------------------------------------------------------------- #
# running a plan                                                          #
# ---------------------------------------------------------------------- #
def _my_rows(n: int, comm):
    """``(lo, hi)``: the global rows of this rank's chunk of ``n``."""
    c = comm.chunk_size(n)
    return min(comm.rank * c, n), min((comm.rank + 1) * c, n)


def _window_gather(buf, rounds, c_in: int, counts, comm, srcs, outs):
    """Apply scheduled block fetches (heat_tpu ``_window_gather`` ``:98``):
    ``outs[j][i] = buf_global[srcs[j][i]]`` along axis 0. ``buf`` is this
    rank's block (rank ``e`` holds rows ``[e*c_in, e*c_in + counts[e])``),
    ``srcs`` global source positions (-1: none). Each round is one
    :meth:`TorchCommunication.Permute`."""
    me = comm.rank
    rest = tuple(buf.shape[1:])
    for perm, table in rounds:
        owner = int(table[me])
        recv_shape = ((counts[owner],) if owner >= 0 else (0,)) + rest
        blk = comm.Permute(buf, perm, recv_shape)
        if owner < 0 or blk is None:
            continue
        for src, out in zip(srcs, outs):
            rel = src - owner * c_in
            hit = (src >= 0) & (rel >= 0) & (rel < counts[owner])
            out[hit] = blk[rel[hit]]
    return outs


def _run(local, axis: int, n_in: int, n_out: int, rounds, comm, make_srcs):
    """The common single-input window program: the split axis moved to the
    front, this rank's output rows ``go`` and their sources
    ``make_srcs(go)``, the gather, the axis moved back. Returns the list of
    gathered tensors, one per source map."""
    buf = local.movedim(axis, 0)
    lo, hi = _my_rows(n_out, comm)
    go = torch.arange(lo, hi, dtype=torch.int64, device=local.device)
    srcs = make_srcs(go)
    outs = [buf.new_zeros((hi - lo,) + tuple(buf.shape[1:])) for _ in srcs]
    counts, _ = comm.counts_displs(n_in)
    _window_gather(buf, rounds, comm.chunk_size(n_in), counts, comm, srcs, outs)
    return outs


def ring_roll(local, axis: int, n: int, shift: int, comm):
    """This rank's shard of ``roll`` along the split axis ``axis``."""
    s = shift % n
    out, = _run(local, axis, n, n, plan_roll(n, s, comm.size), comm,
                lambda go: [torch.where(go < s, go - s + n, go - s)])
    return out.movedim(0, axis)


def ring_flip(local, axis: int, n: int, comm):
    """This rank's shard of ``flip`` along the split axis."""
    out, = _run(local, axis, n, n, plan_flip(n, comm.size), comm, lambda go: [n - 1 - go])
    return out.movedim(0, axis)


def ring_repeat(local, axis: int, n: int, rep: int, comm):
    """This rank's shard of ``repeat`` by a scalar along the split axis."""
    out, = _run(local, axis, n, n * rep, plan_repeat(n, rep, comm.size), comm,
                lambda go: [go // rep])
    return out.movedim(0, axis)


def ring_slice(local, axis: int, n: int, start: int, step: int, length: int, comm):
    """This rank's shard of the split-axis selection ``start + go*step``,
    ``go < length``, re-chunked to the canonical layout."""
    out, = _run(local, axis, n, length, plan_slice(n, start, step, length, comm.size), comm,
                lambda go: [start + go * step])
    return out.movedim(0, axis)


def ring_pad(local, axis: int, n: int, before: int, after: int, mode: str, comm):
    """This rank's shard of a ``reflect``/``symmetric``/``edge``/``wrap``
    pad of the split axis."""
    out, = _run(local, axis, n, n + before + after,
                plan_pad(n, before, after, mode, comm.size), comm,
                lambda go: [pad_src(go, n, before, mode)])
    return out.movedim(0, axis)


def split_diff(local, axis: int, n: int, comm):
    """This rank's shard of the first difference along the split axis
    (``in[g+1] - in[g]``; bool: ``!=``), re-chunked to length ``n - 1``."""
    a, b = _run(local, axis, n, n - 1, plan_diff(n, comm.size), comm,
                lambda go: [go, go + 1])
    res = (b != a) if local.dtype == torch.bool else b - a
    return res.movedim(0, axis)


def ring_concat(locals_, axis: int, ns, comm):
    """This rank's shard of the concatenation of split arrays along their
    shared split axis: each input through its own plan into one output."""
    n_out = sum(ns)
    plans = plan_concat(tuple(ns), comm.size)
    first = locals_[0].movedim(axis, 0)
    lo, hi = _my_rows(n_out, comm)
    go = torch.arange(lo, hi, dtype=torch.int64, device=first.device)
    out = first.new_zeros((hi - lo,) + tuple(first.shape[1:]))
    off = 0
    for local, n_i, rounds in zip(locals_, ns, plans):
        src = torch.where((go >= off) & (go < off + n_i), go - off, torch.full_like(go, -1))
        counts, _ = comm.counts_displs(n_i)
        _window_gather(local.movedim(axis, 0), rounds, comm.chunk_size(n_i), counts, comm,
                       [src], [out])
        off += n_i
    return out.movedim(0, axis)


def ring_reshape(local, gshape_in, gshape_out, comm):
    """This rank's shard (split 0) of the reshape of a split-0 array: each
    rank's shard is one contiguous flat range, and the window fetch
    re-chunks the flat sequence."""
    row_in = int(np.prod(gshape_in[1:], dtype=np.int64))
    row_out = int(np.prod(gshape_out[1:], dtype=np.int64))
    rounds = plan_reshape(gshape_in[0], row_in, gshape_out[0], row_out, comm.size)
    flat = local.reshape(-1)
    lo, hi = _my_rows(gshape_out[0], comm)
    f = torch.arange(lo * row_out, hi * row_out, dtype=torch.int64, device=local.device)
    out = flat.new_zeros(f.shape)
    counts, _ = comm.counts_displs(gshape_in[0])
    _window_gather(flat, rounds, comm.chunk_size(gshape_in[0]) * row_in,
                   [c * row_in for c in counts], comm, [f], [out])
    return out.reshape((hi - lo,) + tuple(gshape_out[1:]))


# ---------------------------------------------------------------------- #
# top-k along the split axis                                              #
# ---------------------------------------------------------------------- #
def _total_order_key(v: torch.Tensor) -> torch.Tensor:
    """An integer key of ``lax.top_k``'s order: floats by IEEE total order
    (``-NaN < -inf < … < -0.0 < +0.0 < … < +inf < +NaN``, bf16 and float16
    widened exactly), integers as they are."""
    if not v.dtype.is_floating_point:
        return v
    if v.dtype in (torch.bfloat16, torch.float16):
        v = v.float()
    idt = torch.int64 if v.dtype == torch.float64 else torch.int32
    b = v.view(idt)
    return b ^ ((b >> (b.element_size() * 8 - 1)) & torch.iinfo(idt).max)


def topk_keyed(v: torch.Tensor, largest: bool) -> torch.Tensor:
    """heat_tpu's selection key (``_manips.py:443``): bool as int32,
    unsigned widened to a signed type, negated for the smallest (so a NaN
    comes first either way, and an integer minimum wraps as in XLA)."""
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    elif v.dtype == torch.uint8:
        v = v.to(torch.int32)
    return v if largest else -v


def topk_order(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``key`` along the last axis, in
    ``lax.top_k``'s order: descending, ties to the lower index (a stable
    descending sort of the total-order key; ``torch.topk`` leaves the order
    of ties undefined on the card)."""
    return torch.sort(_total_order_key(key), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def split_topk(local, axis: int, n: int, k: int, largest: bool, comm):
    """``(values, global indices)`` of the top ``k`` along the split axis,
    the same on every rank, shaped ``(..., k)`` with the split axis moved
    last (heat_tpu ``split_topk_fn``, ``_manips.py:414``): a local top-k
    over the shard filled to ``c`` with the sentinel, ONE all-gather of the
    ``p·min(k, c)`` candidate values and their positions packed as bytes,
    and a final top-k. heat_tpu gathers values and positions as two
    all-gathers."""
    p = comm.size
    c = comm.chunk_size(n)
    kk = min(k, c)
    buf = local.movedim(axis, -1)
    dt = buf.dtype
    if dt.is_floating_point:
        sentinel = -float("inf") if largest else float("inf")
    elif dt == torch.bool:
        sentinel = not largest
    else:
        info = torch.iinfo(dt)
        sentinel = info.min if largest else info.max
    lead = tuple(buf.shape[:-1])
    short = c - buf.shape[-1]
    if short:
        buf = torch.cat([buf, torch.full(lead + (short,), sentinel, dtype=dt,
                                         device=buf.device)], dim=-1)
    gpos = (comm.rank * c + torch.arange(c, dtype=torch.int64, device=buf.device)).expand(
        lead + (c,))
    li = topk_order(topk_keyed(buf, largest), kk)
    lv = torch.gather(buf, -1, li).contiguous()
    gi = torch.gather(gpos, -1, li).contiguous()
    vb, ib = lv.view(torch.uint8), gi.view(torch.uint8)
    both = comm.Allgather(torch.cat([vb, ib], dim=-1), axis=-1)
    both = both.reshape(lead + (p, vb.shape[-1] + ib.shape[-1]))
    cand_v = both[..., :vb.shape[-1]].contiguous().view(dt).reshape(lead + (p * kk,))
    cand_i = both[..., vb.shape[-1]:].contiguous().view(torch.int64).reshape(lead + (p * kk,))
    fi = topk_order(topk_keyed(cand_v, largest), k)
    return torch.gather(cand_v, -1, fi), torch.gather(cand_i, -1, fi)
