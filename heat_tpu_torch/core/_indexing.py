"""Advanced indexing along the split axis as ring programs (heat_tpu
``core/_indexing.py``).

heat_tpu's module names the defect these programs remove: one fancy index
must not be a full gather. The data (or the index/value pairs) rotate
around the ranks in ``p - 1`` ring steps, and each rank keeps or applies
the rows whose global position falls in its range: O(chunk) memory, no
logical array anywhere.

- :func:`ring_gather` — ``x[idx]`` by integer positions along the split axis
  (any order, repeats allowed): the data shards rotate.
- :func:`mask_positions` and :func:`ring_compress` — ``x[mask]``: each kept
  row's output slot is a distributed prefix count (one exclusive scan, one
  all-reduce of the count, which the host reads: the output's length), and
  the (row, slot) pairs rotate as one message per step.
- :func:`ring_scatter` — ``x[idx] = values``: the (index, value-row) pairs
  rotate as one message per step, and each rank applies the writes that
  land in its rows. Duplicate indices resolve in rotation order, as
  heat_tpu's do (``_indexing.py:19-21``): rank ``r`` applies the block of
  rank ``r``, then ``r - 1``, ..., the last write wins; within one block
  the last occurrence wins.

heat_tpu shifts the data and the positions as two tensors per step; here
both travel as the bytes of one message, so each program makes ``p - 1``
ring steps.
"""

from __future__ import annotations

import torch

__all__ = []


def _pack(data: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One message: each row's bytes followed by its int64 key's bytes."""
    rows = data.shape[0]
    row_bytes = torch.Size(data.shape[1:]).numel() * data.element_size()
    body = data.contiguous().reshape(-1).view(torch.uint8).reshape(rows, row_bytes)
    tail = key.to(torch.int64).contiguous().view(torch.uint8).reshape(rows, 8)
    return torch.cat([body, tail], 1)


def _unpack(msg: torch.Tensor, dtype, rest):
    rows = msg.shape[0]
    body = msg[:, :-8].contiguous().reshape(-1).view(dtype).reshape((rows,) + tuple(rest))
    key = msg[:, -8:].reshape(-1).clone().view(torch.int64)  # a copy: 8-byte aligned
    return body, key


def ring_gather(local: torch.Tensor, axis: int, n: int, idx: torch.Tensor, comm,
                check: bool = False):
    """``x[idx]`` along the split axis ``axis`` (heat_tpu ``ring_gather_fn``
    ``:50``): ``local`` is this rank's shard of ``x`` (global length ``n``
    along ``axis``), ``idx`` this rank's chunk of the global positions
    (non-negative, in bounds). Returns the selected rows, ``len(idx)`` along
    ``axis``. p - 1 ring steps of the data shards.

    With ``check``, ``idx`` may hold positions out of range: each rank's
    verdict on its own chunk travels with its shard as one trailing byte,
    so every rank raises ``IndexError`` when any rank's chunk was out of
    range, as heat_tpu's program raises once."""
    c = comm.chunk_size(n)
    counts, _ = comm.counts_displs(n)
    buf = local.movedim(axis, 0)
    rest = tuple(buf.shape[1:])
    out = buf.new_zeros((idx.shape[0],) + rest)
    p, me = comm.size, comm.rank
    if check:
        bad = ((idx < 0) | (idx >= n)).any().reshape(1).to(torch.uint8)
        msg = torch.cat([_as_rows(buf, c).reshape(-1).view(torch.uint8), bad])
        seen = bad
    for k in range(p):
        owner = (me - k) % p
        rel = idx - owner * c
        hit = (rel >= 0) & (rel < counts[owner])
        out[hit] = buf[rel[hit]]
        if k < p - 1:
            if check:
                msg = comm.ring_step(msg)
                buf = msg[:-1].view(buf.dtype).reshape((c,) + rest)
                seen = seen | msg[-1:]
            else:
                buf = comm.ring_step(buf, width=c)
    if check and bool(seen):
        raise IndexError(f"index out of bounds for axis {axis} with size {n}")
    return out.movedim(0, axis)


def _as_rows(buf: torch.Tensor, rows: int) -> torch.Tensor:
    """``buf`` padded with zero rows to ``rows`` rows, contiguous."""
    if buf.shape[0] < rows:
        buf = torch.cat([buf, buf.new_zeros((rows - buf.shape[0],) + tuple(buf.shape[1:]))])
    return buf.contiguous()


def mask_positions(mask: torch.Tensor, comm):
    """``(pos, m)`` for this rank's chunk of a split-axis mask (heat_tpu
    ``mask_positions_fn`` ``:87``): the output slot of each kept row (-1
    where the mask is False), from ONE exclusive scan of the ranks' counts,
    and the global number kept from ONE all-reduce, read on the host."""
    kept = mask.to(torch.int64)
    cnt = kept.sum().reshape(1)
    offs = comm.Exscan(cnt)
    total = comm.Allreduce(cnt.clone())
    pos = torch.where(mask, offs + torch.cumsum(kept, 0) - 1, torch.full_like(kept, -1))
    return pos, int(total.item())


def ring_compress(local: torch.Tensor, axis: int, width: int, pos: torch.Tensor, m: int,
                  comm):
    """``x[mask]`` along the split axis (heat_tpu ``ring_compress_fn``
    ``:114``): the rows and their output slots ``pos`` (from
    :func:`mask_positions`) rotate as one message, ``width`` rows long on
    the wire (the longest shard); each rank keeps the rows whose slot
    falls in its chunk of the ``m`` outputs. p - 1 ring steps."""
    buf = local.movedim(axis, 0)
    rest = tuple(buf.shape[1:])
    c_out = comm.chunk_size(m)
    lo, hi = min(comm.rank * c_out, m), min((comm.rank + 1) * c_out, m)
    out = buf.new_zeros((hi - lo,) + rest)
    # slots travel as pos + 1, so a row the wire pads with zeros keeps none
    msg = _pack(buf, pos + 1)
    for k in range(comm.size):
        data, slot = _unpack(msg, buf.dtype, rest)
        hit = (slot > lo) & (slot <= hi)
        out[slot[hit] - 1 - lo] = data[hit]
        if k < comm.size - 1:
            msg = comm.ring_step(msg, width=width)
    return out.movedim(0, axis)


def ring_scatter(local: torch.Tensor, axis: int, n: int, idx: torch.Tensor,
                 values: torch.Tensor, m: int, comm):
    """``x[idx] = values`` along the split axis (heat_tpu
    ``ring_scatter_fn`` ``:169``): ``idx`` is this rank's chunk of the
    ``m`` global positions (non-negative), ``values`` its rows (index dim
    first, ``x``'s dtype). The pairs rotate as one message; each rank
    writes the ones that land in its rows into a copy of its shard, which
    it returns. p - 1 ring steps. Every rank sees every position, so a
    position out of range makes every rank raise ``IndexError``, and no
    rank's shard is written."""
    buf = local.movedim(axis, 0).clone()
    rest = tuple(buf.shape[1:])
    c_idx = comm.chunk_size(m)
    offset, lshape, _ = comm.chunk((n,), 0)
    rows = lshape[0]
    # keys: position + 1; 0 is a row the wire pads, -1 a position out of range
    key = torch.where((idx >= 0) & (idx < n), idx + 1, torch.full_like(idx, -1))
    msg = _pack(values.to(buf.dtype), key)
    bad = torch.zeros((), dtype=torch.bool, device=buf.device)
    for k in range(comm.size):
        vals, q = _unpack(msg, buf.dtype, rest)
        bad |= (q < 0).any()
        rel = q - 1 - offset
        hit = (q > 0) & (rel >= 0) & (rel < rows)
        tgt, src = rel[hit], vals[hit]
        if tgt.numel():
            # the last occurrence of a row in this block wins
            order = torch.arange(tgt.shape[0], device=tgt.device)
            last = torch.full((rows,), -1, dtype=torch.int64, device=tgt.device)
            last.scatter_reduce_(0, tgt, order, "amax")
            keep = last[tgt] == order
            buf[tgt[keep]] = src[keep]
        if k < comm.size - 1:
            msg = comm.ring_step(msg, width=c_idx)
    if bool(bad):
        raise IndexError(f"index out of bounds for axis {axis} with size {n}")
    return buf.movedim(0, axis)
