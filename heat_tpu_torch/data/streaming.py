"""The data engine's folds over a stream of split-0 chunks (heat_tpu
``data/streaming.py``): ``stream_groupby``, ``stream_topk`` and the exact
``stream_quantile``.

Memory: one chunk and a small carry are resident — the (G,) group
partials, the k best candidates, or the (m · branch) bisection counts — so
a stream of 100M rows never lies whole on the card.

Collectives: folding a chunk is local to each rank (none); the ranks'
carries combine once at the end of a fold, in ONE all-reduce
(``packed_all_reduce`` for sums, counts and the top-k table,
``all_reduce`` for min and max), where heat_tpu reads its (p, ...) carry
to the host. ``stream_quantile`` combines once a pass.

Quantiles bisect ``branch`` ways: each pass counts the keys at or below a
grid of ``branch`` pivots a requested rank, then narrows each rank's key
interval by that factor on the host — ``ceil(bits / log2(branch))`` passes
(4 for float32, 8 for float64 at the default 256) converge every rank to
its EXACT order statistic, in the total order of :mod:`.ops`. The pivots
are heat_tpu's, computed on the unsigned line and moved onto the port's
signed keys (:func:`.ops.signed_key`).

Sources: a ``DataStream`` (re-read on each pass through ``iter_chunks``), a
list or tuple of split-0 ``DNDarray`` chunks, or a callable returning a
fresh iterator of them. ``stream_quantile`` needs a source it can re-read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fusion
from ..core.dndarray import DNDarray
from ..utils import metrics
from . import engine
from .ops import (AGGS, _KEY_TYPES, _decode_selection, _group_partials, _group_result,
                  _key_bits, _neutral, _orderable, _replicated, _selection_key, _best_k,
                  decode_key, signed_key)

__all__ = ["stream_groupby", "stream_topk", "stream_quantile"]

_INT64 = torch.iinfo(torch.int64)


def _chunk_iter(source, rows_per_chunk: int):
    if hasattr(source, "iter_chunks"):
        return source.iter_chunks(rows_per_chunk)
    if callable(source):
        return iter(source())
    return iter(source)


def _total_rows(source, rows_per_chunk: int) -> int:
    if hasattr(source, "shape"):
        return int(source.shape[0])
    if isinstance(source, (list, tuple)):
        return sum(int(c.shape[0]) for c in source)
    return sum(int(c.shape[0]) for c in _chunk_iter(source, rows_per_chunk))


def _col(t: torch.Tensor, col) -> torch.Tensor:
    """The value column of a chunk's shard (a 1-D chunk as it is)."""
    return t if t.ndim == 1 else t[:, col]


def _folded(dispatch: bool = True) -> None:
    """Count one chunk folded (and, on the engine route, the dispatch
    heat_tpu makes for it)."""
    metrics.inc("data_engine.stream_chunks")
    if dispatch and engine.enabled():
        engine.dispatched()


# ---------------------------------------------------------------------- #
# streaming groupby                                                      #
# ---------------------------------------------------------------------- #
def stream_groupby(source, num_groups: int, op: str = "sum", key_col: int = 0,
                   value_col: int = 1, rows_per_chunk: int = 1 << 16) -> DNDarray:
    """Groupby-aggregate over a stream of 2-D split-0 chunks (heat_tpu
    ``data/streaming.py:148``): column ``key_col`` holds the group ids
    (truncated to integers), ``value_col`` the measure. One pass; resident
    memory one chunk and the (G,) carry. The semantics of
    :func:`.ops.groupby_agg`; the result is replicated."""
    if op not in AGGS:
        raise ValueError(f"unknown groupby aggregation {op!r}")
    G = int(num_groups)
    if G <= 0:
        raise ValueError("num_groups must be positive")
    metrics.inc("data_engine.groupby_calls")
    carry = like = None
    for chunk in _chunk_iter(source, rows_per_chunk):
        if chunk.ndim != 2 or chunk.split != 0:
            raise ValueError("stream_groupby needs split-0 2-D chunks")
        cl = chunk.larray
        parts = _group_partials(cl[:, key_col].to(torch.int64),
                                None if op == "count" else cl[:, value_col], G, op)
        if carry is None:
            like = chunk
            if op in ("min", "max"):
                carry = [torch.full_like(t, _neutral(t.dtype, op)) for t in parts]
            else:
                carry = [torch.zeros_like(t) for t in parts]
        if op == "min":
            carry = [torch.minimum(c, t) for c, t in zip(carry, parts)]
        elif op == "max":
            carry = [torch.maximum(c, t) for c, t in zip(carry, parts)]
        else:
            carry = [c + t for c, t in zip(carry, parts)]
        _folded()
    if carry is None:
        raise ValueError("stream_groupby: empty stream")
    comm = like.comm
    if op in ("min", "max"):
        carry = [comm.Allreduce(carry[0], op)]
    else:
        carry = fusion.packed_psum(carry, comm)
    return _replicated(_group_result(carry, op), like)


# ---------------------------------------------------------------------- #
# streaming top-k                                                        #
# ---------------------------------------------------------------------- #
def stream_topk(source, k: int, largest: bool = True, col=None, rows_per_chunk: int = 1 << 16):
    """Top-k over a stream of split-0 chunks, 1-D or 2-D with ``col``
    (heat_tpu ``data/streaming.py:290``): positions index the stream's rows.
    Resident memory one chunk and the k candidates; the total order of
    :func:`.ops.topk`. Returns replicated ``(values, indices)``."""
    k = int(k)
    if k < 1:
        raise ValueError("k must be positive")
    metrics.inc("data_engine.topk_calls")
    sel = pos = like = kdt = dtype = None
    offset = 0
    for chunk in _chunk_iter(source, rows_per_chunk):
        if chunk.split != 0:
            raise ValueError("stream_topk needs split-0 chunks")
        if not _orderable(chunk.larray.dtype):
            raise TypeError(f"stream_topk: unordered dtype {chunk.dtype}")
        comm = chunk.comm
        n_chunk = int(chunk.shape[0])
        s, kdt = _selection_key(_col(chunk.larray, col), largest)
        if sel is None:
            like, dtype = chunk, chunk.larray.dtype
            sel, pos = s[:0], s[:0]
        first = offset + comm.counts_displs(n_chunk)[1][comm.rank]
        sel, pos = _best_k(torch.cat([sel, s]),
                          torch.cat([pos, first + torch.arange(s.shape[0], device=s.device)]), k)
        _folded(k <= comm.chunk_size(n_chunk))
        offset += n_chunk
    if sel is None:
        raise ValueError("stream_topk: empty stream")
    if k > offset:
        raise ValueError(f"k={k} out of range for {offset} rows")
    comm = like.comm
    if comm.size > 1:
        # the ranks' candidates in one table; a rank with fewer than k fills
        # with entries that sort after every row (heat_tpu's carry fill)
        pad = k - sel.shape[0]
        bs = sel.new_zeros((comm.size, k))
        bp = pos.new_zeros((comm.size, k))
        bs[comm.rank] = torch.cat([sel, sel.new_full((pad,), _INT64.min)])
        bp[comm.rank] = torch.cat([pos, pos.new_full((pad,), _INT64.max)])
        bs, bp = fusion.packed_psum([bs, bp], comm)
        sel, pos = _best_k(bs.reshape(-1), bp.reshape(-1), k)
    return (_replicated(_decode_selection(sel, largest, kdt, dtype), like),
            _replicated(pos, like))


# ---------------------------------------------------------------------- #
# streaming quantile                                                     #
# ---------------------------------------------------------------------- #
def stream_quantile(source, q, col=None, rows_per_chunk: int = 1 << 16,
                    interpolation: str = "linear", branch: int = 256):
    """EXACT quantiles (``q`` in [0, 1], a scalar or a sequence) of a
    stream by multi-pass ``branch``-way bisection (heat_tpu
    ``data/streaming.py:394``): ``ceil(bits / log2(branch))`` passes over
    the source, resident memory one chunk and the count carry. A NaN
    anywhere makes every result NaN (numpy's rule). Returns a python float
    for a scalar ``q``, else a float64 numpy array of ``q``'s shape."""
    q_np = np.asarray(q, dtype=np.float64)
    if q_np.size and not bool((q_np >= 0).all() and (q_np <= 1).all()):
        raise ValueError("Quantiles must be in the range [0, 1]")
    if interpolation not in ("linear", "lower", "higher", "nearest", "midpoint"):
        raise ValueError(f"unknown interpolation method {interpolation!r}")
    branch = max(int(branch), 2)
    metrics.inc("data_engine.quantile_calls")
    n = _total_rows(source, rows_per_chunk)
    if n <= 0:
        raise ValueError("stream_quantile: empty stream")
    # one chunk read for the type and the communicator, as heat_tpu reads it
    first = next(_chunk_iter(source, rows_per_chunk))
    comm, dtype = first.comm, first.larray.dtype
    if not _orderable(dtype):
        raise TypeError(f"stream_quantile: unordered dtype {first.dtype}")
    floating = dtype.is_floating_point
    del first
    bits = _key_bits(dtype)
    kdt = _KEY_TYPES[bits]
    half = 1 << (bits - 1)  # the unsigned line's key u is the signed key u - half
    umax = (1 << bits) - 1
    targets = []
    for qv in q_np.reshape(-1):
        f = (n - 1) * float(qv)
        lo_r, hi_r = int(np.floor(f)), int(np.ceil(f))
        if interpolation == "lower":
            need = (lo_r,)
        elif interpolation == "higher":
            need = (hi_r,)
        elif interpolation == "nearest":
            need = (int(np.round(f)),)
        else:
            need = (lo_r, hi_r)
        targets.append((f, lo_r, hi_r, need))
    ranks = sorted({r for _, _, _, need in targets for r in need})
    m = len(ranks)
    lo, hi = [0] * m, [umax] * m
    nan_total = None
    passes = 0
    while any(lo[i] < hi[i] for i in range(m)) or nan_total is None:
        grids = []
        for i in range(m):
            width = hi[i] - lo[i] + 1
            grid = sorted({max(lo[i] + (j * width) // branch - 1, lo[i])
                           for j in range(1, branch + 1)} | {hi[i]})
            grids.append((grid + [hi[i]] * branch)[:branch])
        pivots = None
        counts = nans = None
        for chunk in _chunk_iter(source, rows_per_chunk):
            if chunk.split != 0:
                raise ValueError("stream_quantile needs split-0 chunks")
            v = _col(chunk.larray, col)
            if pivots is None:
                pivots = torch.tensor([u - half for g in grids for u in g],
                                      dtype=torch.int64, device=v.device).to(kdt)
                counts = torch.zeros(m * branch, dtype=torch.int64, device=v.device)
                nans = torch.zeros(1, dtype=torch.int64, device=v.device)
            keys = torch.sort(signed_key(v).reshape(-1)).values
            counts += torch.searchsorted(keys, pivots, right=True)
            if floating:
                nans += torch.isnan(v).sum()
            _folded()
        counts, nans = fusion.packed_psum([counts, nans], comm)
        counts = counts.cpu().numpy().reshape(m, branch)
        if nan_total is None:
            nan_total = int(nans.item())
        for i in range(m):
            if lo[i] >= hi[i]:
                continue
            j = int(np.argmax(counts[i] >= ranks[i] + 1))
            hi[i] = grids[i][j]
            lo[i] = (grids[i][j - 1] + 1) if j > 0 else lo[i]
        passes += 1
        if passes > bits:  # one pass a bit at the least
            raise RuntimeError("stream_quantile failed to converge")
    picked = decode_key(torch.tensor([u - half for u in lo], dtype=torch.int64).to(kdt), dtype)
    vals = picked.to(torch.float64).numpy()
    by_rank = {r: vals[i] for i, r in enumerate(ranks)}
    ft = np.float64
    out = []
    for f, lo_r, hi_r, _ in targets:
        if interpolation == "lower":
            r = ft(by_rank[lo_r])
        elif interpolation == "higher":
            r = ft(by_rank[hi_r])
        elif interpolation == "nearest":
            r = ft(by_rank[int(np.round(f))])
        elif interpolation == "midpoint":
            r = (ft(by_rank[lo_r]) + ft(by_rank[hi_r])) / 2
        else:
            a = ft(by_rank[lo_r])
            r = a if hi_r == lo_r else a + (ft(by_rank[hi_r]) - a) * ft(f - lo_r)
        if floating and nan_total:
            r = ft(np.nan)
        out.append(r)
    if q_np.ndim == 0:
        return float(out[0])
    return np.asarray(out, ft).reshape(q_np.shape)
