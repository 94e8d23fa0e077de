"""QR decomposition (heat_tpu ``core/linalg/qr.py``).

* split 0, at world size > 1: blockwise TSQR (``_tsqr``) when every rank's
  chunk has at least ``m`` rows (``n >= m·p``): each rank factors its rows,
  ONE all-gather stacks the small R factors, every rank factors the stack and
  multiplies its own block of that Q into its local Q. Otherwise the panel
  CAQR (``_caqr``): per panel of ``b`` columns one TSQR of the panel (one
  all-gather of the ``b × b`` R factors) and one all-reduce of its R rows.
* split 1, at world size > 1: the column-panel loop (``_split1_qr``): per
  panel ONE masked all-reduce brings the owner's block to every rank, which
  factors it and updates its own columns.
* otherwise one local ``torch.linalg.qr``.

A rank's shard is padded with zero rows (columns, for split 1) to the chunk
length, as heat_tpu's canonical layout pads, so every rank factors blocks of
the same shape.
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray

__all__ = ["qr"]

QR = collections.namedtuple("QR", "Q, R")


def _inexact(t: torch.Tensor) -> torch.Tensor:
    return t if (t.is_floating_point() or t.is_complex()) else t.to(torch.float64)


def qr(a: DNDarray, tiles_per_proc: int = 1, calc_q: bool = True,
       overwrite_a: bool = False) -> QR:
    """Reduced QR factorization ``a = Q @ R`` (heat_tpu ``qr.py:44``).
    ``tiles_per_proc`` is accepted for API parity and has no effect."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, got {type(a)}")
    if not isinstance(tiles_per_proc, int):
        raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
    if not isinstance(calc_q, bool):
        raise TypeError(f"calc_q must be a bool, got {type(calc_q)}")
    if not isinstance(overwrite_a, bool):
        raise TypeError(f"overwrite_a must be a bool, got {type(overwrite_a)}")
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    n, m = a.shape
    p = a.comm.size
    if a.split == 0 and p > 1 and n > 0 and m > 0:
        return _tsqr(a, calc_q) if n >= m * p else _caqr(a, calc_q)
    if a.split == 1 and p > 1 and n > 0 and m > 0:
        return _split1_qr(a, calc_q)
    q, r = torch.linalg.qr(_inexact(a._logical()), mode="reduced")
    q_d = DNDarray.from_global(q, a.split, a.device, a.comm) if calc_q else None
    r_d = DNDarray.from_global(r, 1 if a.split == 1 else None, a.device, a.comm)
    return QR(q_d, r_d)


def _padded_rows(a: DNDarray) -> torch.Tensor:
    """This rank's rows of a split-0 ``a``, zero-padded to the chunk length."""
    t = _inexact(a.larray)
    c = a.comm.chunk_size(a.shape[0])
    if t.shape[0] < c:
        t = torch.cat([t, t.new_zeros((c - t.shape[0],) + tuple(t.shape[1:]))])
    return t


def _tsqr(a: DNDarray, calc_q: bool) -> QR:
    """Two-level TSQR (heat_tpu ``qr.py:256``): one all-gather of the R
    factors (``:275``)."""
    comm = a.comm
    n, m = a.shape
    rows = a.larray.shape[0]
    q1, r1 = torch.linalg.qr(_padded_rows(a), mode="reduced")
    q2, r2 = torch.linalg.qr(comm.Allgather(r1.contiguous(), 0), mode="reduced")
    q_d = None
    if calc_q:
        q = q1 @ q2[comm.rank * m:(comm.rank + 1) * m]
        q_d = DNDarray(q[:rows].contiguous(), (n, m), types.canonical_heat_type(q.dtype), 0,
                       a.device, comm)
    return QR(q_d, DNDarray(r2, (m, m), types.canonical_heat_type(r2.dtype), None, a.device,
                            comm))


def _caqr(a: DNDarray, calc_q: bool) -> QR:
    """Right-looking panel CAQR for split-0 shapes TSQR cannot take
    (heat_tpu ``qr.py:82``): per panel one all-gather and one all-reduce."""
    comm = a.comm
    p, me = comm.size, comm.rank
    n, m = a.shape
    k = min(n, m)
    rows = a.larray.shape[0]
    ab = _padded_rows(a)
    c = ab.shape[0]
    b = min(c, k, 128)
    npan = -(-k // b)
    kpad = npan * b
    mpad = max(m, kpad)
    if mpad > m:
        ab = torch.cat([ab, ab.new_zeros((c, mpad - m))], dim=1)
    dev, dt = ab.device, ab.dtype
    gpos = comm.chunk((n,), 0)[0] + torch.arange(c, device=dev)
    rowvalid = (gpos < n)[:, None].to(dt)
    qb = ab.new_zeros((c, kpad))
    r_acc = ab.new_zeros((kpad, mpad))
    colid = torch.arange(mpad, device=dev)
    for j in range(npan):
        start = j * b
        q1, r1 = torch.linalg.qr(ab[:, start:start + b], mode="reduced")
        q2, _ = torch.linalg.qr(comm.Allgather(r1.contiguous(), 0), mode="reduced")
        qj = (q1 @ q2[me * b:(me + 1) * b]) * rowvalid
        s = comm.Allreduce(qj.conj().T @ ab)
        rmask = ((start + torch.arange(b, device=dev)) < k)[:, None]
        s = torch.where(rmask & (colid[None, :] >= start), s, 0)
        ab = ab - qj @ torch.where(colid[None, :] >= start + b, s, 0)
        qb[:, start:start + b] = qj
        r_acc[start:start + b] = s
    q_d = None
    if calc_q:
        q_d = DNDarray(qb[:rows, :k].contiguous(), (n, k), types.canonical_heat_type(dt), 0,
                       a.device, comm)
    r = torch.triu(r_acc[:k, :m])
    return QR(q_d, DNDarray(r, (k, m), types.canonical_heat_type(dt), None, a.device, comm))


def _split1_qr(a: DNDarray, calc_q: bool) -> QR:
    """Column-panel block Gram-Schmidt for split 1 (heat_tpu ``qr.py:167``):
    per panel one masked all-reduce of the owner's block (``:207``)."""
    comm = a.comm
    me = comm.rank
    n, m = a.shape
    k = min(n, m)
    c = comm.chunk_size(m)
    cols = a.larray.shape[1]
    ab = _inexact(a.larray)
    if cols < c:
        ab = torch.cat([ab, ab.new_zeros((n, c - cols))], dim=1)
    dt = ab.dtype
    npan = -(-k // c)
    q_acc = ab.new_zeros((n, c))
    r_acc = ab.new_zeros((npan * c, c))
    for j in range(npan):
        panel = comm.Allreduce(ab.clone() if me == j else torch.zeros_like(ab))
        qj, _ = torch.linalg.qr(panel, mode="reduced")
        if qj.shape[1] < c:  # wide corner n < c: the reduced Q is (n, n)
            qj = torch.cat([qj, qj.new_zeros((n, c - qj.shape[1]))], dim=1)
        panvalid = (j * c + torch.arange(c, device=ab.device)) < k
        qj = qj * panvalid[None, :].to(dt)
        rji = qj.conj().T @ ab
        if me == j:
            rji = torch.triu(rji)
        if j > me:
            rji = torch.zeros_like(rji)
        ab = ab - qj @ rji
        if me == j:
            q_acc = qj
        r_acc[j * c:(j + 1) * c] = rji
    ht_dt = types.canonical_heat_type(dt)
    r_d = DNDarray(r_acc[:k, :cols].contiguous(), (k, m), ht_dt, 1, a.device, comm)
    q_d = None
    if calc_q:
        q_full = DNDarray(q_acc[:, :cols].contiguous(), (n, m), ht_dt, 1, a.device, comm)
        q_d = q_full if k == m else q_full[:, :k]
    return QR(q_d, r_d)
