"""Distributed Gauss-Jordan inverse and determinant (heat_tpu
``core/linalg/_gauss.py``).

The row-split augmented matrix ``[A | I]`` is eliminated one pivot column
at a time, each rank on its own rows. Per pivot, two masked all-reduces:

1. the partial pivot: each rank writes its best candidate (``|value|`` and
   global row) into its own slot of a ``2p`` vector, summed over the ranks;
   every rank then takes heat_tpu's choice (the largest value, and of equal
   ones the highest global row, heat_tpu's two ``pmax``);
2. the pivot row and row ``k`` (heat_tpu's two masked ``psum``\\ s,
   ``_gauss.py:71-74``), packed into one sum.

Then swap, normalize and eliminate locally. Memory is O(n²/p) a rank; the
matrix is never gathered. The determinant is ``sign · prod(pivots)``, and
``(logabsdet, sign)`` latch to ``(-inf, 0)`` at the first zero pivot, as in
heat_tpu.
"""

from __future__ import annotations

import torch

__all__ = ["gauss_jordan"]


def gauss_jordan(local: torch.Tensor, n: int, comm):
    """``local``: this rank's rows of a split-0 ``(n, n)`` inexact matrix.
    Returns ``(this rank's rows of the inverse, det, logabsdet, sign)``."""
    p, me = comm.size, comm.rank
    dev, dt = local.device, local.dtype
    rdt = local.real.dtype if local.is_complex() else dt
    offset = comm.chunk((n, n), 0)[0]
    rows = local.shape[0]
    gpos = offset + torch.arange(rows, device=dev)
    eye = (gpos[:, None] == torch.arange(n, device=dev)[None, :]).to(dt)
    mat = torch.cat([local, eye], dim=1)
    det = torch.ones((), dtype=dt, device=dev)
    sign = torch.ones((), dtype=dt, device=dev)
    logabs = torch.zeros((), dtype=rdt, device=dev)
    sgn = torch.ones((), dtype=dt, device=dev)
    singular = torch.zeros((), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(-torch.inf, dtype=rdt, device=dev)
    for k in range(n):
        col = mat[:, k]
        cand = torch.where((gpos >= k) & (gpos < n), col.abs().to(rdt), neg_inf)
        slot = torch.zeros(2 * p, dtype=torch.float64, device=dev)
        if rows:
            loc_i = torch.argmax(cand)
            slot[me] = cand[loc_i].to(torch.float64)
            slot[p + me] = gpos[loc_i].to(torch.float64)
        else:
            slot[me] = -torch.inf
            slot[p + me] = -1
        slot = comm.Allreduce(slot)
        vals, idx = slot[:p], slot[p:]
        gmax = vals.max()
        piv = torch.where(vals == gmax, idx, torch.full_like(idx, -1)).max().to(torch.int64)
        rows2 = torch.zeros((2, 2 * n), dtype=dt, device=dev)
        rows2[0] = torch.where((gpos == piv)[:, None], mat, 0).sum(0)
        rows2[1] = torch.where((gpos == k)[:, None], mat, 0).sum(0)
        prow, krow = comm.Allreduce(rows2)
        is_k = (gpos == k)[:, None]
        mat = torch.where(is_k, prow[None, :], mat)
        mat = torch.where((gpos == piv)[:, None] & (piv != k), krow[None, :], mat)
        pv = prow[k]
        det = det * pv
        sign = torch.where(piv != k, -sign, sign)
        apiv = pv.abs().to(rdt)
        singular = singular | ~(apiv > 0)
        logabs = torch.where(singular, logabs, logabs + torch.log(apiv))
        sgn = torch.where(singular, sgn,
                          sgn * pv / torch.where(apiv > 0, apiv, torch.ones_like(apiv)).to(dt))
        prow_n = prow / pv
        colk = mat[:, k].clone()
        mat = torch.where(is_k, prow_n[None, :], mat - colk[:, None] * prow_n[None, :])
    zero = torch.zeros((), dtype=dt, device=dev)
    return (mat[:, n:].contiguous(), torch.where(singular, zero, det * sign),
            torch.where(singular, neg_inf, logabs), torch.where(singular, zero, sgn * sign))
