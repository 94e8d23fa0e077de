"""Singular value decomposition (heat_tpu ``core/linalg/svd.py``).

Split matrices at world size > 1 never gather: a tall split-0 matrix runs
the distributed QR, then the SVD of the small R; a wide split-1 matrix
takes the transpose identity ``Aᵀ = V S Uᵀ``; the two other quadrants
reshard once to put the long axis on the ranks. Replicated matrices, and
any at world size 1, take ``torch.linalg.svd``.
"""

from __future__ import annotations

import collections

import torch

from ..dndarray import DNDarray

__all__ = ["svd", "pinv", "matrix_rank"]

SVD = collections.namedtuple("SVD", "U, S, V")


def _sv_cutoff(s: torch.Tensor, m: int, n: int, rcond=None):
    """numpy's default singular-value cutoff (heat_tpu ``svd.py:27``):
    ``rcond · s_max`` with ``rcond = max(m, n) · eps`` when unspecified."""
    if rcond is None:
        rcond = max(m, n) * torch.finfo(s.dtype).eps
    smax = s[0] if s.numel() else torch.zeros((), dtype=s.dtype, device=s.device)
    return rcond * smax


def pinv(a: DNDarray, rcond=None) -> DNDarray:
    """Moore–Penrose pseudo-inverse ``V diag(S⁺) Uᵀ`` (heat_tpu ``svd.py:36``)."""
    from .basics import matmul, transpose

    if a.larray.is_complex():
        res = torch.linalg.pinv(a._logical(), rtol=rcond)
        return DNDarray.from_global(res, None, a.device, a.comm)
    res = svd(a)
    s = res.S._logical()
    sinv = torch.where(s > _sv_cutoff(s, *a.shape, rcond=rcond), 1.0 / s, 0.0)
    v_scaled = res.V * DNDarray.from_global(sinv[None, :], None, a.device, a.comm)
    return matmul(v_scaled, transpose(res.U))


def matrix_rank(a: DNDarray, rcond=None) -> int:
    """Count of singular values above numpy's cutoff (heat_tpu ``svd.py:60``)."""
    if a.larray.is_complex():
        return int(torch.linalg.matrix_rank(a._logical(), rtol=rcond))
    s = svd(a, compute_uv=False)._logical()
    return int((s > _sv_cutoff(s, *a.shape, rcond=rcond)).sum())


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Reduced SVD ``a = U @ diag(S) @ V.T`` (heat_tpu ``svd.py:72``)."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError("svd requires a 2-D array")
    if full_matrices:
        raise NotImplementedError("only reduced SVD (full_matrices=False) is supported")
    n, m = a.shape
    dev, comm = a.device, a.comm
    if comm.size > 1 and a.size > 0 and a.split is not None:
        if a.split == 0 and n >= m:
            from .basics import matmul
            from .qr import qr

            q, r = qr(a)
            u_r, s, vt = torch.linalg.svd(r._logical(), full_matrices=False)
            S = DNDarray.from_global(s, None, dev, comm)
            if not compute_uv:
                return S
            U = matmul(q, DNDarray.from_global(u_r, None, dev, comm))
            return SVD(U, S, DNDarray.from_global(vt.T.contiguous(), None, dev, comm))
        if a.split == 1 and m >= n:
            from .basics import transpose

            res = svd(transpose(a), compute_uv=compute_uv)
            return res if not compute_uv else SVD(res.V, res.S, res.U)
        return svd(a.resplit(0 if n >= m else 1), compute_uv=compute_uv)
    x = a._logical()
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    S = DNDarray.from_global(s, None, dev, comm)
    if not compute_uv:
        return S
    return SVD(DNDarray.from_global(u, a.split if a.split == 0 else None, dev, comm), S,
               DNDarray.from_global(vt.T.contiguous(), None, dev, comm))
