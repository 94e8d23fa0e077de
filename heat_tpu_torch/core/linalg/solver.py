"""Solvers (heat_tpu ``core/linalg/solver.py``).

``lanczos`` of a row-split operator runs heat_tpu's step program
(``solver.py:74-120``) on the shards: per iteration the local rows'
matvec, ONE all-gather of the result, classical Gram-Schmidt against the
whole basis applied twice (``doc/analytics.md``), and one host read of the
next ``beta`` (the restart guard). Other layouts take heat_tpu's legacy
loop on DNDarray operations.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import arithmetics, exponential, factories, fusion, types
from ..dndarray import DNDarray
from .basics import _square_check, dot, matmul, transpose

__all__ = ["cg", "lanczos", "solve", "cholesky", "eigh", "lstsq"]


def _square_2d_check(a: DNDarray) -> None:
    if a.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {a.ndim}-D")
    _square_check(a)


def _inexact(t: torch.Tensor) -> torch.Tensor:
    return t if (t.is_floating_point() or t.is_complex()) else t.to(torch.float64)


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients (heat_tpu ``solver.py:38``)."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError("A, b and x0 need to be of type ht.DNDarray")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("c needs to be a 1D vector")
    r = arithmetics.sub(b, matmul(A, x0.reshape((x0.size, 1))).reshape((b.size,)))
    p = r
    rsold = dot(r, r)
    x = x0
    for _ in range(len(b)):
        Ap = matmul(A, p.reshape((p.size, 1))).reshape((b.size,))
        alpha = arithmetics.div(rsold, dot(p, Ap))
        x = arithmetics.add(x, arithmetics.mul(alpha, p))
        r = arithmetics.sub(r, arithmetics.mul(alpha, Ap))
        rsnew = dot(r, r)
        if float(rsnew.item()) ** 0.5 < 1e-10:
            return x
        p = arithmetics.add(r, arithmetics.mul(arithmetics.div(rsnew, rsold), p))
        rsold = rsnew
    return x


def _lanczos_step(a: torch.Tensor, vbuf, w, abuf, bbuf, beta, i, comm, counts, vi=None):
    """One iteration of heat_tpu's step program (``solver.py:74``), writing
    column ``i`` of ``vbuf`` and entry ``i`` of ``abuf`` and ``bbuf`` in
    place: ``beta`` and ``i`` are 0-d tensors, so one program serves every
    iteration. ``vi`` defaults to ``w / beta``; returns the next ``w`` and
    ``beta``."""
    if vi is None:
        vi = w / beta
    at = i.reshape(1)
    vbuf.index_copy_(1, at, vi[:, None])
    w1 = comm.Allgather(a @ vi, 0, counts)  # the iteration's one collective
    proj = vbuf.T @ w1
    w2 = w1 - vbuf @ proj
    w2 = w2 - vbuf @ (vbuf.T @ w2)  # the second classical Gram-Schmidt pass
    abuf.index_copy_(0, at, proj.index_select(0, at))
    bbuf.index_copy_(0, at, beta.reshape(1))
    return w2, torch.sqrt(torch.sum(w2 * w2))


def _lanczos_split0(A: DNDarray, m: int, v0: DNDarray):
    """Lanczos of a row-split operator (heat_tpu ``_lanczos_fused``): each
    iteration one :func:`~heat_tpu_torch.core.fusion.fit_step_call` program
    (heat_tpu ``solver.py:181``), a restart iteration eagerly; the
    ``float(beta)`` read between iterations is the one host sync."""
    from .. import random as ht_random

    comm = A.comm
    n = A.shape[0]
    a = _inexact(A.larray)
    dt, dev = a.dtype, a.device
    counts, _ = comm.counts_displs(n)
    w = v0.resplit(None)._logical().to(dt)
    vbuf = torch.zeros((n, m), dtype=dt, device=dev)
    abuf = torch.zeros(m, dtype=dt, device=dev)
    bbuf = torch.zeros(m, dtype=dt, device=dev)
    def step(a, vbuf, w, abuf, bbuf, bb, ii):
        return _lanczos_step(a, vbuf, w, abuf, bbuf, bb, ii, comm, counts)

    beta = 1.0  # i = 0: v_0 = w / 1, the caller's normalized v0
    for i in range(m):
        bb = torch.tensor(beta, dtype=dt, device=dev)
        ii = torch.tensor(i, dtype=torch.int64, device=dev)
        if i > 0 and beta < 1e-10:  # restart with a random vector orthogonal to the basis
            vr = ht_random.rand(n, device=A.device, comm=comm)._logical().to(dt)
            vr = vr - vbuf @ (vbuf.T @ vr)
            vi = vr / torch.sqrt(torch.sum(vr * vr))
            w, bnext = _lanczos_step(a, vbuf, w, abuf, bbuf, bb, ii, comm, counts, vi)
        else:
            w, bnext = fusion.fit_step_call(
                ("lanczos.step", tuple(a.shape), str(dt), m, fusion._comm_key(comm), str(dev)),
                lambda qk, ck, hk: step, (a, vbuf, w, abuf, bbuf, bb, ii), step)
        beta = float(bnext)
    T = torch.diag(abuf)
    if m > 1:
        T = T + torch.diag(bbuf[1:], 1) + torch.diag(bbuf[1:], -1)
    return (DNDarray.from_global(vbuf, 0, A.device, comm),
            DNDarray.from_global(T, None, A.device, comm))


def lanczos(A: DNDarray, m: int, v0: Optional[DNDarray] = None,
            V_out: Optional[DNDarray] = None, T_out: Optional[DNDarray] = None):
    """Lanczos tridiagonalization ``A ≈ V T Vᵀ`` (heat_tpu ``solver.py:204``).
    Without ``v0`` the start is heat_tpu's draw, ``rand(n)`` normalized. A
    row-split operator under ``fusion.fit_enabled()`` takes heat_tpu's fused
    inner loop (one program an iteration, twice-applied classical
    re-orthogonalization); any other operator, or the switch off, its
    per-operation loop with sequential re-orthogonalization."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be of type ht.DNDarray, but was {type(A)}")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    from .. import random as ht_random

    n = A.shape[0]
    m = int(m)
    if v0 is None:
        vr = ht_random.rand(n, split=A.split and 0, device=A.device, comm=A.comm)
        v0 = arithmetics.div(vr, exponential.sqrt(dot(vr, vr)))
    if A.split == 0 and n > 0 and m >= 1 and fusion.fit_enabled():
        V, T = _lanczos_split0(A, m, v0)
    else:
        V, T = _lanczos_legacy(A, m, v0, n)
    if V_out is not None:
        V_out.larray = V.resplit(V_out.split).larray
        if T_out is not None:
            T_out.larray = T.larray
            return V_out, T_out
        return V_out, T
    return V, T


def _lanczos_legacy(A: DNDarray, m: int, v0: DNDarray, n: int):
    """heat_tpu's per-operation loop with sequential re-orthogonalization
    (``solver.py:239-270``), for operators that are not row-split."""
    from .. import manipulations
    from .. import random as ht_random

    alphas, betas, vs = [], [0.0], [v0]
    w = matmul(A, v0.reshape((n, 1))).reshape((n,))
    alpha = dot(w, v0)
    w = arithmetics.sub(w, arithmetics.mul(alpha, v0))
    alphas.append(float(alpha.item()))
    for _ in range(1, m):
        beta = float(exponential.sqrt(dot(w, w)).item())
        if beta < 1e-10:
            vr = ht_random.rand(n, split=v0.split, device=A.device, comm=A.comm)
            for v in vs:
                vr = arithmetics.sub(vr, arithmetics.mul(dot(vr, v), v))
            vi = arithmetics.div(vr, exponential.sqrt(dot(vr, vr)))
        else:
            vi = arithmetics.div(w, beta)
        w = matmul(A, vi.reshape((n, 1))).reshape((n,))
        alpha = dot(w, vi)
        w = arithmetics.sub(w, arithmetics.mul(alpha, vi))
        w = arithmetics.sub(w, arithmetics.mul(beta, vs[-1]))
        for v in vs:
            w = arithmetics.sub(w, arithmetics.mul(dot(w, v), v))
        alphas.append(float(alpha.item()))
        betas.append(beta)
        vs.append(vi)
    V = manipulations.stack(vs, axis=1)
    dev = A.larray.device
    T = torch.diag(torch.tensor(alphas, dtype=torch.float64, device=dev))
    if m > 1:
        off = torch.tensor(betas[1:], dtype=torch.float64, device=dev)
        T = T + torch.diag(off, 1) + torch.diag(off, -1)
    return V, DNDarray.from_global(T, None, A.device, A.comm)


def solve(A: DNDarray, b: DNDarray) -> DNDarray:
    """Solve ``A x = b`` (heat_tpu ``solver.py:290``): a split inexact ``A``
    at world size > 1 by the distributed Gauss-Jordan inverse and ``matmul``,
    else ``torch.linalg.solve`` on the logical arrays."""
    _square_2d_check(A)
    if A.split is not None and A.comm.size > 1 and types.heat_type_is_inexact(A.dtype):
        from .basics import inv

        bx = b if b.ndim == 2 else b.expand_dims(1)
        x = matmul(inv(A), bx)
        return x.reshape((A.shape[0],)) if b.ndim == 1 else x
    a = _inexact(A._logical())
    x = torch.linalg.solve(a, b._logical().to(a.dtype))
    return DNDarray.from_global(x, None, A.device, A.comm)


def _cholesky_split0(A: DNDarray) -> DNDarray:
    """Distributed right-looking blocked Cholesky of a row-split SPD matrix
    (heat_tpu ``solver.py:321``): ``p`` rounds over the diagonal blocks,
    each with two masked all-reduces (the owner's factor, then the panel)."""
    comm = A.comm
    p, me = comm.size, comm.rank
    n = A.shape[0]
    a = _inexact(A.larray)
    rows = a.shape[0]
    dt, dev = a.dtype, a.device
    c = comm.chunk_size(n)
    n_pad = c * p
    ab = torch.zeros((c, n_pad), dtype=dt, device=dev)
    ab[:rows, :n] = a
    grow = me * c + torch.arange(c, device=dev)
    cols = torch.arange(n_pad, device=dev)
    # padding rows become identity rows: every diagonal block stays SPD
    ab = torch.where((grow >= n)[:, None], (grow[:, None] == cols[None, :]).to(dt), ab)
    l_acc = torch.zeros((c, n_pad), dtype=dt, device=dev)
    for j in range(p):
        cand = ab[:, j * c:(j + 1) * c]
        ljj = torch.linalg.cholesky(cand) if me == j else torch.zeros_like(cand)
        ljj = comm.Allreduce(ljj)
        li = torch.linalg.solve_triangular(ljj, cand.T, upper=False).T
        if me < j:
            li = torch.zeros_like(li)
        pancols = j * c + torch.arange(c, device=dev)
        li = torch.where(grow[:, None] < pancols[None, :], 0, li)
        panel = torch.zeros((n_pad, c), dtype=dt, device=dev)
        panel[me * c:(me + 1) * c] = li
        panel = comm.Allreduce(panel)
        upd = li @ panel.T
        ab = ab - torch.where((cols >= (j + 1) * c)[None, :], upd, 0)
        l_acc[:, j * c:(j + 1) * c] = li
    return DNDarray(l_acc[:rows, :n].contiguous(), (n, n), types.canonical_heat_type(dt), 0,
                    A.device, comm)


def cholesky(A: DNDarray) -> DNDarray:
    """Lower Cholesky factor (heat_tpu ``solver.py:408``)."""
    _square_2d_check(A)
    if A.split is not None and A.comm.size > 1 and A.size > 0 and not A.larray.is_complex():
        return _cholesky_split0(A if A.split == 0 else A.resplit(0))
    return DNDarray.from_global(torch.linalg.cholesky(_inexact(A._logical())), None, A.device,
                                A.comm)


def eigh(A: DNDarray):
    """Eigendecomposition of a symmetric matrix, ascending (heat_tpu
    ``solver.py:424``): a split matrix at world size > 1 through the
    gather-free SVD of ``(A + Aᵀ)/2 + cI``, ``c`` 1.1 times the Gershgorin
    bound; else ``torch.linalg.eigh``."""
    _square_2d_check(A)
    if A.split is not None and A.comm.size > 1 and A.size > 0 and not A.larray.is_complex():
        from .. import manipulations
        from .svd import svd

        x = A if types.heat_type_is_inexact(A.dtype) else A.astype(types.float64)
        x = arithmetics.div(arithmetics.add(x, transpose(x)), 2.0)
        c = 1.1 * float(x.abs().sum(axis=1).max())
        if c == 0.0:
            c = 1.0
        shifted = arithmetics.add(x, arithmetics.mul(factories.eye(
            x.shape[0], dtype=x.dtype, split=x.split, device=x.device, comm=x.comm), c))
        if shifted.split != 0:
            shifted = shifted.resplit(0)
        res = svd(shifted)
        return (arithmetics.sub(manipulations.flip(res.S, 0), c),
                manipulations.flip(res.U, axis=1))
    w, v = torch.linalg.eigh(_inexact(A._logical()))
    return (DNDarray.from_global(w, None, A.device, A.comm),
            DNDarray.from_global(v, None, A.device, A.comm))


def lstsq(A: DNDarray, b: DNDarray) -> DNDarray:
    """Least squares ``A x ≈ b`` (heat_tpu ``solver.py:477``): a tall split-0
    ``A`` through the distributed QR, a wide split ``A`` through the SVD,
    else ``torch.linalg.lstsq``."""
    if A.ndim != 2:
        raise ValueError(f"'A' must be 2-D, got {A.ndim}-D")
    m, n = A.shape
    if A.split == 0 and m >= n:
        from .qr import qr

        dec = qr(A, calc_q=True)
        qtb = matmul(transpose(dec.Q), b if b.ndim == 2 else b.expand_dims(1))
        r = dec.R._logical()
        x = torch.linalg.lstsq(r[:n, :n], qtb._logical()[:n].to(r.dtype)).solution
        if b.ndim == 1:
            x = x[:, 0]
        return DNDarray.from_global(x, None, A.device, A.comm)
    if A.split is not None and A.comm.size > 1 and m < n and A.size > 0 and \
            not A.larray.is_complex():
        from .. import manipulations
        from .svd import _sv_cutoff, svd

        res = svd(A)
        s = res.S._logical()
        u = res.U._logical()
        bl = b._logical().to(u.dtype)
        ub = u.T @ (bl if b.ndim == 2 else bl[:, None])
        w = ub * torch.where(s > _sv_cutoff(s, m, n), 1.0 / s, 0.0)[:, None]
        x = matmul(res.V, DNDarray.from_global(w, None, A.device, A.comm))
        return manipulations.reshape(x, (n,)) if b.ndim == 1 else x
    a = _inexact(A._logical())
    x = torch.linalg.lstsq(a, b._logical().to(a.dtype)).solution
    return DNDarray.from_global(x, None, A.device, A.comm)
