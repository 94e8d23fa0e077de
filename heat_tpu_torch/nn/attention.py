"""Attention over a sequence sharded across ranks (heat_tpu
``nn/attention.py``).

The single-card pieces: :func:`local_attention` (the dense tile, or the
flash kernel for 4-D inputs), :func:`_block_attn` (one block as the
mergeable ``(out, lse)`` pair) and :func:`_fold` (the merge). Over an
``sp`` communicator of size ``n`` three schedules use them:

* the causal ring, :func:`_ring_body`: ``n`` steps, each one flash call of
  the local queries against the resident K/V block (causal on the
  diagonal step, plain elsewhere), folded by lse; a block from a later
  rank is computed all the same and folded with lse = -inf, as heat_tpu
  does, so its cotangents come out zero. K and V move on by one
  ``ring_step`` each between steps (``n - 1`` each a layer).
* the balanced zigzag ring, :func:`_zigzag_core`: rank ``d`` holds chunks
  ``d`` and ``2n - 1 - d`` (:func:`zigzag_layout`); per step one late x
  early half-block plus exactly one of early x early and late x late, so
  ``3 + 2(n - 1)`` flash calls a rank and layer.
* Ulysses, :func:`_ulysses_core`: an all-to-all from sequence to heads,
  one causal flash call over the whole sequence for the local heads, and
  the all-to-all back (four a layer: q, k, v, out).

The kernel is :func:`heat_tpu_torch.core.kernels.flash_attention`
(``csrc/flash_fwd_sm90.cu``), differentiable through its output and its
lse: the fold gives every lse a cotangent, which the flash dK/dV
(``csrc/flash_bwd_dkv_sm90.cu``) and dQ (``csrc/flash_bwd_dq_sm90.cu``)
kernels take. The collectives are the autograd pairs of
:mod:`heat_tpu_torch.core.communication` (a ring step's transpose is the
reverse step, an all-to-all's the inverse one). heat_tpu runs its rings on
the CPU as a dense online softmax; the port's CPU path is the kernels'
plain versions, the same mathematics.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import kernels
from ..core.communication import all_to_all, ppermute, ring_shift, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = ["ring_attention", "ulysses_attention", "local_attention", "zigzag_layout",
           "zigzag_unlayout"]


def local_attention(q, k, v, scale: Optional[float] = None, causal: bool = False):
    """Attention on local tensors ``(..., S, D)`` (heat_tpu
    ``attention.py:40``). 4-D ``(B, H, S, D)`` inputs go to the flash
    kernel; other ranks take the dense form."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.ndim == 4:
        return kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=float(scale), causal=causal)
    logits = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        qn, kn = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((qn, kn), dtype=torch.bool, device=q.device).tril(kn - qn)
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", weights, v)


def _fold(acc, lse, out_i, lse_i):
    """Merge two normalized attention pieces by their log-sum-exp weights
    (heat_tpu ``attention.py:164``); a ``lse_i = -inf`` piece is a no-op."""
    lse_new = torch.logaddexp(lse, lse_i)
    zero = torch.zeros((), dtype=lse_new.dtype, device=lse_new.device)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - lse_new), zero)
    w_new = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - lse_new), zero)
    return acc * w_old[..., None] + out_i * w_new[..., None], lse_new


def _block_attn(q, k, v, scale: float, causal: bool):
    """One attention block as ``(out, lse)`` in float32, the form every ring
    schedule folds (heat_tpu ``attention.py:141``); ``q``/``k``/``v`` are
    ``(B, H, s, D)``."""
    out, lse = kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=float(scale), causal=causal, return_lse=True)
    return out.float(), lse


def _ring_body(q_blk, k_blk, v_blk, comm, scale: float, causal: bool = False):
    """Ring attention on local ``(B, S_local, H, D)`` blocks (heat_tpu
    ``attention.py:56``, its flash branch ``:75-100``): one flash call per
    ring step on the resident K/V block, folded by ``(out, lse)``. With
    ``causal``, step 0 holds the rank's own diagonal block (causal flash);
    a later block from a lower rank is fully visible, one from a higher
    rank fully masked: it is computed and folded with lse = -inf. At size 1
    the ring is its one step: the fold of one piece into the empty state
    returns the piece, so the flash output is the result."""
    size = comm.size
    qh = q_blk.transpose(1, 2)
    if size == 1:
        out = kernels.flash_attention(qh.contiguous(), k_blk.transpose(1, 2).contiguous(),
                                      v_blk.transpose(1, 2).contiguous(), scale=float(scale),
                                      causal=causal)
        return out.transpose(1, 2)
    rank = comm.rank
    B, Sq, H, D = q_blk.shape
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q_blk.device)
    lse = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=q_blk.device)
    k_cur, v_cur = k_blk, v_blk
    for step in range(size):
        out_i, lse_i = _block_attn(qh, k_cur.transpose(1, 2), v_cur.transpose(1, 2), scale,
                                   causal=causal and step == 0)
        if causal and step > 0 and not (rank - step) % size < rank:
            lse_i = torch.full_like(lse_i, float("-inf"))
        acc, lse = _fold(acc, lse, out_i, lse_i)
        if step != size - 1:
            k_cur, v_cur = ring_shift(comm, k_cur, v_cur)
    return acc.transpose(1, 2).to(q_blk.dtype)


def zigzag_layout(x, comm):
    """Contiguous split layout to zigzag layout along the sequence axis 1
    (heat_tpu ``attention.py:201``): contiguous rank ``s`` holds chunks
    ``(2s, 2s + 1)``, zigzag rank ``d`` chunks ``(d, 2n - 1 - d)``. Two
    permutations (one ``permute`` round each); at an even destination the
    first carries the early chunk, at an odd one the second. None at size
    1 (no layout needed)."""
    n = comm.size
    if n == 1:
        return None
    S2 = x.shape[1]
    if S2 % 2:
        raise ValueError(f"zigzag schedule needs the global sequence divisible by 2*size "
                         f"(local block {S2} is odd)")
    c = S2 // 2
    even = comm.rank % 2 == 0
    p_a = [(s, 2 * s if 2 * s < n else 2 * n - 1 - 2 * s) for s in range(n)]
    p_b = [(s, 2 * s + 1 if 2 * s + 1 < n else 2 * n - 2 - 2 * s) for s in range(n)]
    ra = ppermute(x[:, :c], comm, p_a)
    rb = ppermute(x[:, c:], comm, p_b)
    early, late = (ra, rb) if even else (rb, ra)
    return torch.cat([early, late], dim=1)


def zigzag_unlayout(x, comm):
    """The inverse of :func:`zigzag_layout` (heat_tpu ``attention.py:233``):
    zigzag rank ``d`` returns chunks ``d`` and ``2n - 1 - d`` to their
    contiguous owners (chunk ``h`` lives on rank ``h // 2``, slot
    ``h % 2``)."""
    n = comm.size
    if n == 1:
        return x
    c = x.shape[1] // 2
    even = comm.rank % 2 == 0
    early, late = x[:, :c], x[:, c:]
    to0, to1 = (early, late) if even else (late, early)
    p0 = [(d, d // 2 if d % 2 == 0 else (2 * n - 1 - d) // 2) for d in range(n)]
    p1 = [(d, (2 * n - 1 - d) // 2 if d % 2 == 0 else d // 2) for d in range(n)]
    return torch.cat([ppermute(to0, comm, p0), ppermute(to1, comm, p1)], dim=1)


def _zigzag_core(q_blk, k_blk, v_blk, comm, scale: float):
    """The balanced causal ring on zigzag-laid-out ``(B, 2c, H, D)`` blocks
    (heat_tpu ``attention.py:255``); the output stays in zigzag layout. Per
    step the late queries see the early keys whole; at step 0 both
    diagonal blocks run causal; after it, exactly one of early x early
    (keys from a lower rank) and late x late (from a higher one) is live
    and computed, the other folds as an empty piece."""
    n, r = comm.size, comm.rank
    B, S2, H, D = q_blk.shape
    c = S2 // 2
    qz = q_blk.transpose(1, 2)
    q_e, q_l = qz[:, :, :c], qz[:, :, c:]
    dev = q_blk.device

    def empty():
        return (torch.zeros((B, H, c, D), dtype=torch.float32, device=dev),
                torch.full((B, H, c), float("-inf"), dtype=torch.float32, device=dev))

    acc_e, lse_e = empty()
    acc_l, lse_l = empty()
    k_cur, v_cur = k_blk, v_blk
    for t in range(n):
        kh, vh = k_cur.transpose(1, 2), v_cur.transpose(1, 2)
        k_e, k_l = kh[:, :, :c], kh[:, :, c:]
        v_e, v_l = vh[:, :, :c], vh[:, :, c:]
        acc_l, lse_l = _fold(acc_l, lse_l, *_block_attn(q_l, k_e, v_e, scale, causal=False))
        if t == 0:
            acc_e, lse_e = _fold(acc_e, lse_e, *_block_attn(q_e, k_e, v_e, scale, causal=True))
            acc_l, lse_l = _fold(acc_l, lse_l, *_block_attn(q_l, k_l, v_l, scale, causal=True))
        elif (r - t) % n < r:  # the resident pair came from a lower rank
            acc_e, lse_e = _fold(acc_e, lse_e, *_block_attn(q_e, k_e, v_e, scale, causal=False))
            acc_l, lse_l = _fold(acc_l, lse_l, *empty())
        else:
            acc_e, lse_e = _fold(acc_e, lse_e, *empty())
            acc_l, lse_l = _fold(acc_l, lse_l, *_block_attn(q_l, k_l, v_l, scale, causal=False))
        if t != n - 1:
            k_cur, v_cur = ring_shift(comm, k_cur, v_cur)
    return torch.cat([acc_e, acc_l], dim=2).transpose(1, 2).to(q_blk.dtype)


def _ring_body_zigzag(q_blk, k_blk, v_blk, comm, scale: float):
    """The zigzag ring on contiguous blocks (heat_tpu ``attention.py:173``):
    lay out, run :func:`_zigzag_core`, lay back; at size 1 plain causal
    attention."""
    if comm.size == 1:
        out = local_attention(q_blk.transpose(1, 2), k_blk.transpose(1, 2),
                              v_blk.transpose(1, 2), scale, causal=True)
        return out.transpose(1, 2)
    parts = (zigzag_layout(q_blk, comm), zigzag_layout(k_blk, comm), zigzag_layout(v_blk, comm))
    return zigzag_unlayout(_zigzag_core(*parts, comm=comm, scale=scale), comm)


def _ulysses_core(qb, kb, vb, comm, scale: float, causal: bool):
    """DeepSpeed-Ulysses attention on local ``(B, s, H, D)`` blocks
    (heat_tpu ``attention.py:320``): all-to-all from sequence- to
    head-sharded, so each rank holds the whole sequence for ``H / n``
    heads; :func:`local_attention` there (the flash kernel, no lse); the
    all-to-all back."""
    qh, kh, vh = (all_to_all(t, comm, 2, 1) for t in (qb, kb, vb))
    out = local_attention(qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2), scale,
                          causal=causal)
    return all_to_all(out.transpose(1, 2), comm, 1, 2)


def _operands(q, k, v, comm, name):
    if isinstance(q, DNDarray):
        if q.split != 1:
            raise ValueError(f"{name} expects sequence-split (split=1) inputs")
        comm = q.comm
        qa, ka, va = q.larray, k.larray, v.larray
        if q.gshape[1] % comm.size:
            raise ValueError(f"{name}: the sequence ({q.gshape[1]}) must divide over the "
                             f"{comm.size} ranks")
    else:
        comm = sanitize_comm(comm)
        qa, ka, va = q, k, v
    return comm, qa, ka, va


def ring_attention(q, k, v, comm=None, scale: Optional[float] = None, causal: bool = False,
                   batch_axis: Optional[str] = None, schedule: str = "ring"):
    """Exact attention over a sequence sharded across ranks (heat_tpu
    ``attention.py:354``).

    ``q``, ``k``, ``v``: this rank's ``(B, S_local, H, D)`` blocks (every
    rank's of one length) with ``comm`` the sequence communicator (a
    :class:`~heat_tpu_torch.core.communication.MeshGrid` axis view, or the
    world), or DNDarrays split along the sequence axis 1. The K/V blocks
    circulate the ring; ``causal`` applies the global causal mask per
    step. ``schedule="zigzag"`` (causal only) is the load-balanced layout,
    the same mathematics. ``batch_axis`` names the grid axis the batch is
    sharded over in heat_tpu's single-controller call; here every rank
    passes its own batch rows already, so it only documents the call.
    """
    if schedule not in ("ring", "zigzag"):
        raise ValueError(f"schedule must be 'ring' or 'zigzag', got {schedule!r}")
    if schedule == "zigzag" and not causal:
        raise ValueError("schedule='zigzag' only applies to causal attention — the non-causal "
                         "ring is already load-balanced")
    wrapped = isinstance(q, DNDarray)
    comm, qa, ka, va = _operands(q, k, v, comm, "ring_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(qa.shape[-1])
    if schedule == "zigzag":
        out = _ring_body_zigzag(qa, ka, va, comm, float(scale))
    else:
        out = _ring_body(qa, ka, va, comm, float(scale), causal=causal)
    if wrapped:
        return DNDarray(out, q.gshape, q.dtype, 1, q.device, comm)
    return out


def ulysses_attention(q, k, v, comm=None, scale: Optional[float] = None, causal: bool = False,
                      batch_axis: Optional[str] = None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism (heat_tpu
    ``attention.py:420``): sequence-sharded ``(B, S_local, H, D)`` blocks,
    or split-1 DNDarrays, to head-sharded full sequences and back. The head
    count must divide over the ranks."""
    wrapped = isinstance(q, DNDarray)
    comm, qa, ka, va = _operands(q, k, v, comm, "ulysses_attention")
    H = qa.shape[2]
    if H % comm.size:
        raise ValueError(f"heads ({H}) must be divisible by mesh size ({comm.size})")
    if scale is None:
        scale = 1.0 / math.sqrt(qa.shape[-1])
    out = _ulysses_core(qa, ka, va, comm, float(scale), causal)
    if wrapped:
        return DNDarray(out, q.gshape, q.dtype, 1, q.device, comm)
    return out
