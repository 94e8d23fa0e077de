"""Attention on local tensors (heat_tpu ``nn/attention.py:40-170``).

The single-card pieces of heat_tpu's attention: :func:`local_attention`
(the dense tile, or the flash kernel for 4-D inputs), :func:`_block_attn`
and :func:`_fold` (the mergeable ``(out, lse)`` form and its merge, which
the multi-card ring folds; held against heat_tpu's now), and
:func:`_ring_body`, the per-device causal ring, here at a communicator of
size 1, where the ring is one flash call. The kernel is
:func:`heat_tpu_torch.core.kernels.flash_attention`
(``csrc/flash_fwd_sm90.cu``), differentiable through its output and its
lse: its backward is the flash dK/dV (``csrc/flash_bwd_dkv_sm90.cu``) and
dQ kernels (``csrc/flash_bwd_dq_sm90.cu``), so ``_block_attn``,
``local_attention`` and ``_ring_body`` train through them. At size 1
heat_tpu's fold of the one piece into the empty state hands the piece's lse
a zero cotangent exactly, so returning the flash output directly gives the
same gradients. ``ring_attention``, ``ulysses_attention`` and the zigzag
schedule come with the multi-card slices (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import kernels

__all__ = ["local_attention"]


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
    """Ring attention on ``(B, S, H, D)`` blocks (heat_tpu
    ``attention.py:56``, its flash branch ``:75-100``): one flash call per
    ring step on the resident K/V block, folded by ``(out, lse)``. Only a
    communicator of size 1 is ported, where the ring is its one step on the
    device's own, diagonal block: folding one piece into the empty state
    returns the piece, so the flash output is the result."""
    if comm.size != 1:
        raise NotImplementedError(
            "ring attention across several cards is a later slice of the port")
    out = kernels.flash_attention(q_blk.transpose(1, 2).contiguous(),
                                  k_blk.transpose(1, 2).contiguous(),
                                  v_blk.transpose(1, 2).contiguous(),
                                  scale=float(scale), causal=causal)
    return out.transpose(1, 2)
