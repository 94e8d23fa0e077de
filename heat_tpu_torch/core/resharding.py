"""Split-layout changes as planned collectives (heat_tpu
``core/resharding.py``).

A change of a DNDarray's split axis is one of four moves, planned from
``(gshape, from_split, to_split)`` alone (arXiv:2112.01075):

=================  =====================================================
kind               what runs
=================  =====================================================
``noop``           nothing: the split does not change.
``local_slice``    None → k: every rank keeps its chunk of the replicated
                   array. No collective.
``all_gather``     j → None: ONE all-gather along j; gathering is the
                   semantics here.
``all_to_all``     j → k: ONE all-to-all (split along k, concatenated
                   along j), no all-gather: rank ``r`` sends the block
                   (its rows of j × rank ``e``'s chunk of k) to each rank
                   ``e``, and the blocks it receives, concatenated in rank
                   order, are the whole of j by its own chunk of k.
=================  =====================================================

At world size 1 every move is ``local``: the one shard is the whole array.
heat_tpu calls the single-device and empty-array cases ``gspmd`` (its
degenerate GSPMD program) and retries a failed dispatch through that
program; the port has no such program, and a failed collective raises.

heat_tpu compiles one program per ``(shape, dtype, gshape, from, to,
mesh)`` and counts its plan cache's hits and misses. The port builds no
program: :func:`plan_cache_stats` counts its plan resolutions under the
same keys, a miss the first time :func:`reshard` moves a key, a hit every
time after (``resharding.plan_hits`` / ``_misses`` in
:mod:`heat_tpu_torch.utils.metrics`), and ``entries`` the keys seen.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["plan_kind", "reshard", "plan_cache_stats", "reset_plan_cache"]

# the plans resolved so far: (local shape, dtype, gshape, from, to, world) -> kind
_PLANS: dict = {}
_HITS = 0
_MISSES = 0


def plan_cache_stats() -> dict:
    """heat_tpu's plan-cache figures (``resharding.py:82``): hits and
    misses of the plan resolutions since the last reset, and the keys
    seen."""
    return {"hits": _HITS, "misses": _MISSES, "entries": len(_PLANS)}


def reset_plan_cache() -> None:
    global _HITS, _MISSES
    _PLANS.clear()
    _HITS = 0
    _MISSES = 0


def _resolve(tensor, gshape, from_split, to_split, comm) -> str:
    """:func:`plan_kind` of one move, counted as heat_tpu counts its plan
    cache."""
    global _HITS, _MISSES
    from ..utils import metrics

    key = (tuple(tensor.shape), str(tensor.dtype), gshape, from_split, to_split, comm.size)
    kind = _PLANS.get(key)
    if kind is not None:
        _HITS += 1
        metrics.inc("resharding.plan_hits")
        return kind
    _MISSES += 1
    metrics.inc("resharding.plan_misses")
    kind = _PLANS[key] = plan_kind(gshape, from_split, to_split, comm)
    return kind


def plan_kind(gshape, from_split: Optional[int], to_split: Optional[int], comm) -> str:
    """Which move :func:`reshard` makes: ``"noop"``, ``"local_slice"``,
    ``"all_gather"``, ``"all_to_all"``, or ``"local"`` at world size 1 and
    for 0-d arrays."""
    if from_split == to_split:
        return "noop"
    if comm.size <= 1 or len(gshape) == 0:
        return "local"
    if from_split is None:
        return "local_slice"
    if to_split is None:
        return "all_gather"
    return "all_to_all"


def reshard(tensor: torch.Tensor, gshape, from_split: Optional[int],
            to_split: Optional[int], comm) -> torch.Tensor:
    """This rank's shard of the ``to_split`` layout, from its shard
    ``tensor`` of the ``from_split`` layout of a ``gshape`` array. A new
    shard never shares memory with a larger buffer it was cut from; a
    ``noop`` or ``local`` move returns ``tensor`` itself (no DNDarray
    operation writes into a shard in place)."""
    if from_split == to_split:
        return tensor
    gshape = tuple(int(s) for s in gshape)
    kind = _resolve(tensor, gshape, from_split, to_split, comm)
    if kind == "local":
        return tensor
    if kind == "local_slice":
        _, _, slices = comm.chunk(gshape, to_split)
        return tensor[slices].clone()
    if kind == "all_gather":
        counts, _ = comm.counts_displs(gshape[from_split])
        return comm.Allgather(tensor, from_split, counts)
    return comm.Alltoall(tensor, to_split, from_split, gshape[from_split])
