"""Data-parallel optimizers (heat_tpu ``optim/dp_optimizer.py``).

:class:`DataParallelOptimizer` wraps a :class:`~.optimizers.Transform` for
:class:`heat_tpu_torch.nn.DataParallel`, or applies whole gradient trees
itself. :class:`DASO` is heat_tpu's two-tier delayed-sync schedule on a
``MeshGrid((slow, fast), ("dcn", "ici"))``: the fast tier (the ranks of one
node) averages gradients every step in the trainer's packed all-reduce;
each node's parameters diverge, and every ``global_skip`` batches they are
reconciled by a bfloat16 average over the slow tier (one packed all-reduce
over ``dcn``) that is blended half and half into the local parameters
``batches_to_wait`` batches later. Warm-up, cycling and cool-down follow
:class:`~.utils.DetectMetricPlateau`.

heat_tpu gives every parameter a leading replica axis over the slow tier;
in the port's process model each rank holds its node's replica, so the
replica axis is the rank's ``dcn`` coordinate. heat_tpu's quantized,
chunked and hierarchical wire codecs are not ported: the wire is bfloat16,
flat.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..core import fusion
from ..core.communication import MeshGrid, sanitize_comm
from ..core.tree import tree_flatten
from .optimizers import Transform
from .utils import DetectMetricPlateau

__all__ = ["DataParallelOptimizer", "DASO"]


def _tensors(tree):
    """A tree's tensors, DNDarray leaves by their local shards; the tree's
    structure otherwise unchanged."""
    from ..core.dndarray import DNDarray

    if isinstance(tree, DNDarray):
        return tree.larray
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


class DataParallelOptimizer:
    """A thin wrapper over a transform (heat_tpu ``dp_optimizer.py:69``).

    Attached to :class:`heat_tpu_torch.nn.DataParallel`, the update runs
    inside the trainer's step and :meth:`step` without arguments does
    nothing. Alone, :meth:`apply_gradients` (or ``step(params, grads)``)
    updates a tree of tensors or DNDarrays in place and returns it.
    ``blocking`` is kept for heat_tpu's signature.
    """

    def __init__(self, optimizer: Transform, blocking: bool = False):
        if isinstance(optimizer, str):
            raise TypeError("pass a transform, e.g. ht.optim.SGD(lr=0.01)")
        self.tx = optimizer
        self.blocking = blocking
        self.opt_state = None
        self._net = None
        self._traced_apply = None

    def _attach(self, net) -> None:
        self._net = net

    def reset_state(self, params) -> None:
        self.opt_state = self.tx.init(_tensors(params))

    def apply_gradients(self, params, grads):
        """Update ``params`` in place by ``grads`` (a tree of its shape) and
        return a tree of the updated arrays; the optimizer state is made on
        first use. The whole tree updates in ONE traced step (heat_tpu
        ``dp_optimizer.py:113``: :func:`heat_tpu_torch.core.fusion.trace_step`
        with the optimizer state donated, one ``op_engine.fusion_step_flushes``
        a call, a CUDA graph on a card); the update is the port's own code,
        capturable by construction, so it is not traced on data-free
        tensors."""
        if self.opt_state is None:
            self.reset_state(params)
        if self._traced_apply is None:
            tx = self.tx

            def _apply(params, opt_state, grads):
                tx.update(_tensors(grads), opt_state, _tensors(params))
                return params

            self._traced_apply = fusion._TracedStep(_apply, donate_argnums=(1,), trace=False)
        return self._traced_apply(params, self.opt_state, grads)

    def step(self, params=None, grads=None):
        """With ``(params, grads)``: :meth:`apply_gradients`; without, nothing
        (the attached trainer's step updates)."""
        if params is None and grads is None:
            return None
        if params is None or grads is None:
            raise TypeError("step() takes both params and grads (or neither)")
        return self.apply_gradients(params, grads)

    def zero_grad(self) -> None:
        """Nothing: gradients are never accumulated on the parameters."""
        return None


class DASO:
    """Hierarchical delayed-sync optimizer (heat_tpu ``dp_optimizer.py:170``).

    The world factors into nodes of ``local_size`` ranks (``LOCAL_WORLD_SIZE``
    by default, which ``torchrun`` sets; one node without it, as heat_tpu's
    single-process default): ``grid = MeshGrid((slow, fast), ("dcn",
    "ici"))``. :meth:`step` advances the schedule by one batch on the
    parameters in place: it applies a captured slow-tier average once its
    delay is over, and captures a new one every ``global_skip`` batches.
    """

    def __init__(self, local_optimizer, total_epochs: int, comm=None, warmup_epochs: int = 4,
                 cooldown_epochs: int = 4, scheduler=None, stability_level: float = 0.05,
                 max_global_skips: int = 8, sending_chunk_size: int = 10_000_000,
                 downcast_type=torch.bfloat16, local_size: Optional[int] = None,
                 verbose: bool = False):
        self.local_optimizer = (local_optimizer if isinstance(local_optimizer,
                                                              DataParallelOptimizer)
                                else DataParallelOptimizer(local_optimizer))
        self.comm = sanitize_comm(comm)
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.scheduler = scheduler
        self.stability = DetectMetricPlateau(patience=2, threshold=stability_level)
        self.max_global_skips = max_global_skips
        self.sending_chunk_size = sending_chunk_size
        self.downcast_type = downcast_type
        self.verbose = verbose
        n = self.comm.size
        if local_size is None:
            local_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        if local_size < 1 or n % local_size:
            raise ValueError(f"a world of {n} ranks cannot factor into nodes of {local_size}")
        self.slow_size = n // local_size
        self.fast_size = local_size
        self.grid = MeshGrid((self.slow_size, self.fast_size), ("dcn", "ici"))
        self.global_skip = 1
        self.batches_to_wait = 1
        self.epoch = 0
        self._batch = 0
        self._pending = None  # (apply at batch, the bf16 slow-tier average)

    @property
    def tx(self) -> Transform:
        return self.local_optimizer.tx

    # -------------------------------------------------------------- #
    # the replica layout                                             #
    # -------------------------------------------------------------- #
    def replicate(self, params):
        """This rank's replica: a copy of ``params`` (heat_tpu installs the
        replica axis here; each rank of a node holds its node's)."""
        leaves, unflatten = tree_flatten(_tensors(params))
        return unflatten([p.detach().clone() for p in leaves])

    def unreplicate(self, params):
        """The average of the nodes' replicas (one all-reduce over the slow
        tier, float leaves only), in a new tree."""
        leaves, unflatten = tree_flatten(_tensors(params))
        dcn = self.grid.axis("dcn")
        floats = [p.detach() for p in leaves if p.is_floating_point()]
        summed = iter(fusion.packed_psum(floats, dcn) if floats else [])
        return unflatten([next(summed) / self.slow_size if p.is_floating_point()
                          else p.detach().clone() for p in leaves])

    # -------------------------------------------------------------- #
    def _capture(self, leaves):
        """The slow-tier average in the bf16 wire dtype: every float leaf
        downcast, summed over ``dcn`` and divided by the node count. With
        ``fusion.step_enabled()`` the sums are one packed all-reduce (heat_tpu
        ``_build_packed_avg``, gated at ``dp_optimizer.py:372``), else one
        all-reduce a leaf (heat_tpu's per-leaf mean)."""
        cast = self.downcast_type
        floats = [p.detach().to(cast) for p in leaves if p.is_floating_point()]
        if self.slow_size > 1 and floats:
            dcn = self.grid.axis("dcn")
            summed = (fusion.packed_psum(floats, dcn) if fusion.step_enabled()
                      else [dcn.Allreduce(f.clone()) for f in floats])
            floats = [(s / self.slow_size).to(cast) for s in summed]
        it = iter(floats)
        return [next(it) if p.is_floating_point() else None for p in leaves]

    @torch.no_grad()
    def _blend(self, avg, leaves) -> None:
        """``p = (avg + p) / 2`` in ``p``'s dtype, in place; with one node the
        bf16 round trip of ``p`` (heat_tpu ``_build_sync_fns``)."""
        for a, p in zip(avg, leaves):
            if a is None:
                continue
            if self.slow_size == 1:
                p.copy_(p.to(self.downcast_type).to(p.dtype))
            else:
                p.copy_((a.to(p.dtype) + p) * 0.5)

    def _global_sync(self, params):
        """Capture and blend at once (heat_tpu ``dp_optimizer.py:389``)."""
        leaves, _ = tree_flatten(_tensors(params))
        self._blend(self._capture(leaves), leaves)
        return params

    def step(self, params):
        """Advance the schedule by one batch (heat_tpu ``step``, ``:403``),
        on ``params`` in place; returns ``params``."""
        leaves, _ = tree_flatten(_tensors(params))
        self._batch += 1
        if self._pending is not None and self._batch >= self._pending[0]:
            self._blend(self._pending[1], leaves)
            self._pending = None
        skip = max(1, self.global_skip)
        if self._batch % skip == 0:
            avg = self._capture(leaves)  # the bf16 "send"
            wait = min(self.batches_to_wait, skip)
            if wait <= 0:
                self._blend(avg, leaves)
            else:
                self._pending = (self._batch + wait, avg)
        return params

    def epoch_loss_logic(self, loss) -> None:
        """Adjust the skip cadence from the loss plateau (heat_tpu
        ``epoch_loss_logic``, ``:434``)."""
        self.epoch += 1
        loss = float(loss)
        if self.epoch <= self.warmup_epochs:
            self.global_skip = 1
        elif self.epoch > self.total_epochs - self.cooldown_epochs:
            self.global_skip = 1
        elif self.stability.test_if_improving(loss):
            self.global_skip = min(self.max_global_skips, self.global_skip * 2)
            if self.verbose:
                print(f"DASO: loss plateau -> global_skip={self.global_skip}")
        return None
