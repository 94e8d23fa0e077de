"""Data-parallel training of a torch module (heat_tpu ``nn/data_parallel.py``).

heat_tpu wraps a flax module and runs one fused step with the batch sharded
over its mesh; the port wraps a ``torch.nn.Module`` in Heat's own process
model: every rank holds a replica of the parameters, takes its rows of the
batch, and the gradients are averaged across ranks every step. With a
loss that is a mean over the batch (``loss_is_batch_mean``, the default for
the built-in cross-entropy), rows that divide evenly, a world above one
rank and ``fusion.step_enabled()``, the step is heat_tpu's packed one
(``data_parallel.py:253``): the local gradients and the loss in ONE
flattened all-reduce per dtype (:func:`heat_tpu_torch.core.fusion.packed_psum`),
divided by the world size (the global mean is the mean of equal shards'
means), and the whole step (forward, backward, all-reduce, update) is one
program per batch signature (a CUDA graph on a card), counted in
``op_engine.fusion_step_flushes``. With the switch off such a step sums
each parameter's local-mean gradient in an all-reduce of its own.
Otherwise, or when the rows do not divide evenly, it is the exact form: the
outputs and labels are all-gathered, the loss is taken over the whole batch
on every rank, and each parameter's gradient is summed in an all-reduce of
its own.
heat_tpu's hierarchical tier split of the packed all-reduce is not ported:
the wire is flat.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import fusion, types
from ..core.communication import all_gather, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def _local(x) -> torch.Tensor:
    return x.larray if isinstance(x, DNDarray) else torch.as_tensor(x)


class DataParallel:
    """Data-parallel wrapper around a torch module (heat_tpu
    ``data_parallel.py:36``).

    Parameters
    ----------
    module : torch.nn.Module
        The network, initialized as the caller made it (for instance from
        a flax stack by :func:`heat_tpu_torch.utils.convert.dense_stack_state_from_numpy`).
        :meth:`init` moves it to the device and broadcasts rank 0's
        parameters, so every replica starts alike (heat_tpu's seed-unified
        init); ``seed`` is kept for heat_tpu's signature.
    comm : TorchCommunication, optional
    optimizer : heat_tpu_torch.optim.DataParallelOptimizer, optional
        Required for :meth:`step`.
    loss_fn : callable(logits, y) -> scalar, optional
        Default: the mean cross-entropy of integer labels.
    blocking_parameter_updates : bool
        Kept for heat_tpu's signature.
    loss_is_batch_mean : bool, optional
        Whether ``loss_fn`` is a mean over the batch, which the packed step
        needs; True for the default loss, False for a loss given.
    """

    def __init__(self, module: torch.nn.Module, comm=None, optimizer=None,
                 loss_fn: Optional[Callable] = None, blocking_parameter_updates: bool = False,
                 seed: int = 0, loss_is_batch_mean: Optional[bool] = None):
        self.module = module
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer
        self.blocking_parameter_updates = blocking_parameter_updates
        self.seed = seed
        self.params = None
        if loss_is_batch_mean is None:
            loss_is_batch_mean = loss_fn is None
        self.loss_is_batch_mean = bool(loss_is_batch_mean)
        if loss_fn is None:
            from . import functional

            loss_fn = functional.cross_entropy
        self.loss_fn = loss_fn
        self._packed_steps = None
        if optimizer is not None:
            optimizer._attach(self)

    # ------------------------------------------------------------------ #
    def _device(self, like=None):
        if like is not None:
            return like.device
        from ..core.devices import sanitize_device

        return sanitize_device(None).torch_device

    def init(self, sample_input=None) -> None:
        """Put the module on the device of ``sample_input`` (the default
        device without one) with the parameters of rank 0 on every rank
        (one broadcast a parameter), and make the optimizer state."""
        like = None if sample_input is None else _local(sample_input)
        self.module.to(self._device(like))
        with torch.no_grad():
            for p in self.module.parameters():
                p.copy_(self.comm.Bcast(p.detach().clone(), 0))
        self.params = dict(self.module.named_parameters())
        if self.optimizer is not None:
            self.optimizer.reset_state(self.params)

    def __call__(self, x):
        """The forward of this rank's rows; a split DNDarray comes back as
        one, split like ``x``."""
        if self.params is None:
            self.init(x)
        out = self.module(_local(x))
        if isinstance(x, DNDarray):
            gshape = (x.gshape[0],) + tuple(out.shape[1:])
            return DNDarray(out, gshape, types.canonical_heat_type(out.dtype), x.split,
                            x.device, x.comm)
        return out

    forward = __call__

    # ------------------------------------------------------------------ #
    def _grads(self, bx, by, even: bool):
        """``(loss, grads)`` averaged over the ranks, by the packed or the
        exact form (see the module's docstring)."""
        params = list(self.params.values())
        comm = self.comm
        with torch.enable_grad():
            if comm.size == 1 or (self.loss_is_batch_mean and even):
                loss = self.loss_fn(self.module(bx), by)
                grads = torch.autograd.grad(loss, params)
                if comm.size > 1:
                    if fusion.step_enabled():
                        *grads, loss = fusion.packed_psum(
                            list(grads) + [loss.detach()[None]], comm)
                        loss = loss[0]
                    else:
                        grads = [comm.Allreduce(g.contiguous().clone()) for g in grads]
                        loss = comm.Allreduce(loss.detach().clone())
                    grads = [g / comm.size for g in grads]
                    loss = loss / comm.size
                return loss.detach(), list(grads)
            n = torch.zeros(comm.size, dtype=torch.int64, device=bx.device)
            n[comm.rank] = bx.shape[0]
            counts = [int(c) for c in comm.Allreduce(n)]
            out = all_gather(self.module(bx), comm, 0, counts)
            y = comm.Allgather(by.contiguous(), axis=0, counts=counts)
            loss = self.loss_fn(out, y)
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), [comm.Allreduce(g.contiguous()) for g in grads]

    def _even(self, x) -> bool:
        """Whether the ranks hold equal rows: a split DNDarray's length
        divides over them; tensors are taken as equal shards."""
        return not isinstance(x, DNDarray) or x.gshape[0] % x.comm.size == 0

    def step(self, x, y) -> float:
        """One data-parallel training step on this rank's rows ``x``, ``y``
        (tensors, each rank's of one length, or split-0 DNDarrays whose
        local rows are taken); returns the loss of the whole batch."""
        if self.optimizer is None:
            raise RuntimeError("an optimizer is required for step()")
        if self.params is None:
            self.init(x)
        bx, by = _local(x), _local(y)
        if (fusion.step_enabled() and self.loss_is_batch_mean and self.comm.size > 1
                and self._even(x)):
            return float(self._packed_step(bx, by))
        loss, grads = self._grads(bx, by, self._even(x))
        self._update(grads)
        return float(loss)

    def _update(self, grads) -> None:
        self.optimizer.tx.update(dict(zip(self.params, grads)), self.optimizer.opt_state,
                                 self.params)

    def _packed_step(self, bx, by) -> torch.Tensor:
        """heat_tpu's packed train step (``_build_packed_train_step``,
        ``data_parallel.py:167``) as one program per batch signature
        (:func:`heat_tpu_torch.core.fusion.dispatch`, no eager fallback);
        returns the loss of the whole batch."""
        from ..utils.program_cache import ProgramCache

        if self._packed_steps is None:
            self._packed_steps = ProgramCache("dp_step", aot=False,
                                              counter_prefix="nn.dp_step")

        def body(bx, by):
            loss, grads = self._grads(bx, by, True)
            self._update(grads)
            return loss

        key = (id(self.optimizer.opt_state), tuple(bx.shape), bx.dtype, tuple(by.shape),
               by.dtype, str(bx.device))
        return fusion.dispatch(self._packed_steps, key, lambda *codecs: body, (bx, by),
                               flush_counter="op_engine.fusion_step_flushes")

    def local_loss(self, x, y) -> float:
        with torch.no_grad():
            return float(self.loss_fn(self.module(_local(x)), _local(y)))


class DataParallelMultiGPU(DataParallel):
    """The two-tier trainer (heat_tpu ``data_parallel.py:304``) over a
    :class:`heat_tpu_torch.optim.DASO`: each step averages the gradients
    inside the node (the fast tier, one packed all-reduce) and advances the
    node's replica on the node's rows; then DASO's schedule reconciles the
    replicas over the slow tier. :meth:`step` returns the node's loss (the
    mean over the node's rows); heat_tpu returns the mean of the nodes'."""

    def __init__(self, module: torch.nn.Module, optimizer, comm=None, **kwargs):
        if not hasattr(optimizer, "global_skip"):
            raise TypeError("DataParallelMultiGPU requires a heat_tpu_torch.optim.DASO")
        super().__init__(module, comm=comm, optimizer=optimizer.local_optimizer, **kwargs)
        self.daso = optimizer
        self.fast = optimizer.grid.axis("ici")

    def step(self, x, y) -> float:
        if self.params is None:
            self.init(x)
        world, self.comm = self.comm, self.fast
        try:
            loss, grads = self._grads(_local(x), _local(y), self._even(x))
        finally:
            self.comm = world
        self._update(grads)
        self.daso.step(self.params)
        return float(loss)

    def __call__(self, x):
        """The forward with the replicas' average (one all-reduce over the
        slow tier)."""
        if self.params is None:
            self.init(x)
        avg = self.daso.unreplicate(self.params)
        out = torch.func.functional_call(self.module, avg, (_local(x),))
        if isinstance(x, DNDarray):
            gshape = (x.gshape[0],) + tuple(out.shape[1:])
            return DNDarray(out, gshape, types.canonical_heat_type(out.dtype), x.split,
                            x.device, x.comm)
        return out

    forward = __call__
