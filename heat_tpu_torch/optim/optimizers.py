"""The optimizer constructors as transforms over a parameter tree (heat_tpu
``optim/dp_optimizer.py:31-67``, which returns optax transforms).

A :class:`Transform` holds the optimizer's settings; ``tx.init(params)``
builds a ``torch.optim`` optimizer over the tree's tensors (their flat
list, in :func:`~heat_tpu_torch.core.tree.tree_flatten` order), which is the
optimizer state; ``tx.update(grads, opt_state, params)`` applies one step to
the parameters in place.

The formulas and defaults are optax's, as heat_tpu's constructors pass them
(``_make_tx``, ``:31``):

* ``SGD(lr=0.01, momentum=0, nesterov=False)``: optax's trace, which
  ``torch.optim.SGD`` computes alike (no dampening, the first buffer the
  gradient).
* ``Adam(lr=1e-3, b1=0.9, b2=0.999)``, eps 1e-8 outside the square root,
  bias correction: ``torch.optim.Adam``'s formula.
* ``AdamW(lr=1e-3, weight_decay=1e-4)``: optax adds ``weight_decay * p`` to
  the Adam update before scaling by the rate, ``torch.optim.AdamW`` decays
  ``p`` by ``lr * weight_decay`` first: the same step.
* ``Adagrad(lr=1e-2)``: optax's ``scale_by_rss``, the accumulator starting at
  0.1 and eps 1e-7 inside the reciprocal square root (``torch.optim.Adagrad``
  starts at 0 and adds eps outside): written here.
* ``Adadelta(lr=1.0)``: optax's ``scale_by_adadelta``, rho 0.9, eps 1e-6 in
  both square roots: written here.
* ``RMSprop(lr=1e-2)``: optax's ``scale_by_rms``, decay 0.9, eps 1e-8
  inside the reciprocal square root (``torch.optim.RMSprop`` adds it
  outside): written here.

heat_tpu has no kernel of its own for an update, and neither has the port;
on the card Adam and AdamW run PyTorch's fused implementations, made
``capturable`` (the step count on the card) for the eager and the graphed
step alike (:mod:`heat_tpu_torch.core.fusion`), so the two agree bitwise.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..core.tree import tree_flatten

__all__ = ["SGD", "Adam", "AdamW", "Adagrad", "Adadelta", "RMSprop", "Transform"]


class Transform:
    """An optimizer over a parameter tree: ``init(params)`` and
    ``update(grads, opt_state, params)``."""

    def __init__(self, name: str, make: Callable[[List[torch.Tensor]], torch.optim.Optimizer]):
        self.name = name
        self._make = make

    def init(self, params) -> torch.optim.Optimizer:
        """The optimizer state for ``params``: a ``torch.optim`` optimizer
        over its tensors, which it updates in place."""
        return self._make(tree_flatten(params)[0])

    @torch.no_grad()
    def update(self, grads, opt_state: torch.optim.Optimizer, params) -> None:
        """One step of the optimizer on ``params``, in place, with the
        gradients ``grads`` (a tree shaped like ``params``)."""
        leaves, _ = tree_flatten(params)
        g_leaves, _ = tree_flatten(grads)
        held = [p for group in opt_state.param_groups for p in group["params"]]
        if len(held) != len(leaves) or any(a is not b for a, b in zip(held, leaves)):
            raise ValueError(f"opt_state was made by {self.name}.init for other parameters")
        if len(g_leaves) != len(leaves):
            raise ValueError(f"grads hold {len(g_leaves)} tensors, params {len(leaves)}")
        for p, g in zip(leaves, g_leaves):
            p.grad = g
        try:
            opt_state.step()
        finally:
            for p in leaves:
                p.grad = None


def _fused(leaves) -> dict:
    """Adam's and AdamW's implementation settings: fused and capturable on
    the card, PyTorch's default elsewhere."""
    if leaves and all(t.device.type == "cuda" for t in leaves):
        return {"fused": True, "capturable": True}
    return {}


class _Optax(torch.optim.Optimizer):
    """An elementwise optax rule over ``torch.optim``'s parameter groups:
    ``_rule(p, g, state)`` returns the update ``u`` (before the rate) and
    the step applies ``p + (-lr) * u``, as ``optax.apply_updates`` of
    ``scale_by_learning_rate`` does."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init(p, state, group)
                u = self._rule(p.grad, state, group)
                p.add_(u * (-group["lr"]))


class _Adagrad(_Optax):
    """optax ``scale_by_rss``: ``s += g²``; ``u = g / sqrt(s + eps)`` where
    ``s > 0``, else 0."""

    def _init(self, p, state, group):
        state["sum"] = torch.full_like(p, group["initial_accumulator_value"])

    def _rule(self, g, state, group):
        s = g * g + state["sum"]
        state["sum"] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return inv * g


class _RMSprop(_Optax):
    """optax ``scale_by_rms``: ``nu = (1 - decay) g² + decay nu``;
    ``u = g / sqrt(nu + eps)``."""

    def _init(self, p, state, group):
        state["nu"] = torch.full_like(p, group["initial_scale"])

    def _rule(self, g, state, group):
        d = group["decay"]
        nu = (1 - d) * (g * g) + d * state["nu"]
        state["nu"] = nu
        return torch.rsqrt(nu + group["eps"]) * g


class _Adadelta(_Optax):
    """optax ``scale_by_adadelta``: ``e_g = (1 - rho) g² + rho e_g``;
    ``u = sqrt(e_x + eps) / sqrt(e_g + eps) g``; ``e_x = (1 - rho) u² +
    rho e_x``."""

    def _init(self, p, state, group):
        state["e_g"] = torch.zeros_like(p)
        state["e_x"] = torch.zeros_like(p)

    def _rule(self, g, state, group):
        rho, eps = group["rho"], group["eps"]
        e_g = (1 - rho) * (g * g) + rho * state["e_g"]
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        state["e_g"] = e_g
        state["e_x"] = (1 - rho) * (u * u) + rho * state["e_x"]
        return u


def SGD(lr: float = 0.01, momentum: float = 0.0, nesterov: bool = False) -> Transform:
    """Stochastic gradient descent (optax ``sgd``): with ``momentum`` the
    update is the trace ``t = g + momentum * t`` (``g + momentum * t`` again
    with ``nesterov``), then ``p -= lr * update``."""
    return Transform("SGD", lambda leaves: torch.optim.SGD(
        leaves, lr=lr, momentum=momentum, nesterov=nesterov))


def Adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999) -> Transform:
    """Adam with optax's defaults: eps 1e-8, eps_root 0, bias correction."""
    return Transform("Adam", lambda leaves: torch.optim.Adam(
        leaves, lr=lr, betas=(b1, b2), eps=1e-8, **_fused(leaves)))


def AdamW(lr: float = 1e-3, weight_decay: float = 1e-4) -> Transform:
    """AdamW with optax's defaults (heat_tpu passes weight_decay 1e-4)."""
    return Transform("AdamW", lambda leaves: torch.optim.AdamW(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        **_fused(leaves)))


def Adagrad(lr: float = 1e-2) -> Transform:
    """Adagrad as optax computes it: initial accumulator 0.1, eps 1e-7
    inside the reciprocal square root."""
    return Transform("Adagrad", lambda leaves: _Adagrad(
        leaves, lr=lr, initial_accumulator_value=0.1, eps=1e-7))


def Adadelta(lr: float = 1.0) -> Transform:
    """Adadelta as optax computes it: rho 0.9, eps 1e-6."""
    return Transform("Adadelta", lambda leaves: _Adadelta(leaves, lr=lr, rho=0.9, eps=1e-6))


def RMSprop(lr: float = 1e-2) -> Transform:
    """RMSprop as optax computes it: decay 0.9, eps 1e-8 inside the
    reciprocal square root, the second moment starting at 0."""
    return Transform("RMSprop", lambda leaves: _RMSprop(
        leaves, lr=lr, decay=0.9, eps=1e-8, initial_scale=0.0))
