"""``SGD`` and ``Adam`` as transforms over a parameter tree (heat_tpu
``optim/dp_optimizer.py:31-55``, which returns ``optax.sgd`` and
``optax.adam``).

A :class:`Transform` holds the optimizer's settings; ``tx.init(params)``
builds a ``torch.optim`` optimizer over the tree's tensors (their flat
list, in :func:`~heat_tpu_torch.core.tree.tree_flatten` order), which is the
optimizer state; ``tx.update(grads, opt_state, params)`` applies one step to
the parameters in place. The settings are optax's defaults: Adam with b1 =
0.9, b2 = 0.999, eps = 1e-8 and eps_root = 0, for which optax's update and
``torch.optim.Adam``'s are the same formula up to rounding; SGD with no
momentum. heat_tpu's ``momentum``/``nesterov`` and ``b1``/``b2`` keywords
are not ported: no caller sets them. heat_tpu has no kernel of its own for the update, and neither
has the port: on the card Adam runs PyTorch's fused implementation.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..core.tree import tree_flatten

__all__ = ["SGD", "Adam", "Transform"]


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


def _fused(leaves) -> bool:
    return all(t.device.type == "cuda" for t in leaves)


def SGD(lr: float = 0.01) -> Transform:
    """Stochastic gradient descent, ``p -= lr * g`` (optax ``sgd``)."""
    return Transform("SGD", lambda leaves: torch.optim.SGD(leaves, lr=lr))


def Adam(lr: float = 1e-3) -> Transform:
    """Adam with optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias correction."""
    return Transform("Adam", lambda leaves: torch.optim.Adam(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True if _fused(leaves) else None))
