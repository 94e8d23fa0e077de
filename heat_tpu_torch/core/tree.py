"""Parameter trees: nested dictionaries, lists and tuples of tensors (the
counterpart of ``jax.tree_util`` for the port's parameter dictionaries)."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

__all__ = ["tree_flatten"]


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)``: the tensors of ``tree`` in a fixed order
    (dictionaries in insertion order), and the function that builds a tree
    of the same structure from a list of that length, in that order."""
    leaves: List[torch.Tensor] = []

    def spec(node):
        if isinstance(node, dict):
            return dict, [(key, spec(val)) for key, val in node.items()]
        if isinstance(node, (list, tuple)):
            return type(node), [spec(val) for val in node]
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"a parameter tree holds tensors, dicts, lists and tuples, got "
                            f"{type(node).__name__}")
        leaves.append(node)
        return None

    structure = spec(tree)

    def unflatten(values):
        values = list(values)
        if len(values) != len(leaves):
            raise ValueError(f"the tree has {len(leaves)} leaves, got {len(values)} values")
        it = iter(values)

        def build(node):
            if node is None:
                return next(it)
            kind, items = node
            if kind is dict:
                return {key: build(val) for key, val in items}
            return kind(build(val) for val in items)

        return build(structure)

    return leaves, unflatten
