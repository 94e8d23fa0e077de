"""Functional NN ops (heat_tpu ``nn/functional.py``).

heat_tpu passes ``jax.nn`` through with a few losses of its own; here the
same names are torch functions with heat_tpu's defaults (``gelu`` is the
tanh approximation, ``softmax`` and ``log_softmax`` reduce the last axis,
``one_hot`` gives float32 rows and a zero row for an index out of range, as
``jax.nn.one_hot`` does), and any other name passes through to
``torch.nn.functional``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F


def relu(x):
    return torch.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def gelu(x, approximate: bool = True):
    """``jax.nn.gelu``: the tanh approximation unless ``approximate=False``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return _F.silu(x)


swish = silu


def elu(x, alpha: float = 1.0):
    return _F.elu(x, alpha=alpha)


def leaky_relu(x, negative_slope: float = 0.01):
    return _F.leaky_relu(x, negative_slope=negative_slope)


def tanh(x):
    return torch.tanh(x)


def one_hot(x, num_classes: int, dtype=torch.float32, axis: int = -1):
    """``jax.nn.one_hot``: rows of ``dtype`` along a new last axis (or
    ``axis``); an index outside ``[0, num_classes)`` gives a zero row."""
    x = torch.as_tensor(x)
    cls = torch.arange(num_classes, device=x.device)
    out = (x[..., None] == cls).to(dtype)
    return out if axis == -1 else out.movedim(-1, axis)


def cross_entropy(logits, labels, axis: int = -1):
    """The mean cross-entropy of integer ``labels`` against ``logits``
    (heat_tpu ``functional.py:24``)."""
    logp = torch.log_softmax(logits, dim=axis)
    picked = logp.movedim(axis, -1).gather(-1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def mse_loss(pred, target):
    return ((pred - target) ** 2).mean()


def nll_loss(logp, labels, axis: int = -1):
    picked = logp.movedim(axis, -1).gather(-1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def __getattr__(name):
    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(
            f"module 'heat_tpu_torch.nn.functional' has no attribute {name!r}") from None
