"""Input checks and ``out=`` alignment (heat_tpu ``core/sanitation.py``)."""

from __future__ import annotations

import torch

from . import types
from .dndarray import DNDarray

__all__ = ["sanitize_in", "sanitize_infinity", "sanitize_out", "scalar_to_1d"]


def sanitize_in(x) -> None:
    """Raise ``TypeError`` unless ``x`` is a DNDarray (heat_tpu
    ``sanitation.py:32``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, got {type(x)}")


def sanitize_infinity(x):
    """The largest value of ``x``'s type: its integer maximum for exact
    types, else ``inf`` (heat_tpu ``sanitation.py:66``)."""
    dt = x.dtype if isinstance(x, DNDarray) else types.canonical_heat_type(x.dtype)
    if types.heat_type_is_exact(dt):
        return torch.iinfo(dt.torch_type()).max
    return float("inf")


def sanitize_out(out, output_shape, output_split, output_device, output_comm=None) -> None:
    """Check an ``out=`` buffer against a result's shape and move it to the
    result's split in place (heat_tpu ``sanitation.py:89``)."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")
    if out.split != output_split:
        out.resplit_(output_split)


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d DNDarray as shape ``(1,)``; any other is returned as it is
    (heat_tpu ``sanitation.py:115``)."""
    if x.ndim == 0:
        return DNDarray(x.larray.reshape(1), (1,), x.dtype, None, x.device, x.comm)
    return x
