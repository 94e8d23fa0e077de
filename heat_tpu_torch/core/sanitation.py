"""Input checks and ``out=`` alignment (heat_tpu ``core/sanitation.py``)."""

from __future__ import annotations

import torch

from . import types
from .dndarray import DNDarray

__all__ = ["sanitize_in", "sanitize_in_tensor", "sanitize_infinity", "sanitize_lshape",
           "sanitize_sequence", "sanitize_out", "sanitize_distribution", "scalar_to_1d"]


def sanitize_in(x) -> None:
    """Raise ``TypeError`` unless ``x`` is a DNDarray (heat_tpu
    ``sanitation.py:32``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, got {type(x)}")


def sanitize_in_tensor(x) -> None:
    """Raise ``TypeError`` unless ``x`` is a backend tensor, a
    ``torch.Tensor`` (heat_tpu ``sanitation.py:38``, whose backend tensor is
    a ``jax.Array``)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input must be a torch.Tensor, got {type(x)}")


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Raise ``ValueError`` unless ``tensor`` has the shape of this rank's
    shard of ``array`` (heat_tpu ``sanitation.py:47``; the port's shards
    are unpadded, so the shape is the chunk's)."""
    tshape = tuple(tensor.shape)
    if array.split is None:
        if tshape != tuple(array.gshape):
            raise ValueError(f"local tensor shape {tshape} does not match global shape "
                             f"{tuple(array.gshape)}")
        return
    expected = tuple(array.comm.chunk(array.gshape, array.split)[1])
    if tshape != expected:
        raise ValueError(f"local tensor shape {tshape} inconsistent with this rank's shard "
                         f"{expected}")


def sanitize_sequence(seq) -> list:
    """A sequence argument as a list (heat_tpu ``sanitation.py:76``)."""
    import numpy as np

    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        return seq.numpy().tolist()
    if isinstance(seq, np.ndarray):
        return seq.tolist()
    raise TypeError(f"seq must be a list, tuple, DNDarray or ndarray, got {type(seq)}")


def sanitize_distribution(*args: DNDarray, target: DNDarray, diff_map=None):
    """Each operand moved to ``target``'s split, out of place where it
    differs (heat_tpu ``sanitation.py:100``); one operand comes back alone,
    several as a tuple."""
    out = []
    for a in args:
        sanitize_in(a)
        out.append(a.resplit(target.split) if a.split != target.split else a)
    return tuple(out) if len(out) != 1 else out[0]


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
