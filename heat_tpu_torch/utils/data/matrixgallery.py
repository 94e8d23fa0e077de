"""Test matrices (heat_tpu ``utils/data/matrixgallery.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import devices, types
from ...core.communication import sanitize_comm
from ...core.dndarray import DNDarray

__all__ = ["parter"]


def parter(n: int, split: Optional[int] = None, device=None, comm=None,
           dtype=types.float32) -> DNDarray:
    """The Parter matrix ``A[i, j] = 1 / (i - j + 0.5)``, a Cauchy matrix
    whose singular values cluster at π (heat_tpu ``matrixgallery.py:18``)."""
    comm = sanitize_comm(comm)
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    t = dtype.torch_type()
    i = torch.arange(n, dtype=t, device=device.torch_device)[:, None]
    j = torch.arange(n, dtype=t, device=device.torch_device)[None, :]
    return DNDarray.from_global(1.0 / (i - j + 0.5), split, device, comm, dtype)
