"""Printing (heat_tpu ``core/printing.py``).

A DNDarray prints its logical values, summarized by numpy's print options
(:func:`set_printoptions`). Printing a split array gathers it, a
collective: every rank must print it, and :func:`print0` writes on rank 0
only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_printoptions", "global_printing", "local_printing", "print0",
           "set_printoptions"]

_PRINT_LOCAL = False

_PROFILES = {
    "default": dict(precision=4, threshold=1000, edgeitems=3, linewidth=80),
    "short": dict(precision=2, threshold=1000, edgeitems=2, linewidth=80),
    "full": dict(precision=4, threshold=int(1e9), edgeitems=3, linewidth=80),
}


def get_printoptions() -> dict:
    """The current print options (numpy's, heat_tpu ``printing.py:19``)."""
    return dict(np.get_printoptions())


def global_printing() -> None:
    """Print arrays whole, the default (heat_tpu ``printing.py:24``)."""
    global _PRINT_LOCAL
    _PRINT_LOCAL = False


def local_printing() -> None:
    """Print each rank's own shard instead of the whole array, which needs
    no collective (heat_tpu ``printing.py:30``)."""
    global _PRINT_LOCAL
    _PRINT_LOCAL = True


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only (heat_tpu ``printing.py:36``). A DNDarray
    argument is rendered on every rank first, since that may gather it."""
    from .communication import get_comm

    text = [str(a) for a in args]
    if get_comm().rank == 0:
        print(*text, **kwargs)


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None,
                     profile=None, sci_mode=None) -> None:
    """Configure how arrays print (heat_tpu ``printing.py:45``): a
    ``profile`` (``default``, ``short``, ``full``) first, then the single
    options."""
    if profile is not None:
        if profile not in _PROFILES:
            raise ValueError(f"unknown profile {profile!r}")
        np.set_printoptions(**_PROFILES[profile])
    opts = {"precision": precision, "threshold": threshold, "edgeitems": edgeitems,
            "linewidth": linewidth, "suppress": None if sci_mode is None else not sci_mode}
    opts = {k: v for k, v in opts.items() if v is not None}
    if opts:
        np.set_printoptions(**opts)


def __str__(x) -> str:
    """The text of a DNDarray (heat_tpu ``printing.py:71``): its logical
    values, type, device and split."""
    if _PRINT_LOCAL:
        local = x.larray.detach().cpu()
        if local.dtype == torch.bfloat16:
            local = local.float()
        body = np.array2string(local.numpy(), separator=", ")
        return f"DNDarray(local={body}, dtype=ht.{x.dtype.__name__}, split={x.split})"
    body = np.array2string(np.asarray(x.numpy()), separator=", ")
    return f"DNDarray({body}, dtype=ht.{x.dtype.__name__}, device={x.device}, split={x.split})"
