"""What the kernel wrappers and the communicators know of the fusion engine's
programs (:mod:`.fusion`), in a module that imports nothing of the port.

* :func:`abstract`: whether a tensor holds no data (a tensor of a step's
  trace, or of the ``meta`` device). A kernel wrapper takes its plain
  version on it, for the shapes, and a collective sends nothing.
* :func:`tally`: while a program's CUDA graph is captured, the kernel
  launches and collectives that the graph records. A wrapper or a
  communicator adds to it in place of its own count, and each replay of the
  graph counts the tally (:class:`.fusion._Program`).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Dict, Iterator, Optional

import torch

__all__ = ["abstract", "tally", "recording"]

_FAKE_TYPE = None


def abstract(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a fake tensor of a step's trace or a
    tensor of the ``meta`` device."""
    global _FAKE_TYPE
    if t.is_meta:
        return True
    if _FAKE_TYPE is None:
        from torch._subclasses.fake_tensor import FakeTensor

        _FAKE_TYPE = FakeTensor
    return isinstance(t, _FAKE_TYPE)


# process-wide: autograd runs a card's backward on a thread of its own, and a
# capture excludes any other work on the card anyway
_TALLY: Optional[Dict[str, Any]] = None
_LOCK = threading.Lock()


def tally() -> Optional[Dict[str, Any]]:
    """The tally of the capture in progress, or None: ``"launches"``, a
    counter by wrapper name, and ``"comm"``, a list of ``(communicator,
    kind, bytes)``."""
    return _TALLY


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, Any]]:
    """A fresh tally for the capture inside the ``with`` block (one capture
    at a time)."""
    global _TALLY
    with _LOCK:
        _TALLY = {"launches": collections.Counter(), "comm": []}
        try:
            yield _TALLY
        finally:
            _TALLY = None
