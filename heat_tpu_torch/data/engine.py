"""The data engine's switch (heat_tpu ``data/engine.py:67-84``).

``HEAT_TPU_DATA_ENGINE=0`` in the environment, or :func:`override`, turns
the engine's routes off; every caller then takes its plain path (the
percentiles: the merge-split sort).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

__all__ = ["enabled", "override"]

_ENABLED = os.environ.get("HEAT_TPU_DATA_ENGINE", "1") not in ("", "0", "false", "False")


def enabled() -> bool:
    """True when the engine's routes are active."""
    return _ENABLED


@contextmanager
def override(flag: bool):
    """Force the engine on or off for the ``with`` block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    try:
        yield
    finally:
        _ENABLED = prev
