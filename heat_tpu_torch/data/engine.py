"""The data engine's switch and counters (heat_tpu ``data/engine.py:53-84``,
``:119-131``).

``HEAT_TPU_DATA_ENGINE=0`` in the environment, or :func:`override`, turns
the engine's routes off; every caller then takes its plain path (the
percentiles: the merge-split sort; groupby, top-k and join: their
``_eager_*`` forms on the logical arrays).

heat_tpu compiles each engine op into a cached program and replays it
eagerly when a compile or dispatch fails. The port runs the engine's
routes directly, so nothing is cached and nothing is replayed: an error on
an engine route propagates, and ``exchange_fallbacks`` and
``stream_fallbacks`` stay 0. ``data_engine.dispatches`` counts the calls
that took an engine route, where heat_tpu dispatches a program.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from ..utils import metrics

__all__ = ["enabled", "override", "stats", "reset", "DATA_ENGINE_COUNTERS"]

_ENABLED = os.environ.get("HEAT_TPU_DATA_ENGINE", "1") not in ("", "0", "false", "False")

# every counter the engine may tick: stats() reads each, so a counter that
# never ticked reads 0
DATA_ENGINE_COUNTERS = (
    "data_engine.dispatches",
    "data_engine.exchange_fallbacks",
    "data_engine.stream_chunks",
    "data_engine.stream_fallbacks",
    "data_engine.groupby_calls",
    "data_engine.topk_calls",
    "data_engine.quantile_calls",
    "data_engine.join_calls",
)


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


def dispatched() -> None:
    """Count one call that took an engine route."""
    metrics.inc("data_engine.dispatches")


def stats() -> dict:
    """The engine's snapshot: ``enabled`` and every counter of
    :data:`DATA_ENGINE_COUNTERS` without its prefix (heat_tpu's, less its
    ``program_cache`` entry: the port caches no program)."""
    c = metrics.counters()
    short = {k.split(".", 1)[1]: int(c.get(k, 0)) for k in DATA_ENGINE_COUNTERS}
    return {"enabled": _ENABLED, **short}


def reset() -> None:
    """heat_tpu's ``reset`` drops its cached programs; the port caches none,
    so there is nothing to drop."""
