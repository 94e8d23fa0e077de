"""Dispatch core of the data engine (heat_tpu ``data/engine.py``).

Each engine route of :mod:`heat_tpu_torch.data` (the groupby exchange, the
top-k exchange, the order-statistic bisection) dispatches through
:func:`engine_call`, the data-engine sibling of
:func:`heat_tpu_torch.core.fusion.fit_step_call`:

* programs live in a :class:`ProgramCache` of their own (``data_engine.*``
  counters), keyed by the caller's structural signature plus the fusion
  engine's ``quant_key()``/``chunk_key()``/``hier_key()`` tuples; a program
  is a :class:`~heat_tpu_torch.core.fusion._Program`, eager on the CPU and a
  CUDA graph on a card;
* the ``data.exchange.dispatch`` / ``data.stream.carry`` fault sites fire
  before the program runs, and any build, capture or dispatch failure
  replays the caller's eager form with identical results, counted in
  ``data_engine.exchange_fallbacks`` (``data_engine.stream_fallbacks`` for
  the streaming carry); a failure after a donated argument was invalidated
  re-raises.

``HEAT_TPU_TORCH_DATA_ENGINE=0`` in the environment, or :func:`override`,
turns the engine's routes off; every caller then takes its plain path (the
percentiles: the merge-split sort; groupby and top-k: their ``_eager_*``
forms on the logical arrays). heat_tpu's own ``HEAT_TPU_DATA_ENGINE`` does
not reach the port.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from ..utils import metrics
from ..utils.program_cache import ProgramCache

__all__ = ["enabled", "override", "engine_call", "program_cache", "stats", "reset",
           "DATA_ENGINE_COUNTERS"]

_ENABLED = os.environ.get("HEAT_TPU_TORCH_DATA_ENGINE", "1") not in ("", "0", "false", "False")

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

_CACHE = ProgramCache("data_engine", aot=False, counter_prefix="data_engine")


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


def program_cache() -> ProgramCache:
    return _CACHE


def dispatched() -> None:
    """Count one call that took an engine route outside :func:`engine_call`:
    the join (its exchange sizes are read on the host, as heat_tpu's join is
    no engine program either) and each streamed fold."""
    metrics.inc("data_engine.dispatches")


def engine_call(key, build, args, eager, *, site="data.exchange.dispatch",
                fallback_counter="data_engine.exchange_fallbacks"):
    """Dispatch ONE data-engine program through the cache (heat_tpu
    ``engine.py:89``). ``key`` is the caller's structural signature; the
    program key appends the fusion engine's codec tuples. ``build(qk, ck,
    hk)`` returns the program's function over ``args``; ``eager(*args)``
    computes the same without the program, the path of the ``site`` fault
    and of a failed build, capture or dispatch
    (:func:`heat_tpu_torch.core.fusion.dispatch`)."""
    from ..core import fusion

    return fusion.dispatch(_CACHE, ("data",) + tuple(key), build, args, eager, site=site,
                           flush_counter="data_engine.dispatches",
                           fallback_counter=fallback_counter)


def stats() -> dict:
    """The engine's snapshot (heat_tpu ``engine.py:119``): ``enabled``, every
    counter of :data:`DATA_ENGINE_COUNTERS` without its prefix, and the
    program cache's counters."""
    c = metrics.counters()
    short = {k.split(".", 1)[1]: int(c.get(k, 0)) for k in DATA_ENGINE_COUNTERS}
    return {"enabled": _ENABLED, **short, "program_cache": _CACHE.stats()}


def reset() -> None:
    """Drop every cached program."""
    _CACHE.reset()
