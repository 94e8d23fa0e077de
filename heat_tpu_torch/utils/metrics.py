"""A process-local registry of counters, gauges and observation series
(heat_tpu ``utils/metrics.py``), with JSON-lines export:

>>> from heat_tpu_torch.utils import metrics
>>> metrics.inc("steps")
>>> metrics.observe("loss", 0.42)
>>> with metrics.timer("epoch") as t:
...     out = train_one_epoch()
...     t.sync(out)                  # waits for the card before the clock stops
>>> metrics.dump("run_metrics.jsonl", step=10)

Snapshots are sectioned (``counters`` / ``gauges`` / ``series``) so names
never collide across kinds or with ``dump``'s extra fields. ``dump`` clears
the observation series by default, so each JSON line is a window since the
previous dump (counters and gauges persist). The data engine ticks its
``data_engine.*`` counters here and a ``DataStream`` its ``io.stream_chunks``
and ``io.stream_bytes``.
"""

from __future__ import annotations

import json
import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

__all__ = ["Metrics", "Timer", "inc", "gauge", "observe", "timer", "to_dict", "counters",
           "dump", "reset"]


def _jsonable(v):
    """A JSON-safe value: non-finite floats become None (strict JSON has no
    NaN/Infinity), tensors and arrays nested lists, anything else unknown a
    string."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, (int, str, bool, type(None))):
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return _jsonable(tolist())
    try:
        return _jsonable(float(v))
    except (TypeError, ValueError):
        return str(v)


def _wait(value) -> None:
    """Wait until the card has computed ``value`` (a tensor, a DNDarray, or
    a list, tuple or dict of them): one ``torch.cuda.synchronize`` of each
    card they live on."""
    import torch

    stack, cards = [value], set()
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        else:
            t = getattr(v, "larray", v)
            if isinstance(t, torch.Tensor) and t.is_cuda:
                cards.add(t.device)
    for card in cards:
        torch.cuda.synchronize(card)


class Timer:
    """A wall-clock timer that waits for the card (heat_tpu
    ``utils/profiling.py:46``): ``sync(value)`` names the result whose
    computation the duration must cover."""

    def __init__(self, name: str = ""):
        self.name = name
        self.seconds: Optional[float] = None
        self._sync_target = None

    def sync(self, value) -> None:
        self._sync_target = value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_target is not None:
            _wait(self._sync_target)
        self.seconds = time.perf_counter() - self._t0
        return False


class Metrics:
    """A metrics registry: counters, gauges and windowed observations."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._observations: Dict[str, list] = {}
        # the serving workers and their callers tick counters from several
        # threads: a read-modify-write must not lose an increment
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add to a monotonically increasing counter."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: Any) -> None:
        """Set a point-in-time value (kept as it is; may be a tensor)."""
        self._gauges[name] = value

    def observe(self, name: str, value: Any) -> None:
        """Append to a value series (loss curve, step time, ...)."""
        self._observations.setdefault(name, []).append(value)

    @contextmanager
    def timer(self, name: str):
        """Record a wall-clock duration into the ``name`` series; yields a
        :class:`Timer` whose ``sync(value)`` makes it wait for the card."""
        with Timer(name) as t:
            yield t
        self.observe(name, t.seconds)

    def counters(self) -> Dict[str, float]:
        """A copy of the counter section alone (no device read)."""
        with self._lock:
            return dict(self._counters)

    def to_dict(self) -> Dict[str, Any]:
        """Sectioned snapshot with summary statistics per series."""
        series: Dict[str, Any] = {}
        for k, vals in self._observations.items():
            nums = []
            for v in vals:
                try:
                    nums.append(float(v))
                except (TypeError, ValueError):
                    continue
            if nums:
                series[k] = {
                    "count": len(nums),
                    "last": _jsonable(nums[-1]),
                    "mean": _jsonable(sum(nums) / len(nums)),
                    "min": _jsonable(min(nums)),
                    "max": _jsonable(max(nums)),
                }
            else:
                series[k] = {"count": len(vals)}
        return {
            "counters": {k: _jsonable(v) for k, v in self._counters.items()},
            "gauges": {k: _jsonable(v) for k, v in self._gauges.items()},
            "series": series,
        }

    def dump(self, path: str, reset_series: bool = True, **extra) -> Dict[str, Any]:
        """Append one JSON line (snapshot and ``extra`` fields) to ``path``;
        by default clear the series afterwards."""
        record = {"ts": time.time(), **{k: _jsonable(v) for k, v in extra.items()},
                  **self.to_dict()}
        with open(path, "a") as handle:
            # a line either parses strictly or the fault surfaces here
            handle.write(json.dumps(record, allow_nan=False) + "\n")
        if reset_series:
            self._observations.clear()
        return record

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._observations.clear()


_default = Metrics()


def inc(name: str, value: float = 1.0) -> None:
    _default.inc(name, value)


def gauge(name: str, value: Any) -> None:
    _default.gauge(name, value)


def observe(name: str, value: Any) -> None:
    _default.observe(name, value)


def timer(name: str):
    return _default.timer(name)


def to_dict() -> Dict[str, Any]:
    return _default.to_dict()


def counters() -> Dict[str, float]:
    return _default.counters()


def dump(path: str, reset_series: bool = True, **extra) -> Dict[str, Any]:
    return _default.dump(path, reset_series=reset_series, **extra)


def reset() -> None:
    _default.reset()
