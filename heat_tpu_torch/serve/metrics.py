"""Serving metrics and the process's one observability snapshot (heat_tpu
``serve/metrics.py``).

:class:`ServeMetrics` is the registry every
:class:`~heat_tpu_torch.serve.executor.ServingExecutor` reports into
(executors share :data:`DEFAULT` unless given their own): latency
percentiles, batch occupancy, shed and deadline counts.
:func:`runtime_stats` (``ht.runtime_stats()``) folds together, with
heat_tpu's key set:

* ``"serve"``: :data:`DEFAULT`'s snapshot with the live executors' queue
  depth, their program caches, their tenants' admission counters and the
  live decode engines' figures (``"decode"``, :data:`DECODE_STATS_KEYS`);
* ``"resharding"``: :func:`heat_tpu_torch.core.resharding.plan_cache_stats`;
* ``"op_engine"``: ``align_resplits`` (the op tape's counter, 0 until the
  tape is ported) and ``"fusion"``, exactly
  :func:`heat_tpu_torch.core.fusion.stats`;
* ``"data_engine"``: :func:`heat_tpu_torch.data.engine.stats`;
* ``"faults"``: :func:`heat_tpu_torch.utils.faults.stats`;
* ``"counters"``: every counter of :mod:`heat_tpu_torch.utils.metrics`.

All of it is host state: a snapshot never touches the device.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

__all__ = ["ServeMetrics", "DEFAULT", "runtime_stats"]

_WINDOW = 4096  # latency observations kept for the percentile window


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an ascending list (q in [0, 1])."""
    n = len(sorted_vals)
    idx = min(n - 1, max(0, int(round(q * (n - 1)))))
    return sorted_vals[idx]


class ServeMetrics:
    """Thread-safe serving metrics registry."""

    COUNTERS = ("requests", "batches", "rows", "padded_rows", "shed",
                "deadline_expired", "early_shed", "rate_limited",
                "breaker_rejections", "fallback_single", "errors")

    def __init__(self, name: str = "serve", window: int = _WINDOW):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self._latencies = deque(maxlen=window)   # seconds, completed requests
        self._occupancy = deque(maxlen=512)      # rows / bucket per batch

    # ------------------------------------------------------------------ #
    # recording (called by executors)                                    #
    # ------------------------------------------------------------------ #
    def _inc(self, key: str, value: int = 1) -> None:
        from ..utils import metrics as _pm

        with self._lock:
            self._counters[key] += value
        _pm.inc(f"{self.name}.{key}", value)

    def record_request(self, latency_s: float) -> None:
        with self._lock:
            self._counters["requests"] += 1
            self._latencies.append(float(latency_s))
        from ..utils import metrics as _pm

        _pm.inc(f"{self.name}.requests")

    def record_batch(self, n_requests: int, rows: int, bucket: int) -> None:
        with self._lock:
            self._counters["batches"] += 1
            self._counters["rows"] += int(rows)
            self._counters["padded_rows"] += int(bucket) - int(rows)
            if bucket > 0:
                self._occupancy.append(rows / bucket)
        from ..utils import metrics as _pm

        _pm.inc(f"{self.name}.batches")
        _pm.inc(f"{self.name}.rows", int(rows))
        _pm.inc(f"{self.name}.padded_rows", int(bucket) - int(rows))

    def record_shed(self) -> None:
        self._inc("shed")

    def record_deadline_expired(self) -> None:
        self._inc("deadline_expired")

    def record_early_shed(self) -> None:
        """A queued request the EWMA estimator proved cannot meet its
        deadline, shed typed before dispatch (admission control only)."""
        self._inc("early_shed")

    def record_rate_limited(self) -> None:
        self._inc("rate_limited")

    def record_breaker_rejected(self) -> None:
        self._inc("breaker_rejections")

    def record_fallback_single(self) -> None:
        self._inc("fallback_single")

    def record_error(self) -> None:
        self._inc("errors")

    # ------------------------------------------------------------------ #
    # snapshot                                                           #
    # ------------------------------------------------------------------ #
    def snapshot(self, **gauges) -> dict:
        """Plain-dict snapshot; extra keyword gauges (e.g. ``queue_depth``)
        are merged in verbatim."""
        with self._lock:
            counters = dict(self._counters)
            lats = sorted(self._latencies)
            occ = list(self._occupancy)
        out = dict(counters)
        if lats:
            out["latency_ms"] = {
                "count": len(lats),
                "mean": 1e3 * sum(lats) / len(lats),
                "p50": 1e3 * _percentile(lats, 0.50),
                "p95": 1e3 * _percentile(lats, 0.95),
                "p99": 1e3 * _percentile(lats, 0.99),
                "max": 1e3 * lats[-1],
            }
        else:
            out["latency_ms"] = {"count": 0}
        out["batch_occupancy"] = (
            {"count": len(occ), "mean": sum(occ) / len(occ),
             "last": occ[-1]} if occ else {"count": 0})
        out.update(gauges)
        return out

    def reset(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            self._latencies.clear()
            self._occupancy.clear()


#: the registry executors share by default — what ``ht.runtime_stats()`` reads
DEFAULT = ServeMetrics()


def runtime_stats() -> dict:
    """One observability snapshot for the whole process (heat_tpu
    ``serve/metrics.py:146``); see the module's docstring for its keys."""
    from ..core import fusion, resharding
    from ..data import engine as _data_engine
    from ..utils import faults as _faults
    from ..utils import metrics as _pm
    from ..utils.program_cache import ProgramCache
    from . import executor as _executor
    from .admission import TENANT_COUNTERS
    from .decode import live_decode_engines

    depth = 0
    cache_stats = {k: 0 for k in ProgramCache.STATS_KEYS}
    n_exec = 0
    caches = {}  # executors may share a ProgramCache: count each once
    tenants: dict = {}
    breaker_rank = {"closed": 0, "half_open": 1, "open": 2}
    for ex in _executor.live_executors():
        n_exec += 1
        depth += ex.queue_depth
        caches[id(ex.program_cache)] = ex.program_cache
        # the declared counters sum over executors, the breaker reports the
        # worst state, the policy fields keep the first registration seen
        for name, st in ex.tenant_stats().items():
            agg = tenants.setdefault(name, {})
            for k, v in st.items():
                if k in TENANT_COUNTERS:
                    agg[k] = agg.get(k, 0) + int(v)
                elif k == "breaker":
                    if k not in agg or breaker_rank.get(v, 0) > breaker_rank.get(agg[k], 0):
                        agg[k] = v
                else:
                    agg.setdefault(k, v)
    for cache in caches.values():
        for k, v in cache.stats().items():
            cache_stats[k] += v
    counters = _pm.counters()
    slots = 0
    occ_num = 0.0
    for eng in live_decode_engines():
        st = eng.stats()
        slots += st["slots"]
        occ_num += st["occupancy"] * st["slots"]
    decode = {
        "slots": slots,
        "occupancy": (occ_num / slots) if slots else 0.0,
        "prefills": int(counters.get("serve.decode_prefills", 0)),
        "decode_steps": int(counters.get("serve.decode_steps", 0)),
        "tokens_out": int(counters.get("serve.decode_tokens_out", 0)),
        "decode_fallbacks": int(counters.get("serve.decode_fallbacks", 0)),
    }
    return {
        "serve": DEFAULT.snapshot(queue_depth=depth, executors=n_exec, program_cache=cache_stats,
                                  tenants=tenants, decode=decode),
        "resharding": resharding.plan_cache_stats(),
        # heat_tpu's op tape (part (b) of its fusion engine) is not ported:
        # its alignment counter has no writer
        "op_engine": {"align_resplits": int(counters.get("op_engine.align_resplits", 0)),
                      "fusion": fusion.stats()},
        "data_engine": _data_engine.stats(),
        "faults": _faults.stats(),
        "counters": counters,
    }
