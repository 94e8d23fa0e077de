"""Open-loop load generation for the serving executor (heat_tpu
``serve/loadgen.py``).

Closed-loop clients (submit, wait, submit) cannot overload a server: their
arrival rate falls to the service rate. :func:`run_open_loop` submits
Poisson arrivals on a fixed schedule whether or not earlier requests have
finished, one generator thread a :class:`TenantLoad`, and reports per
tenant the outcome of every request (``ok`` or the typed error that shed
it, :func:`classify_outcome`), the latency percentiles (submit to future
done, one ``time.monotonic`` clock) and the count of untyped errors, which
a correct executor keeps at zero. Arrivals and payloads come from
``numpy.random.default_rng(seed)``. ``stall=(at_s, dur_s)`` pauses the
worker for ``dur_s`` from ``at_s``. :func:`estimate_capacity` is the
closed-loop batched service rate that offered loads are scaled against.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from . import errors as _errors

__all__ = ["TenantLoad", "run_open_loop", "estimate_capacity",
           "classify_outcome"]

#: outcome keys every per-tenant report carries (fixed order)
OUTCOMES = ("ok", "overloaded", "rate_limited", "deadline", "circuit_open",
            "closed", "typed_other", "cancelled", "untyped")


def classify_outcome(exc: Optional[BaseException]) -> str:
    """Map a request's terminal exception (None = success) onto the
    outcome taxonomy. Anything outside the typed serve-error family is
    ``untyped`` — the thing the soak acceptance requires to be ZERO."""
    if exc is None:
        return "ok"
    if isinstance(exc, _errors.ServeCircuitOpen):
        return "circuit_open"
    if isinstance(exc, _errors.ServeRateLimited):
        return "rate_limited"
    if isinstance(exc, _errors.ServeDeadlineExceeded):
        return "deadline"
    if isinstance(exc, _errors.ServeOverloaded):
        return "overloaded"
    if isinstance(exc, _errors.ServeClosed):
        return "closed"
    if isinstance(exc, _errors.ServeError):
        return "typed_other"
    return "untyped"


@dataclass
class TenantLoad:
    """One tenant's offered traffic for a phase."""

    tenant: Optional[str]          # None = untagged (default tenant)
    rate_rps: float                # offered Poisson arrival rate
    rows_mix: Sequence[int] = (1, 2, 3)
    deadline_ms: Optional[float] = None  # explicit per-request deadline
    label: Optional[str] = None    # report key; defaults to tenant name

    @property
    def key(self) -> str:
        return self.label or (self.tenant or "default")


def _percentile(sorted_vals, q: float) -> float:
    n = len(sorted_vals)
    idx = min(n - 1, max(0, int(round(q * (n - 1)))))
    return sorted_vals[idx]


@dataclass
class _Recorder:
    lock: threading.Lock = field(default_factory=threading.Lock)
    # key -> list[(outcome, latency_s)]
    recs: dict = field(default_factory=dict)
    untyped_examples: list = field(default_factory=list)

    def record(self, key: str, outcome: str, latency_s: float,
               exc: Optional[BaseException] = None) -> None:
        with self.lock:
            self.recs.setdefault(key, []).append((outcome, latency_s))
            if outcome == "untyped" and len(self.untyped_examples) < 5:
                self.untyped_examples.append(repr(exc)[:200])

    def counts(self) -> int:
        with self.lock:
            return sum(len(v) for v in self.recs.values())


def _gen_thread(ex, load: TenantLoad, duration_s: float, feat_shape,
                dtype, seed: int, rec: _Recorder, offered: dict) -> None:
    rng = np.random.default_rng(seed)
    feat = tuple(int(s) for s in feat_shape)
    # pre-built payload pool: the generator must be able to outrun the
    # server, so per-arrival allocation cost is taken off the hot loop
    pools = {}
    for r in set(int(r) for r in load.rows_mix):
        if np.issubdtype(np.dtype(dtype), np.integer):
            pools[r] = [rng.integers(0, 16, (r,) + feat).astype(dtype)
                        for _ in range(4)]
        else:
            pools[r] = [rng.standard_normal((r,) + feat).astype(dtype)
                        for _ in range(4)]
    mix = [int(r) for r in load.rows_mix]
    key = load.key
    t0 = time.monotonic()
    t_next = t0
    n = 0
    while True:
        t_next += float(rng.exponential(1.0 / load.rate_rps))
        if t_next - t0 > duration_s:
            break
        delay = t_next - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        # open loop: when behind schedule, submit immediately (burst
        # catch-up) — never skip an arrival
        x = pools[mix[n % len(mix)]][n % 4]
        n += 1
        offered[key] = offered.get(key, 0) + 1
        t_sub = time.monotonic()
        try:
            fut = ex.submit(x, deadline_ms=load.deadline_ms,
                            tenant=load.tenant)
        except Exception as exc:
            rec.record(key, classify_outcome(exc),
                       time.monotonic() - t_sub, exc)
            continue

        def _done(f, t_sub=t_sub, key=key):
            t_done = time.monotonic()
            if f.cancelled():
                rec.record(key, "cancelled", t_done - t_sub)
                return
            exc = f.exception()
            rec.record(key, classify_outcome(exc), t_done - t_sub, exc)

        fut.add_done_callback(_done)


def run_open_loop(ex, loads: Sequence[TenantLoad], duration_s: float,
                  feat_shape, dtype=np.float32, seed: int = 0,
                  stall: Optional[tuple] = None,
                  drain_timeout_s: float = 60.0) -> dict:
    """Drive ``ex`` with open-loop Poisson traffic for ``duration_s``.

    One generator thread per :class:`TenantLoad`; ``stall=(at_s, dur_s)``
    pauses the executor's worker for ``dur_s`` starting at ``at_s`` into
    the phase. Returns the per-tenant report (see module docstring).
    Deterministic per ``seed`` up to OS scheduling.
    """
    keys = [load.key for load in loads]
    if len(set(keys)) != len(keys):
        raise ValueError(
            f"TenantLoad report keys must be unique (got {keys}); "
            "set label= to disambiguate two loads on one tenant")
    rec = _Recorder()
    offered: dict = {}
    threads = [
        threading.Thread(
            target=_gen_thread,
            args=(ex, load, duration_s, feat_shape, dtype,
                  seed + 7919 * i, rec, offered),
            name=f"loadgen-{load.key}", daemon=True)
        for i, load in enumerate(loads)
    ]
    stall_th = None
    if stall is not None:
        at_s, dur_s = stall

        def _stall():
            time.sleep(at_s)
            ex.pause()
            time.sleep(dur_s)
            ex.resume()

        stall_th = threading.Thread(target=_stall, name="loadgen-stall",
                                    daemon=True)
    t0 = time.monotonic()
    for th in threads:
        th.start()
    if stall_th is not None:
        stall_th.start()
    for th in threads:
        th.join(duration_s + drain_timeout_s)
    if stall_th is not None:
        stall_th.join(duration_s + drain_timeout_s)
    # drain: every admitted request must terminate (result or typed
    # error) before the report is cut
    ex.flush(timeout=drain_timeout_s)
    deadline = time.monotonic() + drain_timeout_s
    total_offered = sum(offered.values())
    while rec.counts() < total_offered and time.monotonic() < deadline:
        time.sleep(0.01)
    wall = time.monotonic() - t0

    report = {"duration_s": round(duration_s, 3),
              "wall_s": round(wall, 3),
              "seed": int(seed),
              "stall": list(stall) if stall is not None else None,
              "tenants": {}, "totals": {}}
    tot = {k: 0 for k in OUTCOMES}
    tot_offered = 0
    for load in loads:
        key = load.key
        entries = rec.recs.get(key, [])
        out = {k: 0 for k in OUTCOMES}
        lats = []
        for outcome, lat in entries:
            out[outcome] += 1
            if outcome == "ok":
                lats.append(lat)
        lats.sort()
        n_off = int(offered.get(key, 0))
        tot_offered += n_off
        for k in OUTCOMES:
            tot[k] += out[k]
        shed = sum(out[k] for k in ("overloaded", "rate_limited",
                                    "deadline", "circuit_open"))
        t_report = {
            "offered": n_off,
            "offered_rps": round(n_off / max(wall, 1e-9), 1),
            "target_rps": round(float(load.rate_rps), 1),
            "answered": len(entries),
            "shed": shed,
            "outcomes": out,
        }
        if lats:
            t_report["latency_ms"] = {
                "count": len(lats),
                "p50": round(1e3 * _percentile(lats, 0.50), 2),
                "p95": round(1e3 * _percentile(lats, 0.95), 2),
                "p99": round(1e3 * _percentile(lats, 0.99), 2),
                "max": round(1e3 * lats[-1], 2),
            }
        else:
            t_report["latency_ms"] = {"count": 0}
        report["tenants"][key] = t_report
    report["totals"] = {
        "offered": tot_offered,
        "answered": sum(tot.values()),
        "shed": sum(tot[k] for k in ("overloaded", "rate_limited",
                                     "deadline", "circuit_open")),
        "untyped": tot["untyped"],
        "outcomes": tot,
    }
    if rec.untyped_examples:
        report["totals"]["untyped_examples"] = rec.untyped_examples
    return report


def estimate_capacity(ex, feat_shape, rows: int = 1, dtype=np.float32,
                      n: int = 96, seed: int = 0,
                      timeout_s: float = 120.0) -> float:
    """Closed-loop batched throughput estimate (requests/s): submit ``n``
    same-shape requests as fast as possible and wait for all — the
    coalesced service rate the soak phases scale their offered load
    against. Run AFTER ``warmup()`` (compiles would dominate); keep
    ``n`` below the executor's ``queue_limit`` or the estimate sheds."""
    rng = np.random.default_rng(seed)
    feat = tuple(int(s) for s in feat_shape)
    if np.issubdtype(np.dtype(dtype), np.integer):
        x = rng.integers(0, 16, (int(rows),) + feat).astype(dtype)
    else:
        x = rng.standard_normal((int(rows),) + feat).astype(dtype)
    t0 = time.monotonic()
    futs = [ex.submit(x) for _ in range(int(n))]
    for f in futs:
        f.result(timeout_s)
    wall = time.monotonic() - t0
    return n / max(wall, 1e-9)
