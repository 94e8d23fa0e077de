"""Multi-tenant admission control for the serving executor (heat_tpu
``serve/admission.py``).

One :class:`AdmissionController` per executor (or decode engine) owns:

* **the tenant registry**: ``register(name, priority=, slo_ms=,
  max_queue=, rate_limit=)``. Priority orders the queue (higher first,
  FIFO within one), ``slo_ms`` is the default deadline of the tenant's
  requests, ``max_queue`` its quota of queued requests, ``rate_limit`` a
  token bucket (burst one second's worth) that sheds with
  :class:`~heat_tpu_torch.serve.errors.ServeRateLimited`;
* **a circuit breaker per tenant**: ``breaker_failures`` consecutive
  batch failures after their retry open it, and its requests then fail at
  admission with :class:`~heat_tpu_torch.serve.errors.ServeCircuitOpen`.
  After ``breaker_cooldown_s`` it goes half-open and admits at most
  ``half_open_max`` probes; a successful batch closes it, a failed one
  opens it again. Every tenant of a failed batch takes the failure;
* **an EWMA of each request group's batch service time**, which the
  executor's early shed reads: a queued request whose deadline cannot
  survive one more batch is failed with ``ServeDeadlineExceeded`` before
  it takes a batch slot.

Everything is host state on one clock (``time.monotonic``, injectable for
tests). The controller has its own lock and never takes the executor's:
the lock order is executor, then controller. The decision and the breaker
consult are fault sites (``serve.admission.decide``,
``serve.breaker.probe``), and both fail open (the request is admitted).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..utils import faults as _faults
from ..utils import metrics as _pm
from .errors import ServeCircuitOpen, ServeRateLimited

__all__ = ["Tenant", "AdmissionController", "DEFAULT_TENANT"]

#: the implicit tenant untagged ``submit()`` calls ride once a registry
#: exists — priority 0, no quota/rate/SLO (auto-registered on first use)
DEFAULT_TENANT = "default"

#: per-tenant counter keys, in the order tenant_stats() reports them
TENANT_COUNTERS = (
    "admitted", "completed", "shed", "rate_limited", "deadline_expired",
    "early_shed", "breaker_rejections", "breaker_opens",
    "dispatch_failures",
)


@dataclass
class Tenant:
    """One tenant's registered policy (all host-side; ``None`` = off /
    controller default)."""

    name: str
    priority: int = 0                       # higher = admitted/served first
    slo_ms: Optional[float] = None          # default per-request deadline
    max_queue: Optional[int] = None         # per-tenant queued-request quota
    rate_limit: Optional[float] = None      # sustained requests/s
    burst: Optional[float] = None           # bucket capacity; default = 1 s
    breaker_failures: Optional[int] = None      # consecutive-failure trip
    breaker_cooldown_s: Optional[float] = None  # open -> half-open delay
    half_open_max: Optional[int] = None         # probe budget per cooldown


class _TenantState:
    """Mutable per-tenant runtime state (under the controller lock)."""

    __slots__ = ("tokens", "refill_t", "breaker", "streak", "opened_t",
                 "half_open_t", "half_open_used", "counters")

    def __init__(self, tenant: Tenant, now: float):
        self.tokens = (None if tenant.rate_limit is None
                       else _bucket_burst(tenant))
        self.refill_t = now
        self.breaker = "closed"      # closed | open | half_open
        self.streak = 0              # consecutive post-retry batch failures
        self.opened_t = 0.0
        self.half_open_t = 0.0
        self.half_open_used = 0
        self.counters: Dict[str, int] = {k: 0 for k in TENANT_COUNTERS}


# FIFO tiebreaker within a priority level, shared by the executor's and the
# decode engine's queues (CPython next() is atomic)
_SEQ = itertools.count()


def next_seq() -> int:
    """The next arrival number: FIFO order within one priority."""
    return next(_SEQ)


def insert_by_priority(q: list, req) -> None:
    """Insert ``req`` into ``q`` (the caller holds its lock): descending
    ``priority``, FIFO (``seq``) within a priority. Uniform-priority
    traffic appends in O(1), exactly the order of one FIFO."""
    key = (-req.priority, req.seq)
    i = len(q)
    while i > 0 and (-q[i - 1].priority, q[i - 1].seq) > key:
        i -= 1
    q.insert(i, req)


def _bucket_burst(tenant: Tenant) -> float:
    if tenant.burst is not None:
        return float(tenant.burst)
    return max(1.0, float(tenant.rate_limit))


class AdmissionController:
    """Tenant registry + admission state machine for one executor."""

    DEFAULT_BREAKER_FAILURES = 3
    DEFAULT_BREAKER_COOLDOWN_S = 1.0
    DEFAULT_HALF_OPEN_MAX = 2
    EWMA_ALPHA = 0.25           # service-estimator smoothing
    _MAX_GROUPS = 128           # estimator key-space bound

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}
        self._state: Dict[str, _TenantState] = {}
        # group -> EWMA seconds of a successful batch dispatch; keyed by
        # the request group (trailing shape + dtype — the thing that
        # decides which bucket family a batch lands in). Early shed runs
        # before the batch's bucket is computed, so finer per-bucket
        # state would have no reader.
        self._ewma: Dict = {}

    # ------------------------------------------------------------------ #
    # registry                                                           #
    # ------------------------------------------------------------------ #
    def register(self, name: str, **policy) -> Tenant:
        """Register (or re-register with new policy — ops tuning) a
        tenant. Counters and breaker state survive a re-register."""
        tenant = Tenant(name=str(name), **policy)
        if tenant.rate_limit is not None and tenant.rate_limit <= 0:
            raise ValueError(
                f"tenant {name!r}: rate_limit must be > 0, got "
                f"{tenant.rate_limit}")
        if tenant.max_queue is not None and tenant.max_queue < 1:
            raise ValueError(
                f"tenant {name!r}: max_queue must be >= 1, got "
                f"{tenant.max_queue}")
        with self._lock:
            self._tenants[tenant.name] = tenant
            st = self._state.get(tenant.name)
            if st is None:
                self._state[tenant.name] = _TenantState(tenant, self._clock())
            else:
                # policy update: re-prime the token bucket to the NEW
                # rate/burst (counters and breaker state survive)
                st.tokens = (None if tenant.rate_limit is None
                             else _bucket_burst(tenant))
                st.refill_t = self._clock()
        return tenant

    def resolve(self, name: Optional[str]) -> str:
        """Validated tenant name; ``None`` maps to the implicit
        :data:`DEFAULT_TENANT` (auto-registered, priority 0)."""
        if name is None:
            with self._lock:
                if DEFAULT_TENANT not in self._tenants:
                    t = Tenant(name=DEFAULT_TENANT)
                    self._tenants[DEFAULT_TENANT] = t
                    self._state[DEFAULT_TENANT] = _TenantState(
                        t, self._clock())
            return DEFAULT_TENANT
        name = str(name)
        if name not in self._tenants:
            raise ValueError(
                f"unknown tenant {name!r}; registered: "
                f"{sorted(self._tenants)} (register_tenant() first)")
        return name

    def get(self, name: str) -> Tenant:
        return self._tenants[name]

    def priority(self, name: str) -> int:
        return int(self._tenants[name].priority)

    def slo_ms(self, name: str) -> Optional[float]:
        return self._tenants[name].slo_ms

    @property
    def tenants(self) -> Dict[str, Tenant]:
        with self._lock:
            return dict(self._tenants)

    # ------------------------------------------------------------------ #
    # admission-time checks (called from submit, executor lock held)     #
    # ------------------------------------------------------------------ #
    def check_tenant(self, name: str, consume_token: bool = True) -> None:
        """Breaker consult (+ token bucket unless ``consume_token`` is
        False) for one incoming request. Raises the typed rejection
        (:class:`ServeCircuitOpen` / :class:`ServeRateLimited`) and ticks
        the per-tenant counter. The executor passes
        ``consume_token=False`` and takes the token LAST
        (:meth:`take_token`), after the quota check — a request shed for
        quota must not drain the bucket and misattribute later
        rejections to the rate limit."""
        now = self._clock()
        with self._lock:
            tenant = self._tenants[name]
            st = self._state[name]
            # chaos site: a broken breaker consult FAILS OPEN — the
            # request is admitted and the dispatch path stays the health
            # authority (doc/robustness.md)
            try:
                _faults.check("serve.breaker.probe")
                allowed = self._breaker_allows(tenant, st, now)
            except Exception:
                _pm.inc("serve.breaker_fallbacks")
                allowed = True
            if not allowed:
                st.counters["breaker_rejections"] += 1
                _pm.inc("serve.breaker_rejections")
                raise ServeCircuitOpen(
                    f"tenant {name!r} circuit breaker is open (recent "
                    f"batch dispatches failed persistently; probes resume "
                    f"after the "
                    f"{self._cooldown(tenant):.3g}s cool-down)")
            if consume_token:
                self._take_token(tenant, st, now)

    def take_token(self, name: str) -> None:
        """Consume one rate-limit token (no-op for unlimited tenants);
        raises the typed :class:`ServeRateLimited` when the bucket is
        empty."""
        now = self._clock()
        with self._lock:
            self._take_token(self._tenants[name], self._state[name], now)

    def refund_token(self, name: str) -> None:
        """Return a token taken for a request that was subsequently shed
        (e.g. shared queue full with no preemptible victim) — the tenant
        never got service for it, so it must not count against the rate."""
        with self._lock:
            tenant = self._tenants.get(name)
            st = self._state.get(name)
            if (tenant is None or st is None or tenant.rate_limit is None
                    or st.tokens is None):
                return
            st.tokens = min(_bucket_burst(tenant), st.tokens + 1.0)

    def _take_token(self, tenant: Tenant, st: _TenantState,
                    now: float) -> None:
        if tenant.rate_limit is None:
            return
        rate = float(tenant.rate_limit)
        burst = _bucket_burst(tenant)
        if st.tokens is None:  # policy gained a limit later
            st.tokens = burst
            st.refill_t = now
        st.tokens = min(burst, st.tokens + (now - st.refill_t) * rate)
        st.refill_t = now
        if st.tokens < 1.0:
            st.counters["rate_limited"] += 1
            raise ServeRateLimited(
                f"tenant {tenant.name!r} over its rate limit "
                f"({rate:g} req/s, burst {burst:g})")
        st.tokens -= 1.0

    def _cooldown(self, tenant: Tenant) -> float:
        return (tenant.breaker_cooldown_s
                if tenant.breaker_cooldown_s is not None
                else self.DEFAULT_BREAKER_COOLDOWN_S)

    def _breaker_allows(self, tenant: Tenant, st: _TenantState,
                        now: float) -> bool:
        if st.breaker == "closed":
            return True
        cooldown = self._cooldown(tenant)
        if st.breaker == "open":
            if now - st.opened_t < cooldown:
                return False                      # fast fail
            st.breaker = "half_open"              # cool-down elapsed
            st.half_open_t = now
            st.half_open_used = 0
        hmax = (tenant.half_open_max if tenant.half_open_max is not None
                else self.DEFAULT_HALF_OPEN_MAX)
        if now - st.half_open_t >= cooldown:
            # probes admitted earlier never produced a batch outcome
            # (shed on deadline, executor closed) — replenish the budget
            # instead of wedging half-open forever
            st.half_open_t = now
            st.half_open_used = 0
        if st.half_open_used >= hmax:
            return False
        st.half_open_used += 1
        return True

    # ------------------------------------------------------------------ #
    # dispatch outcomes (called from the worker thread, no executor lock)#
    # ------------------------------------------------------------------ #
    def on_batch_outcome(self, names, ok: bool) -> None:
        """Feed one batch's final dispatch outcome (post-retry) into the
        breaker state machine for every tenant that had requests in it."""
        now = self._clock()
        with self._lock:
            for name in names:
                tenant = self._tenants.get(name)
                st = self._state.get(name)
                if tenant is None or st is None:
                    continue
                if ok:
                    st.streak = 0
                    if st.breaker != "closed":
                        # a successful dispatch is proof of health whether
                        # it was a half-open probe or a request admitted
                        # before the breaker opened
                        st.breaker = "closed"
                    continue
                st.counters["dispatch_failures"] += 1
                st.streak += 1
                trip = (tenant.breaker_failures
                        if tenant.breaker_failures is not None
                        else self.DEFAULT_BREAKER_FAILURES)
                if st.breaker == "half_open" or st.streak >= trip:
                    if st.breaker != "open":
                        st.counters["breaker_opens"] += 1
                        _pm.inc("serve.breaker_open")
                    st.breaker = "open"
                    st.opened_t = now
                    st.streak = 0

    def observe_service(self, group, bucket: int, dt_s: float) -> None:
        """EWMA-fold one successful batch's dispatch duration (``bucket``
        rides along for callers' logging; the estimate is per group)."""
        with self._lock:
            if len(self._ewma) > self._MAX_GROUPS:
                self._ewma.clear()
            a = self.EWMA_ALPHA
            prev = self._ewma.get(group)
            self._ewma[group] = (dt_s if prev is None
                                 else (1 - a) * prev + a * dt_s)

    def estimate_service_s(self, group) -> Optional[float]:
        """EWMA batch service time for ``group`` (None until observed) —
        the early-shed bound: a queued request whose ``now + estimate``
        exceeds its deadline provably cannot meet it."""
        with self._lock:
            return self._ewma.get(group)

    # ------------------------------------------------------------------ #
    # accounting / introspection                                         #
    # ------------------------------------------------------------------ #
    def count(self, name: Optional[str], key: str, n: int = 1) -> None:
        if name is None:
            return
        with self._lock:
            st = self._state.get(name)
            if st is not None:
                st.counters[key] += n

    def breaker_state(self, name: str) -> str:
        with self._lock:
            st = self._state.get(name)
            return st.breaker if st is not None else "closed"

    def tenant_stats(self) -> dict:
        """JSON-ready per-tenant snapshot: policy + counters + breaker."""
        with self._lock:
            out = {}
            for name, tenant in self._tenants.items():
                st = self._state[name]
                out[name] = {
                    "priority": int(tenant.priority),
                    "slo_ms": tenant.slo_ms,
                    "max_queue": tenant.max_queue,
                    "rate_limit": tenant.rate_limit,
                    "breaker": st.breaker,
                    **{k: int(v) for k, v in st.counters.items()},
                }
            return out
