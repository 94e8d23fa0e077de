"""The batching, backpressured serving executor (heat_tpu
``serve/executor.py``).

Callers submit per-request host arrays from any thread; one worker thread
coalesces them into micro-batches, pads each onto a shape bucket, runs the
model callable's program for that bucket from the
:class:`~heat_tpu_torch.serve.program_cache.ProgramCache` (one host-to-device
copy of the batch, the model's kernels on the card, one device-to-host
fetch of the result) and scatters the rows back onto per-request futures.

* **Bounded admission.** ``submit`` never blocks and never queues past
  ``queue_limit``: an overloaded executor sheds at the door with
  :class:`~heat_tpu_torch.serve.errors.ServeOverloaded`.
* **Tenants (opt-in).** ``register_tenant(name, priority=, slo_ms=,
  max_queue=, rate_limit=)`` arms an
  :class:`~heat_tpu_torch.serve.admission.AdmissionController`: a
  priority-ordered queue (a full queue evicts the youngest request of a
  lower priority), per-tenant quotas, token buckets
  (:class:`ServeRateLimited`), a circuit breaker (:class:`ServeCircuitOpen`)
  and the EWMA early shed. With no tenant registered none of it runs.
* **Micro-batching.** The worker takes the oldest request, then up to
  ``max_batch`` requests of the same trailing shape and dtype, waiting at
  most ``max_wait_ms`` for stragglers; rows concatenate and zero-pad to the
  bucket.
* **One dispatch thread.** Only the worker touches the device. On a card
  it makes the model's card current in its thread, and the batch's copy,
  the kernels (``kernels._launch`` takes the thread's current stream) and
  the fetch run on that thread's current stream, in order.
* **Deadlines** expire queued requests into :class:`ServeDeadlineExceeded`
  without running them. A failed batch is retried once
  (``serve.batch_retries``) with the same program, never another one;
  ``batching=False`` or a bucket past ``max_bucket_bytes`` runs requests one
  at a time. ``close(drain=True)`` answers what is queued,
  ``close(drain=False)`` fails it with :class:`ServeClosed`.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .admission import insert_by_priority, next_seq
from .bucketing import Pow2Buckets, bucket_nbytes
from .errors import (ServeCircuitOpen, ServeClosed, ServeDeadlineExceeded,
                     ServeError, ServeOverloaded, ServeRateLimited)
from .metrics import DEFAULT as _DEFAULT_METRICS, ServeMetrics
from .program_cache import ProgramCache

__all__ = ["ServeConfig", "ServingExecutor", "live_executors"]

# live executors (weak): runtime_stats() folds their queue depth and
# program-cache counters into the one observability snapshot
_EXECUTORS: "weakref.WeakSet[ServingExecutor]" = weakref.WeakSet()


def live_executors():
    return list(_EXECUTORS)


@dataclass
class ServeConfig:
    """Executor policy knobs (all host-side; none affect results)."""

    max_batch: int = 16                 # max requests coalesced per program run
    max_wait_ms: float = 2.0            # straggler wait once a batch has begun
    queue_limit: int = 128              # admission bound -> ServeOverloaded
    default_deadline_ms: Optional[float] = None  # per-request override wins
    batching: bool = True               # False -> degraded single-request path
    min_rows: int = 1                   # bucket floor (mesh divisibility)
    bucket_rows: Optional[Callable[[int], int]] = None  # rows -> bucket rows
    max_bucket_bytes: Optional[int] = None  # memory cap -> single-request path

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {self.queue_limit}")
        if self.bucket_rows is None:
            self.bucket_rows = Pow2Buckets(min_rows=self.min_rows)


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tuple, list or dict tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_host(a):
    """A numpy copy of a tensor leaf (its stream synchronized); other
    leaves as numpy arrays."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _Request:
    # clock discipline: enq_t and deadline_t are BOTH time.monotonic()
    # stamps — the early-shed estimate and _expire compare against the
    # same clock end-to-end; never mix in time.time() here (a wall-clock
    # jump would dispatch expired requests or shed live ones)
    __slots__ = ("x", "rows", "group", "enq_t", "deadline_t", "future",
                 "started", "tenant", "priority", "seq")

    def __init__(self, x: np.ndarray, deadline_t: Optional[float],
                 tenant: Optional[str] = None, priority: int = 0):
        self.x = x
        self.rows = x.shape[0]
        self.group = (x.shape[1:], x.dtype.str)
        self.enq_t = time.monotonic()
        self.deadline_t = deadline_t
        self.future = Future()
        self.started = False  # set_running_or_notify_cancel already called
        self.tenant = tenant
        self.priority = priority
        self.seq = next_seq()


class ServingExecutor:
    """Micro-batching inference front end for one model callable (heat_tpu
    ``executor.py:131``).

    Parameters
    ----------
    model_fn : callable
        ``batch -> result``: takes one ``(bucket_rows, *feat)`` tensor on
        ``device`` and returns a tensor (or a tuple, list or dict of them)
        whose leaves carry the batch dimension first. Row ``i`` of the
        output must depend on row ``i`` of the input alone, which makes the
        scatter-back exact. Adapters for the transformer LM and the
        estimators are in :mod:`heat_tpu_torch.serve.adapters`.
    config : ServeConfig, optional
    cache_token : hashable, optional
        Extra program-cache key material.
    metrics : ServeMetrics, optional
        Defaults to the process-wide registry
        (:data:`heat_tpu_torch.serve.metrics.DEFAULT`).
    program_cache : ProgramCache, optional
        Defaults to a private cache; pass a shared one to pool programs.

    Batches run on ``model_fn.device`` where the callable has one (the
    adapters set it), else on the port's default device (the card, unless
    ``use_device("cpu")``). Always ``close()`` an executor you are done
    with (or use it as a context manager): the worker thread holds a
    reference to it.
    """

    def __init__(self, model_fn: Callable, config: Optional[ServeConfig] = None,
                 *, name: str = "serve", cache_token: Any = (),
                 metrics: Optional[ServeMetrics] = None,
                 program_cache: Optional[ProgramCache] = None):
        device = getattr(model_fn, "device", None)
        if device is None:
            from ..core import devices

            device = devices.get_device().torch_device
        self.device = torch.device(device)
        self.stream = None  # the worker's current stream on a card
        self.model_fn = model_fn
        self.config = config if config is not None else ServeConfig()
        self.name = name
        self.cache_token = cache_token
        self.metrics = metrics if metrics is not None else _DEFAULT_METRICS
        self.program_cache = (program_cache if program_cache is not None
                              else ProgramCache(name=name))
        self._q: list = []
        self._cv = threading.Condition()
        self._admission = None  # AdmissionController once a tenant registers
        self._closed = False
        self._draining = False
        self._paused = False
        self._inflight = 0
        self._worker = threading.Thread(
            target=self._run, name=f"heat-serve-{name}", daemon=True)
        self._worker.start()
        _EXECUTORS.add(self)

    # ------------------------------------------------------------------ #
    # submission                                                         #
    # ------------------------------------------------------------------ #
    def submit(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        ``x``: ``(rows, *feat)`` host array or tensor; axis 0 is the row
        axis (a single example is ``rows=1``). The future resolves to the
        model output rows of exactly this request as numpy arrays: the
        batch output is fetched to the host once, then each request gets a
        copy of its rows (so no result pins the batch buffer), or raises
        one of the typed serve errors.

        ``tenant``: requires :meth:`register_tenant` first; the request
        is admitted under that tenant's priority/quota/rate/breaker
        policy, and — when ``deadline_ms`` is not given and the config
        has no default — inherits the tenant's ``slo_ms`` as its
        deadline. With a registry active, ``tenant=None`` rides the
        implicit priority-0 ``"default"`` tenant.
        """
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(
                f"request must have a leading row axis of >= 1, got shape "
                f"{x.shape}")
        adm = self._admission
        if adm is not None:
            tname = adm.resolve(tenant)  # unknown tenant -> ValueError
        elif tenant is not None:
            raise ValueError(
                f"submit(tenant={tenant!r}) needs register_tenant() first")
        else:
            tname = None
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
            if deadline_ms is None and adm is not None:
                deadline_ms = adm.slo_ms(tname)
        deadline_t = (None if deadline_ms is None
                      else time.monotonic() + deadline_ms / 1e3)
        req = _Request(x, deadline_t, tenant=tname)
        evicted = None
        with self._cv:
            if self._closed:
                raise ServeClosed(f"executor {self.name!r} is closed")
            if adm is None:
                if len(self._q) >= self.config.queue_limit:
                    self.metrics.record_shed()
                    raise ServeOverloaded(
                        f"executor {self.name!r} queue is full "
                        f"({self.config.queue_limit} pending)")
                self._q.append(req)
            else:
                evicted = self._admit(req)
            self._cv.notify_all()
        if evicted is not None:
            # fail the preempted future OUTSIDE the lock (done-callbacks
            # run synchronously — the close() lesson)
            if evicted.future.set_running_or_notify_cancel():
                evicted.future.set_exception(ServeOverloaded(
                    f"executor {self.name!r} queue is full "
                    f"({self.config.queue_limit} pending); preempted by a "
                    f"higher-priority tenant"))
        return req.future

    def register_tenant(self, name: str, *, priority: int = 0,
                        slo_ms: Optional[float] = None,
                        max_queue: Optional[int] = None,
                        rate_limit: Optional[float] = None, **policy):
        """Register a tenant (idempotent; re-registering updates policy)
        and switch admission onto the multi-tenant path. Extra ``policy``
        kwargs: ``burst``, ``breaker_failures``, ``breaker_cooldown_s``,
        ``half_open_max`` (see :class:`~heat_tpu_torch.serve.admission.Tenant`).
        Returns the :class:`Tenant` record."""
        from .admission import AdmissionController

        with self._cv:
            if self._admission is None:
                self._admission = AdmissionController()
            adm = self._admission
        return adm.register(name, priority=priority, slo_ms=slo_ms,
                            max_queue=max_queue, rate_limit=rate_limit,
                            **policy)

    @property
    def admission(self):
        """The executor's ``AdmissionController`` (None until a tenant
        registers — the backward-compatible single-FIFO path)."""
        return self._admission

    def tenant_stats(self) -> dict:
        """Per-tenant counters/breaker snapshot ({} with no registry)."""
        adm = self._admission
        return adm.tenant_stats() if adm is not None else {}

    def _admit(self, req: _Request):
        """Multi-tenant admission (lock held). Returns a preempted queued
        request to fail outside the lock, or None. Raises the typed
        rejection errors; any *machinery* failure degrades this request
        to the legacy bounded-FIFO admission (fail-open: a bug in the new
        admission path must never be an outage the old path lacked)."""
        from ..utils import faults as _faults
        from ..utils import metrics as _pm

        adm = self._admission
        cfg = self.config
        try:
            _faults.check("serve.admission.decide")
            try:
                adm.check_tenant(req.tenant, consume_token=False)
            except ServeCircuitOpen:
                self.metrics.record_breaker_rejected()
                raise
            tenant = adm.get(req.tenant)
            req.priority = int(tenant.priority)  # before the victim scan
            if tenant.max_queue is not None:
                queued = sum(1 for r in self._q if r.tenant == req.tenant)
                if queued >= tenant.max_queue:
                    adm.count(req.tenant, "shed")
                    self.metrics.record_shed()
                    raise ServeOverloaded(
                        f"tenant {req.tenant!r} queue quota is full "
                        f"({tenant.max_queue} pending)")
            # the token is taken LAST among the tenant-local checks so a
            # quota-shed request never drains the bucket (a drained
            # bucket would misattribute later sheds to the rate limit)
            try:
                adm.take_token(req.tenant)
            except ServeRateLimited:
                self.metrics.record_rate_limited()
                raise
            evicted = None
            if len(self._q) >= cfg.queue_limit:
                # preempt the youngest strictly-lower-priority request
                # (scan from the back: the first hit of the minimal
                # priority is the youngest of that priority)
                vi = None
                for i in range(len(self._q) - 1, -1, -1):
                    r = self._q[i]
                    if r.priority < req.priority and (
                            vi is None
                            or r.priority < self._q[vi].priority):
                        vi = i
                if vi is None:
                    adm.refund_token(req.tenant)  # shed: no service taken
                    adm.count(req.tenant, "shed")
                    self.metrics.record_shed()
                    raise ServeOverloaded(
                        f"executor {self.name!r} queue is full "
                        f"({cfg.queue_limit} pending)")
                evicted = self._q.pop(vi)
                adm.count(evicted.tenant, "shed")
                self.metrics.record_shed()
            insert_by_priority(self._q, req)
            adm.count(req.tenant, "admitted")
            _pm.inc("serve.admit")
            return evicted
        except ServeError:
            raise    # typed rejections ARE the admission decision
        except Exception:
            # chaos site / machinery failure: legacy bounded-FIFO
            # admission for this request (doc/robustness.md)
            _pm.inc("serve.admission_fallbacks")
            if len(self._q) >= cfg.queue_limit:
                self.metrics.record_shed()
                raise ServeOverloaded(
                    f"executor {self.name!r} queue is full "
                    f"({cfg.queue_limit} pending)")
            self._q.append(req)
            return None

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                tenant: Optional[str] = None):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(x, deadline_ms=deadline_ms,
                           tenant=tenant).result(timeout)

    def warmup(self, feat_shape: Sequence[int], dtype=np.float32,
               rows: Optional[Sequence[int]] = None) -> dict:
        """Pre-compile the bucket ladder so traffic never pays a compile.

        Submits one zeros request per distinct bucket (sequentially, so
        requests cannot coalesce across buckets) and waits for each.
        Returns the program-cache stats afterwards — steady-state traffic
        over the same ladder must add zero misses from here on.

        The default ``rows`` covers the policy's ladder up to
        ``max_batch * policy.min_rows`` — the reachable buckets when every
        request is ``policy.min_rows`` rows. Callers whose requests carry
        more rows each must pass explicit ``rows`` up to
        ``max_batch * max_request_rows``, or coalesced traffic will still
        reach (and compile) buckets above the default ladder.
        """
        if rows is None:
            policy = self.config.bucket_rows
            ladder = getattr(policy, "ladder", None)
            # the floor that actually shapes the ladder lives on the
            # policy (adapters set it there, not on the config)
            min_rows = max(
                1, int(getattr(policy, "min_rows", self.config.min_rows)))
            rows = (ladder(self.config.max_batch * min_rows)
                    if ladder is not None else [self.config.max_batch])
        feat_shape = tuple(int(s) for s in feat_shape)
        seen = set()
        for r in rows:
            b = self.config.bucket_rows(int(r))
            if b in seen:
                continue
            seen.add(b)
            self.submit(np.zeros((b,) + feat_shape, dtype)).result()
        return self.program_cache.stats()

    # ------------------------------------------------------------------ #
    # lifecycle / introspection                                          #
    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q) + self._inflight

    def pause(self) -> None:
        """Hold the worker before its next batch (testing/ops hook — lets
        backpressure be exercised deterministically)."""
        with self._cv:
            self._paused = True
            self._cv.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until everything queued at call time has been answered."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._q or self._inflight:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem if rem is not None else 0.1)
        return True

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admission; then drain (answer pending) or abort (fail
        pending with :class:`ServeClosed`). Idempotent."""
        failed: list = []
        with self._cv:
            self._closed = True
            self._draining = drain
            if not drain:
                failed = list(self._q)
                self._q.clear()
            self._paused = False  # a paused executor must still shut down
            self._cv.notify_all()
        # fail futures OUTSIDE the lock: set_exception runs done-callbacks
        # synchronously, and a callback that re-enters close() would
        # otherwise join the worker while holding the lock the worker
        # needs to wake up and exit — deadlock
        for req in failed:
            # returns False iff the client already cancelled; otherwise it
            # moves the future to RUNNING so set_exception cannot race a
            # concurrent cancel
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    ServeClosed(f"executor {self.name!r} closed "
                                "without drain"))
        # close() can be reached FROM the worker (a future done-callback
        # fires on the thread that set the result) — joining yourself
        # raises; admission is already stopped, so just skip the wait
        if threading.current_thread() is not self._worker:
            self._worker.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def worker_alive(self) -> bool:
        """True while the dispatch worker thread lives (the soak harness's
        first verdict: nothing may kill it)."""
        return self._worker.is_alive()

    def stats(self) -> dict:
        """This executor's metrics snapshot + queue depth + cache stats
        (+ per-tenant admission counters once a registry exists)."""
        return self.metrics.snapshot(
            queue_depth=self.queue_depth,
            program_cache=self.program_cache.stats(),
            tenants=self.tenant_stats())

    def __enter__(self) -> "ServingExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # ------------------------------------------------------------------ #
    # worker                                                             #
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        cfg = self.config
        if self.device.type == "cuda":
            # CUDA's current device and stream are per thread: every copy,
            # launch and fetch of a batch runs on this thread's stream
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.current_stream(self.device)
        while True:
            with self._cv:
                # every state change (submit/pause/resume/close) notifies;
                # the long timeout is only a lost-wakeup safety net, and
                # keeps an abandoned (never-closed) executor nearly idle
                while not self._closed and (not self._q or self._paused):
                    self._cv.wait(1.0)
                if self._closed and not (self._draining and self._q):
                    # non-draining close already failed + cleared the queue
                    return
                first = self._q.pop(0)
                batch = [first]
                if cfg.batching and cfg.max_batch > 1:
                    t_end = time.monotonic() + cfg.max_wait_ms / 1e3
                    while len(batch) < cfg.max_batch:
                        batch.extend(self._take_matching(
                            first.group, cfg.max_batch - len(batch)))
                        if len(batch) >= cfg.max_batch:
                            break
                        rem = t_end - time.monotonic()
                        if rem <= 0 or self._closed:
                            break
                        self._cv.wait(rem)
                    # arrivals during the final wait
                    batch.extend(self._take_matching(
                        first.group, cfg.max_batch - len(batch)))
                self._inflight = len(batch)
            try:
                self._process(batch)
            except Exception as exc:
                # backstop: NOTHING may kill the worker thread — a dead
                # worker leaves every queued future unresolved forever
                # while submit() keeps admitting. Fail the batch instead.
                from ..utils import metrics as _pm

                _pm.inc("serve.worker_backstops")
                self.metrics.record_error()
                for req in batch:
                    try:
                        if not req.future.done():
                            req.future.set_exception(exc)
                    except InvalidStateError:
                        pass  # lost a race with a client cancel
            finally:
                with self._cv:
                    self._inflight = 0
                    self._cv.notify_all()

    def _take_matching(self, group, limit: int) -> list:
        """Pop up to ``limit`` queued requests of ``group`` (lock held).
        Non-matching requests keep their place — no head-of-line blocking
        across shape groups."""
        if limit <= 0:
            return []
        taken, keep = [], []
        for req in self._q:
            if len(taken) < limit and req.group == group:
                taken.append(req)
            else:
                keep.append(req)
        self._q[:] = keep
        return taken

    def _split_to_ladder(self, batch: list) -> list:
        """Greedily pack ``batch`` into chunks whose row totals the bucket
        policy accepts. A request too large even alone becomes its own
        chunk — reprocessing it routes the policy's error to its future."""
        policy = self.config.bucket_rows

        def fits(rows: int) -> bool:
            try:
                policy(rows)
                return True
            except Exception:
                return False

        chunks, cur, cur_rows = [], [], 0
        for req in batch:
            if cur and not fits(cur_rows + req.rows):
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(req)
            cur_rows += req.rows
        if cur:
            chunks.append(cur)
        return chunks

    def _expire(self, batch: list) -> list:
        """Drop client-cancelled and queued-past-deadline requests; returns
        the live remainder, every future moved to RUNNING — from here on a
        client ``Future.cancel()`` returns False instead of racing the
        worker's ``set_result`` (which would raise ``InvalidStateError``
        and poison the batch-mates via the backstop).

        With admission control armed, requests whose deadline cannot
        survive even one more estimated batch service time are **early
        shed** here, typed, before they consume the batch slot — the
        deadline arithmetic is one ``time.monotonic()`` clock end-to-end
        (enqueue stamp → EWMA estimate → this check)."""
        now = time.monotonic()
        adm = self._admission
        live = []
        for req in batch:
            if not req.started:
                if not req.future.set_running_or_notify_cancel():
                    continue  # cancelled while queued: never run it
                req.started = True
            if req.deadline_t is not None and now > req.deadline_t:
                self.metrics.record_deadline_expired()
                if adm is not None:
                    adm.count(req.tenant, "deadline_expired")
                req.future.set_exception(ServeDeadlineExceeded(
                    f"request expired after "
                    f"{(now - req.enq_t) * 1e3:.1f} ms in queue"))
                continue
            if req.deadline_t is not None and adm is not None:
                est = adm.estimate_service_s(req.group)
                if est is not None and now + est > req.deadline_t:
                    self.metrics.record_early_shed()
                    adm.count(req.tenant, "early_shed")
                    req.future.set_exception(ServeDeadlineExceeded(
                        f"early shed: estimated service "
                        f"{est * 1e3:.1f} ms cannot meet the deadline "
                        f"({(req.deadline_t - now) * 1e3:.1f} ms away "
                        f"after {(now - req.enq_t) * 1e3:.1f} ms queued)"))
                    continue
            live.append(req)
        return live

    def _process(self, batch: list) -> None:
        from ..utils import faults as _faults
        from ..utils import metrics as _pm

        cfg = self.config
        batch = self._expire(batch)
        if not batch:
            return
        # chaos site OUTSIDE every recovery path below: an armed
        # 'serve.worker.batch' fault escapes to the _run backstop — the
        # deterministic trigger for the "futures failed, worker alive,
        # next batch serves" contract test
        _faults.check("serve.worker.batch")
        rows = sum(r.rows for r in batch)
        feat, _ = batch[0].group
        dtype = batch[0].x.dtype
        try:
            _faults.check("serve.bucket.policy")
            bucket = cfg.bucket_rows(rows)
            over_cap = (cfg.max_bucket_bytes is not None
                        and bucket_nbytes(bucket, feat, dtype)
                        > cfg.max_bucket_bytes)
        except Exception as exc:
            # a bounded policy (FixedBuckets top size, Pow2Buckets
            # max_rows) can reject the COALESCED row count even when every
            # member request fits on its own — re-split into the largest
            # sub-batches the ladder still admits (NOT one-at-a-time:
            # sustained traffic can overflow on every cycle, and singles
            # would quietly revert to the sequential baseline).
            # A single request the policy rejects outright is a client
            # error: route it to that request's future, never the worker.
            if len(batch) > 1:
                _pm.inc("serve.bucket_splits")
                for chunk in self._split_to_ladder(batch):
                    self._process(chunk)
            else:
                self.metrics.record_error()
                batch[0].future.set_exception(exc)
            return
        if over_cap and len(batch) > 1:
            # degraded path: the coalesced bucket would blow the memory
            # cap — answer one request at a time instead
            for req in batch:
                self._process([req])
            return
        if over_cap:
            # a single over-cap request runs at (nearly) its exact shape:
            # bounded memory at the price of bucket-ladder compile reuse.
            # Sharded programs still need the batch axis to divide the
            # mesh; min_rows carries that requirement (its documented job)
            # even when multiple_of is 1 — e.g. Pow2Buckets(min_rows=4)
            # yields only multiples of 4, so the exact-shape fallback must
            # round to min_rows too, or a 1001-row request hands the
            # sharded program an indivisible batch axis.
            policy = cfg.bucket_rows
            quantum = max(int(getattr(policy, "multiple_of", 1)),
                          int(getattr(policy, "min_rows", cfg.min_rows)), 1)
            bucket = -(-rows // quantum) * quantum
            self.metrics.record_fallback_single()
        adm = self._admission
        tenants = ({r.tenant for r in batch if r.tenant is not None}
                   if adm is not None else ())
        svc_dt = [None]  # successful-dispatch duration for the estimator

        def run_once():
            t_disp = time.monotonic()
            _faults.check("serve.batch.dispatch")
            payload = np.empty((bucket,) + feat, dtype)
            off = 0
            for req in batch:
                payload[off:off + req.rows] = req.x
                off += req.rows
            if off < bucket:
                payload[off:] = 0  # zero only the pad tail, not the bucket
            prog = self.program_cache.get(
                self.model_fn, (bucket,) + feat, dtype, self.cache_token,
                device=self.device)
            out = prog(payload)
            # ONE device->host fetch per batch; per-request rows are then
            # sliced on the host (slicing on the device would launch a copy
            # per request)
            res = _tree_map(_to_host, out)
            svc_dt[0] = time.monotonic() - t_disp
            return res

        try:
            out = run_once()
        except Exception:
            # HARDENED FAILURE DOMAIN (doc/robustness.md): one bounded
            # retry before failing the batch's futures — a transient
            # compile/dispatch/fetch error (OOM blip, a cache cap-clear
            # racing a compile) must not shed a whole batch that the very
            # next attempt would have served. A second failure is treated
            # as real: the futures fail typed and the worker lives on
            # (the worker backstop's "don't die", widened to "retry, then
            # shed").
            _pm.inc("serve.batch_retries")
            try:
                out = run_once()
            except Exception as exc:
                # post-retry failure: the breaker's unit of evidence
                if adm is not None:
                    adm.on_batch_outcome(tenants, ok=False)
                self.metrics.record_error()
                for req in batch:
                    req.future.set_exception(exc)
                return
        if adm is not None:
            if svc_dt[0] is not None:
                adm.observe_service(batch[0].group, bucket, svc_dt[0])
            adm.on_batch_outcome(tenants, ok=True)
        self.metrics.record_batch(len(batch), rows, bucket)
        done_t = time.monotonic()
        off = 0
        # slices are COPIES when the request is smaller than the bucket: a
        # zero-copy view would pin the whole batch output alive for as
        # long as any client keeps its (possibly 1-row) result
        whole = len(batch) == 1 and batch[0].rows == bucket
        for req in batch:
            sl = slice(off, off + req.rows)
            res = _tree_map(
                lambda a, s=sl: a[s] if whole else a[s].copy(), out)
            off += req.rows
            self.metrics.record_request(done_t - req.enq_t)
            if adm is not None:
                adm.count(req.tenant, "completed")
            req.future.set_result(res)
