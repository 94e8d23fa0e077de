"""Typed serving errors (heat_tpu ``serve/errors.py``).

Every failure a caller can act on has its own type: ``except
ServeOverloaded`` retries elsewhere, a deadline is told apart from a
shutdown without string matching. All inherit :class:`ServeError`;
:class:`ServeDeadlineExceeded` is also a ``TimeoutError``.
"""

from __future__ import annotations

__all__ = ["ServeError", "ServeOverloaded", "ServeRateLimited", "ServeCircuitOpen",
           "ServeDeadlineExceeded", "ServeClosed"]


class ServeError(RuntimeError):
    """Base class for serving-path errors."""


class ServeOverloaded(ServeError):
    """The bounded request queue is full: the request was shed at admission
    and nothing was enqueued. Retry with backoff or route elsewhere."""


class ServeRateLimited(ServeError):
    """The tenant's token bucket is empty: the request was rejected at
    admission without touching the queue. Back off; the bucket refills at
    the tenant's ``rate_limit`` tokens a second."""


class ServeCircuitOpen(ServeError):
    """The tenant's circuit breaker is open: its recent batches failed
    after their retry, so its requests fail at admission instead of
    spending the worker's retries. A bounded number of probe requests pass
    after the cool-down; a successful one closes the breaker."""


class ServeDeadlineExceeded(ServeError, TimeoutError):
    """The request's deadline expired while it was still queued: it was
    dropped without running."""


class ServeClosed(ServeError):
    """The executor or engine is closed (or closing): no new requests are accepted, and
    on a non-draining close pending requests fail with this."""
