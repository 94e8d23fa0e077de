"""Serving (heat_tpu ``serve/``): batched, backpressured inference.

A :class:`ServingExecutor` coalesces per-request arrays into micro-batches,
pads them onto a finite bucket ladder (:mod:`~heat_tpu_torch.serve.bucketing`),
runs one program a bucket from its counter-instrumented :class:`ProgramCache`
(one copy of the batch to the card, the model's kernels, one fetch back)
and answers per-request futures, with bounded admission
(:class:`ServeOverloaded`), deadlines (:class:`ServeDeadlineExceeded`),
per-tenant admission control (:class:`AdmissionController`: priorities,
quotas, rate limits, a circuit breaker, early shedding), a drain/close
lifecycle and a single-request fallback. For autoregressive traffic the
:class:`DecodeEngine` batches continuously over a slot-based KV cache.
:func:`runtime_stats` (``ht.runtime_stats()``) is the process's one
observability snapshot; :mod:`~heat_tpu_torch.serve.loadgen` drives an
executor with open-loop traffic.

>>> import heat_tpu_torch as ht
>>> from heat_tpu_torch.serve import serve_estimator, serve_transformer
>>> ex = serve_estimator(ht.cluster.KMeans(n_clusters=8).fit(x))
>>> ex.warmup(feat_shape=(64,), rows=range(1, 17))
>>> labels = ex.predict(batch_rows)          # or ex.submit(...) -> Future
>>> ex.stats()["latency_ms"]["p99"]
>>> lm = serve_transformer(model, params, 1024)          # logits of (rows, 1024) tokens
>>> eng = serve_transformer(model, params, 2048, decode=True, slots=8)

The adapters (transformer, estimators) load on first use.
"""

from . import admission
from . import bucketing
from . import errors
from . import loadgen
from . import metrics
from .admission import AdmissionController, Tenant
from .bucketing import FixedBuckets, Pow2Buckets
from .decode import DECODE_STATS_KEYS, DecodeConfig, DecodeEngine, live_decode_engines
from .errors import (ServeCircuitOpen, ServeClosed, ServeDeadlineExceeded, ServeError,
                     ServeOverloaded, ServeRateLimited)
from .executor import ServeConfig, ServingExecutor, live_executors
from .loadgen import TenantLoad, estimate_capacity, run_open_loop
from .metrics import ServeMetrics, runtime_stats
from .program_cache import ProgramCache

__all__ = [
    "ServingExecutor",
    "ServeConfig",
    "DecodeEngine",
    "DecodeConfig",
    "live_decode_engines",
    "ProgramCache",
    "ServeMetrics",
    "Pow2Buckets",
    "FixedBuckets",
    "AdmissionController",
    "Tenant",
    "TenantLoad",
    "run_open_loop",
    "estimate_capacity",
    "ServeError",
    "ServeOverloaded",
    "ServeRateLimited",
    "ServeCircuitOpen",
    "ServeDeadlineExceeded",
    "ServeClosed",
    "runtime_stats",
    "live_executors",
    # lazy (module __getattr__): the adapters
    "adapters",
    "serve_transformer",
    "serve_estimator",
    "transformer_logits_fn",
    "estimator_predict_fn",
]

_LAZY_ADAPTERS = ("serve_transformer", "serve_estimator", "transformer_logits_fn",
                  "estimator_predict_fn")


def __getattr__(name):
    # importlib, not ``from . import``: the latter re-enters this __getattr__
    if name == "adapters" or name in _LAZY_ADAPTERS:
        import importlib

        adapters = importlib.import_module(".adapters", __name__)
        return adapters if name == "adapters" else getattr(adapters, name)
    raise AttributeError(f"module 'heat_tpu_torch.serve' has no attribute {name!r}")
