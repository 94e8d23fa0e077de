"""Deterministic fault injection (heat_tpu ``utils/faults.py``): every
failure domain's fallback is made to run, on purpose.

* **Sites.** Each failure surface calls :func:`check` with a named site
  where the real world would throw: before a build, a dispatch, a file
  write. :data:`SITES` is heat_tpu's registry, kept whole, so a plan that
  parses in heat_tpu parses here; a site of an engine the port runs
  without a fallback (the fusion engine's, the reshard planner's) is never
  checked and never fires.
* **Plans.** A :class:`FaultPlan` maps sites to firing rules: ``once``
  (= ``nth:1``), ``nth:N`` (the Nth hit only), ``every:N`` (every Nth hit)
  and ``prob:P@SEED`` (a Bernoulli draw from a ``random.Random(SEED)``, so
  the same plan fires on the same hits every run). Arm one with
  :func:`inject` (a context manager), :func:`arm`, or for the whole process
  with ``HEAT_TPU_TORCH_FAULTS="site=rule;site2=rule"`` in the environment
  at import. The variable is the port's own: ``HEAT_TPU_FAULTS`` arms
  heat_tpu only, so one setting never arms both packages of a process.
* **Disarmed cost.** With no plan armed a site is one module attribute read.
* **Counters.** A fire ticks ``faults.fires`` and ``faults.<site>.fires``
  in :mod:`heat_tpu_torch.utils.metrics`, an arm ``faults.arms``;
  :func:`stats` is ``ht.runtime_stats()["faults"]``.

A firing site raises the class the real failure would: the filesystem
sites ``OSError``, the runtime sites :class:`FaultInjected` (a
``RuntimeError``), so the hardened paths catch exactly what they catch in
production.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Dict, Optional

from . import metrics as _metrics

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "SITES",
    "arm",
    "armed",
    "check",
    "disarm",
    "inject",
    "parse_spec",
    "site_doc",
    "stats",
]


class FaultInjected(RuntimeError):
    """The error an armed runtime site raises when its rule fires."""


# ---------------------------------------------------------------------- #
# the site registry                                                      #
# ---------------------------------------------------------------------- #
# name -> (exception class raised on fire, one-line doc used by the chaos
# matrix and doc/robustness.md). The class is what the REAL failure would
# raise at that point, so hardened except-clauses are exercised as-is.
SITES: Dict[str, tuple] = {
    # fused tape engine (core/fusion.py)
    "fusion.flush.compile": (
        FaultInjected,
        "flush program build (shard_map and plain-jit paths both route "
        "through the one build())"),
    "fusion.flush.dispatch": (
        FaultInjected,
        "compiled flush program dispatch (program(*leaves))"),
    "fusion.step.trace": (
        FaultInjected,
        "trace_step first trace/compile of a new argument signature"),
    "fusion.step.dispatch": (
        FaultInjected,
        "trace_step dispatch of a PRIMED (previously successful) program"),
    "fusion.quant.encode": (
        FaultInjected,
        "quantized-collective encode planning (flush packing and "
        "packed_psum) — falls back to the exact collective, counted in "
        "op_engine.quant_fallbacks"),
    "fusion.chunk.dispatch": (
        FaultInjected,
        "chunked packed-collective leg planning (fires once per intended "
        "chunk leg, flush plan and packed_psum) — degrades to the "
        "UNCHUNKED packed collective (for flushes via the cache key, "
        "hitting any cached unchunked program), counted in "
        "op_engine.chunk_fallbacks"),
    "fusion.hier.exchange": (
        FaultInjected,
        "tier-aware hierarchical packed-collective planning (flush plan "
        "and packed_psum) — degrades to the FLAT packed collective (for "
        "flushes via the cache key, hitting any cached flat program), "
        "counted in op_engine.hier_fallbacks"),
    "fit.step.dispatch": (
        FaultInjected,
        "compiled analytics fit-step dispatch (fusion.fit_step_call: the "
        "estimator Lloyd/Lanczos/coordinate-sweep and KNN/GaussianNB "
        "predict programs) — degrades to the eager per-op iteration with "
        "identical results, counted in op_engine.fit_step_fallbacks"),
    # reshard planner (core/resharding.py)
    "reshard.plan.build": (
        FaultInjected,
        "explicit reshard plan compile (_build_plan)"),
    "reshard.dispatch": (
        FaultInjected,
        "reshard program dispatch (fn(parray) in reshard())"),
    # serving executor (serve/executor.py)
    "serve.worker.batch": (
        FaultInjected,
        "worker batch processing OUTSIDE the dispatch try (exercises the "
        "_run backstop: futures fail, worker survives)"),
    "serve.batch.dispatch": (
        FaultInjected,
        "batch model dispatch / host fetch (bounded one-retry path)"),
    "serve.bucket.policy": (
        FaultInjected,
        "bucket policy evaluation on the coalesced row total"),
    "serve.admission.decide": (
        FaultInjected,
        "multi-tenant admission decision (serve/executor.py::_admit) — "
        "degrades that request to the legacy bounded-FIFO admission "
        "(quota/rate/breaker skipped, request still served), counted in "
        "serve.admission_fallbacks"),
    "serve.breaker.probe": (
        FaultInjected,
        "circuit-breaker consult / half-open probe admission "
        "(serve/admission.py::check_tenant) — fails OPEN (the request is "
        "admitted; the dispatch path stays the health authority), "
        "counted in serve.breaker_fallbacks"),
    "serve.decode.step": (
        FaultInjected,
        "continuous-batching decode-step dispatch "
        "(serve/decode.py::DecodeEngine._dispatch_step) — that step "
        "degrades to the eager per-slot path with every future intact, "
        "counted in serve.decode_fallbacks"),
    # distributed data engine (data/engine.py, data/streaming.py)
    "data.exchange.dispatch": (
        FaultInjected,
        "compiled data-engine exchange dispatch (data/engine.py::"
        "engine_call: the groupby/top-k/order-statistic/join programs) — "
        "degrades to the eager per-op reference path with identical "
        "results, counted in data_engine.exchange_fallbacks"),
    "data.stream.carry": (
        FaultInjected,
        "streaming carry-fold dispatch (data/streaming.py: the donated "
        "chunk-fold executables) — that chunk degrades to the eager "
        "accumulation with identical results, counted in "
        "data_engine.stream_fallbacks"),
    # shared program cache (utils/program_cache.py)
    "program_cache.compile": (
        FaultInjected,
        "AOT compile inside ProgramCache._compile (serving form)"),
    # checkpointing (utils/checkpointing.py)
    "checkpoint.manifest.write": (
        OSError, "manifest.json temp-write/replace"),
    "checkpoint.leaf.write": (
        OSError, "arrays.npz (leaf payload) temp-write/replace"),
    "checkpoint.manifest.read": (
        OSError, "manifest.json open/parse on restore"),
    "checkpoint.leaf.read": (
        OSError, "arrays.npz open/decode on restore"),
    # multi-host bring-up (core/communication.py)
    "init.coordinator.connect": (
        FaultInjected,
        "jax.distributed.initialize coordinator connect"),
}


def site_doc(site: str) -> str:
    return SITES[site][1]


# ---------------------------------------------------------------------- #
# firing rules / plans                                                   #
# ---------------------------------------------------------------------- #
class _Rule:
    """One site's firing rule plus its per-arm hit state."""

    __slots__ = ("mode", "n", "p", "seed", "hits", "_rng")

    def __init__(self, mode: str, n: int = 1, p: float = 0.0,
                 seed: int = 0):
        self.mode = mode
        self.n = int(n)
        self.p = float(p)
        self.seed = int(seed)
        self.hits = 0
        # seeded per-rule stream: same plan + same hit sequence -> same
        # fire pattern, every run (the determinism the chaos matrix pins)
        self._rng = random.Random(self.seed) if mode == "prob" else None

    def should_fire(self) -> bool:
        self.hits += 1
        if self.mode == "nth":
            return self.hits == self.n
        if self.mode == "every":
            return self.hits % self.n == 0
        return self._rng.random() < self.p  # "prob"

    def spec(self) -> str:
        if self.mode == "prob":
            return f"prob:{self.p}@{self.seed}"
        return f"{self.mode}:{self.n}"


def _parse_rule(text: str) -> _Rule:
    """``nth:N`` / ``every:N`` / ``prob:P@SEED`` / ``once`` (= nth:1)."""
    text = text.strip()
    if text in ("once", "1"):
        return _Rule("nth", 1)
    mode, _, rest = text.partition(":")
    if mode == "nth" or mode == "every":
        n = int(rest)
        if n < 1:
            raise ValueError(f"fault rule {text!r}: N must be >= 1")
        return _Rule(mode, n)
    if mode == "prob":
        p_text, _, seed_text = rest.partition("@")
        p = float(p_text)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault rule {text!r}: P must be in [0, 1]")
        return _Rule("prob", p=p, seed=int(seed_text or 0))
    raise ValueError(
        f"unknown fault rule {text!r} (want once | nth:N | every:N | "
        f"prob:P@SEED)")


class FaultPlan:
    """Site → firing rule map. Hit accounting lives on the plan, so one
    plan armed twice starts fresh both times (:meth:`reset`)."""

    def __init__(self, rules: Dict[str, _Rule]):
        for site in rules:
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; registered sites: "
                    f"{sorted(SITES)}")
        self.rules = dict(rules)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the ``HEAT_TPU_TORCH_FAULTS`` grammar:
        ``site=rule[;site=rule...]`` with rules ``once`` / ``nth:N`` /
        ``every:N`` / ``prob:P@SEED``."""
        rules: Dict[str, _Rule] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            site, eq, rule = part.partition("=")
            if not eq:
                raise ValueError(
                    f"bad fault spec segment {part!r} (want site=rule)")
            rules[site.strip()] = _parse_rule(rule)
        return cls(rules)

    def reset(self) -> None:
        for r in self.rules.values():
            r.hits = 0
            if r._rng is not None:
                r._rng = random.Random(r.seed)

    def spec(self) -> Dict[str, str]:
        return {site: r.spec() for site, r in self.rules.items()}


def parse_spec(spec: str) -> FaultPlan:
    return FaultPlan.from_spec(spec)


# ---------------------------------------------------------------------- #
# arming / the hot-path check                                            #
# ---------------------------------------------------------------------- #
# the one piece of state every site reads: None = disarmed (the
# production steady state). Assignment is atomic; sites never lock.
_PLAN: Optional[FaultPlan] = None
_ARM_LOCK = threading.Lock()


def armed() -> bool:
    return _PLAN is not None


def arm(plan) -> None:
    """Activate ``plan`` (a :class:`FaultPlan`, spec string, or site→rule
    dict) process-wide; hit counters start fresh."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan({s: _parse_rule(r) for s, r in plan.items()})
    with _ARM_LOCK:
        plan.reset()
        _metrics.inc("faults.arms")
        _PLAN = plan


def disarm() -> None:
    global _PLAN
    with _ARM_LOCK:
        _PLAN = None


@contextlib.contextmanager
def inject(plan):
    """``with faults.inject("serve.batch.dispatch=nth:1"): ...`` — arm for
    the block, restore the previous plan (usually None) after."""
    prev = _PLAN
    arm(plan)
    try:
        yield
    finally:
        with _ARM_LOCK:
            globals()["_PLAN"] = prev


def check(site: str) -> None:
    """The instrumentation hook. Disarmed: one attribute read and out.
    Armed: consult the plan's rule for ``site`` and raise the site's
    registered exception class when it fires."""
    plan = _PLAN
    if plan is None:
        return
    rule = plan.rules.get(site)
    if rule is None or not rule.should_fire():
        return
    _metrics.inc("faults.fires")
    _metrics.inc(f"faults.{site}.fires")
    exc_cls = SITES[site][0]
    raise exc_cls(
        f"injected fault at site {site!r} (hit {rule.hits}, rule "
        f"{rule.spec()})")


def stats() -> dict:
    """Snapshot for ``ht.runtime_stats()["faults"]``: armed flag, the
    active plan's spec, and per-site fire counts (zero-fire sites are
    omitted — a fault-free run reads as an empty ``fires`` map)."""
    c = _metrics.counters()
    fires = {k[len("faults."):-len(".fires")]: int(v)
             for k, v in c.items()
             if k.startswith("faults.") and k.endswith(".fires")
             and k != "faults.fires"}
    plan = _PLAN
    return {
        "armed": plan is not None,
        "plan": plan.spec() if plan is not None else {},
        "sites": len(SITES),
        "arms": int(c.get("faults.arms", 0)),
        "total_fires": int(c.get("faults.fires", 0)),
        "fires": fires,
    }


# process-wide arming at import
_env_spec = os.environ.get("HEAT_TPU_TORCH_FAULTS", "").strip()
if _env_spec:
    arm(_env_spec)
del _env_spec
