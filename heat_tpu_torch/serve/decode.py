"""Continuous-batching decode engine (heat_tpu ``serve/decode.py``).

``TransformerLM.generate`` is a monolithic batch: every sequence runs until
the longest finishes, and new requests wait for the batch to drain. The
:class:`DecodeEngine` serves that traffic with SLOTS independent lanes over
a KV cache that lives on the model's device for the engine's lifetime:

* **State.** ``(n_layers, SLOTS, S_cap, H, Dh)`` K and V in
  ``compute_dtype``, plus per-slot position and last-token vectors, all on
  the device. ``S_cap = prompt_bucket(max_seq_len)``; every prompt pads onto
  the same power-of-two ladder. PyTorch has no buffer donation: the
  prefill and the step write the cache in place.
* **Two dispatch kinds.** A PREFILL runs the padded prompt's causal forward
  (the flash kernel), writes its K/V rows into a free slot and samples the
  first token; a DECODE STEP advances every live slot by one token with the
  dense cached attention. The only per-step device-to-host copy is the
  ``(SLOTS,)`` int32 token vector (:meth:`DecodeEngine._fetch`); cache,
  positions and logits stay on the device.
* **Join/leave is a mask.** A finished slot (EOS or ``max_new_tokens``)
  resolves its future and goes dead in the live mask; a queued request
  prefills into the free slot between steps. Dead slots keep their token
  and position, and their cache write lands on the same masked row.
* **Tenancy.** ``register_tenant`` arms the executor's
  :class:`~heat_tpu_torch.serve.admission.AdmissionController`: slot grants
  go by priority (FIFO within one), a tenant's ``slo_ms`` is its default
  deadline, and its admitted/completed/shed counters fold into
  ``ht.runtime_stats()``.
* **Failures.** A failed prefill fails its own request. A failed decode
  step (the fault site ``serve.decode.step``, or an error of the batched
  step) degrades that step to the eager per-slot path, the same kernels one
  slot at a time, with every future intact (``serve.decode_fallbacks``); an
  error past that fails every in-flight future through the worker's
  backstop, which rebuilds fresh lanes.

Sampling at ``temperature > 0`` is heat_tpu's draw bit for bit: the engine's
key is ``key(DecodeConfig.seed)``, the prefill's ``fold_in(fold_in(key, 2n +
1), slot)`` for its n-th prefill and a step's ``fold_in(fold_in(key, 2m),
slot)`` for its m-th step (warmup's dispatches counted), each token
``categorical(key, logits / T)`` (heat_tpu ``decode.py:494-497``, ``:543``,
``:663``, ``:716-721``).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError, wait
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import kernels
from ..core import random as _random
from ..utils import faults as _faults
from ..utils import metrics as _pm
from .admission import insert_by_priority, next_seq
from .errors import ServeClosed, ServeDeadlineExceeded, ServeOverloaded

__all__ = ["DecodeConfig", "DecodeEngine", "live_decode_engines", "DECODE_STATS_KEYS"]

# heat_tpu's pinned decode stats (serve/decode.py:75)
DECODE_STATS_KEYS = ("slots", "occupancy", "prefills", "decode_steps",
                     "tokens_out", "decode_fallbacks")

_ENGINES: "weakref.WeakSet[DecodeEngine]" = weakref.WeakSet()


def live_decode_engines():
    """The engines alive in this process (``runtime_stats`` folds them)."""
    return list(_ENGINES)


@dataclass
class DecodeConfig:
    """Engine policy knobs (host-side; none affect greedy results)."""

    slots: Optional[int] = None     # default 2 * dp_world, rounded up
    max_seq_len: int = 256          # S_cap = prompt_bucket(max_seq_len)
    queue_limit: int = 128          # admission bound -> ServeOverloaded
    default_deadline_ms: Optional[float] = None
    temperature: float = 0.0        # 0 = greedy (the parity-checked mode)
    seed: int = 0                   # sampling stream (temperature > 0)

    def __post_init__(self):
        if self.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {self.queue_limit}")
        if self.max_seq_len < 2:
            raise ValueError(f"max_seq_len must be >= 2, got {self.max_seq_len}")


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "tenant", "priority", "seq", "enq_t",
                 "deadline_t", "future", "generated", "slot")

    def __init__(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int],
                 deadline_t: Optional[float], tenant: Optional[str] = None):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.tenant = tenant
        self.priority = 0
        self.seq = next_seq()
        self.enq_t = time.monotonic()
        self.deadline_t = deadline_t
        self.future = Future()
        self.generated: List[int] = []
        self.slot = -1


class DecodeEngine:
    """Continuous-batching decode front end for one ``TransformerLM``.

    Parameters
    ----------
    model : TransformerLM
        A pp = 1, sp = 1 dense-MLP model (``check_decode_grid``).
    params : dict
        The model's parameters (``model.init``), on the model's device.
    config : DecodeConfig, optional

    The engine probes its card once (the probe kernel) and starts a worker
    thread. Always ``close()`` an engine you are done with, or use it as a
    context manager.
    """

    def __init__(self, model, params, config: Optional[DecodeConfig] = None, *,
                 name: str = "decode"):
        model.check_decode_grid()
        self.model = model
        self.params = params
        self.config = config if config is not None else DecodeConfig()
        self.name = name
        dpw = model.dp_world
        slots = self.config.slots if self.config.slots is not None else 2 * dpw
        self.slots = -(-int(slots) // dpw) * dpw
        self.S_cap = model.prompt_bucket(self.config.max_seq_len)
        c = model.cfg
        if c.vocab < 2:
            raise ValueError("decode needs vocab >= 2")
        self.device = model.device
        kernels.probe(torch.zeros((8, 128), dtype=torch.float32, device=self.device))
        self._shape = (c.n_layers, self.slots, self.S_cap, c.n_heads // model.tp, c.head_dim)
        self._new_lanes()
        self._base_key = _random._base_key(self.config.seed)
        self._step_seq = 0
        self._prefill_seq = 0
        # host mirrors: which request owns each slot (None = free) and the
        # live mask; the device copy of the mask is re-made only on join/leave
        self._slot_req: List[Optional[_DecodeRequest]] = [None] * self.slots
        self._live = np.zeros(self.slots, bool)
        self._live_dev: Optional[torch.Tensor] = None
        self._q: List[_DecodeRequest] = []
        self._cv_lock = threading.Condition()
        self._admission = None
        self._closed = False
        self._draining = False
        self._paused = False
        self._prefills = 0
        self._steps = 0
        self._tokens_out = 0
        self._fallbacks = 0
        self._occupancy = deque(maxlen=512)
        self._ttft = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._run, name=f"heat-decode-{name}",
                                        daemon=True)
        self._worker.start()
        _ENGINES.add(self)

    def _new_lanes(self) -> None:
        c = self.model.cfg
        self._ck = torch.zeros(self._shape, dtype=c.compute_dtype, device=self.device)
        self._cv = torch.zeros_like(self._ck)
        self._pos = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        self._toks = torch.zeros(self.slots, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------ #
    # submission                                                         #
    # ------------------------------------------------------------------ #
    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None, tenant: Optional[str] = None) -> Future:
        """Enqueue one decode request; returns a Future resolving to the
        full int32 token sequence (prompt + generated, the ``generate()``
        contract per request). Generation stops at ``max_new_tokens`` or on
        sampling ``eos_id`` (included in the result). Raises
        :class:`ServeOverloaded` when the queue is full and
        :class:`ServeClosed` after ``close()``. ``tenant`` needs
        :meth:`register_tenant` first."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if (prompt < 0).any() or (prompt >= self.model.cfg.vocab).any():
            raise ValueError("prompt tokens outside the model vocab")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        bucket = self.model.prompt_bucket(prompt.size)
        if bucket + max_new > self.S_cap:
            raise ValueError(
                f"request needs {bucket + max_new} cache rows (prompt bucket {bucket} + "
                f"{max_new} new) but the engine's sequence bucket is {self.S_cap}; raise "
                f"DecodeConfig.max_seq_len")
        adm = self._admission
        if adm is not None:
            tname = adm.resolve(tenant)
        elif tenant is not None:
            raise ValueError(f"submit(tenant={tenant!r}) needs register_tenant() first")
        else:
            tname = None
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
            if deadline_ms is None and adm is not None:
                deadline_ms = adm.slo_ms(tname)
        deadline_t = None if deadline_ms is None else time.monotonic() + deadline_ms / 1e3
        req = _DecodeRequest(prompt, max_new, eos_id, deadline_t, tname)
        with self._cv_lock:
            if self._closed:
                raise ServeClosed(f"decode engine {self.name!r} is closed")
            if len(self._q) >= self.config.queue_limit:
                if adm is not None:
                    adm.count(tname, "shed")
                _pm.inc("serve.decode_shed")
                raise ServeOverloaded(f"decode engine {self.name!r} queue is full "
                                      f"({self.config.queue_limit} pending)")
            if adm is not None:
                req.priority = int(adm.get(tname).priority)
                adm.count(tname, "admitted")
            insert_by_priority(self._q, req)
            self._cv_lock.notify_all()
        return req.future

    def generate(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id).result(timeout)

    def register_tenant(self, name: str, *, priority: int = 0,
                        slo_ms: Optional[float] = None, **policy):
        """Register a tenant in the engine's
        :class:`~heat_tpu_torch.serve.admission.AdmissionController`
        (heat_tpu ``decode.py:276``): slot grants follow priority (FIFO
        within one) and ``slo_ms`` is the tenant's default deadline. The
        rate and breaker knobs are kept in the registry, as in heat_tpu;
        decode admission enforces priority, SLO and the queue bound."""
        from .admission import AdmissionController

        with self._cv_lock:
            if self._admission is None:
                self._admission = AdmissionController()
            adm = self._admission
        return adm.register(name, priority=priority, slo_ms=slo_ms, **policy)

    @property
    def admission(self):
        return self._admission

    # ------------------------------------------------------------------ #
    # lifecycle / introspection                                          #
    # ------------------------------------------------------------------ #
    @property
    def live_slots(self) -> int:
        return int(self._live.sum())

    @property
    def queue_depth(self) -> int:
        with self._cv_lock:
            return len(self._q) + self.live_slots

    @property
    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    @property
    def closed(self) -> bool:
        return self._closed

    def pause(self) -> None:
        """Hold the worker before its next admit/step (test/ops hook)."""
        with self._cv_lock:
            self._paused = True
            self._cv_lock.notify_all()

    def resume(self) -> None:
        with self._cv_lock:
            self._paused = False
            self._cv_lock.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until everything queued or holding a slot at call time is
        answered; False if ``timeout`` seconds pass first. It waits on the
        requests' futures: a request moves from the queue to its slot under
        the lock, so none is missed between the two."""
        with self._cv_lock:
            futs = [r.future for r in self._q]
            futs += [r.future for r in self._slot_req if r is not None]
        return not wait(futs, timeout).not_done

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop admission; drain (finish queued and live sequences) or abort
        (fail them with :class:`ServeClosed`). Idempotent."""
        queued: list = []
        inflight: list = []
        with self._cv_lock:
            self._closed = True
            self._draining = drain
            if not drain:
                queued = list(self._q)
                self._q.clear()
                for s, req in enumerate(self._slot_req):
                    if req is not None:
                        inflight.append(req)
                        self._slot_req[s] = None
                self._live[:] = False
                self._live_dev = None
            self._paused = False
            self._cv_lock.notify_all()
        # fail futures outside the lock; queued ones are PENDING (claim them so
        # a client cancel cannot race), slot-granted ones are RUNNING
        err = ServeClosed(f"decode engine {self.name!r} closed without drain")
        for req in queued:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(err)
        for req in inflight:
            try:
                if not req.future.done():
                    req.future.set_exception(err)
            except InvalidStateError:
                pass  # the worker's final step resolved it first
        if threading.current_thread() is not self._worker:
            self._worker.join(timeout)

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def stats(self) -> dict:
        """Engine snapshot: heat_tpu's pinned decode figures
        (:data:`DECODE_STATS_KEYS`) plus queue and cache detail and the time
        from submission to the first token on the host (``ttft_ms``)."""
        occ = list(self._occupancy)
        ttft = sorted(self._ttft)
        adm = self._admission
        return {
            "slots": self.slots,
            "live": int(self._live.sum()),
            "queue_depth": len(self._q),
            "seq_bucket": self.S_cap,
            "occupancy": (sum(occ) / len(occ)) if occ else 0.0,
            "prefills": self._prefills,
            "decode_steps": self._steps,
            "tokens_out": self._tokens_out,
            "decode_fallbacks": self._fallbacks,
            "tenants": adm.tenant_stats() if adm is not None else {},
            "ttft_ms": {"n": len(ttft),
                        "p50": ttft[len(ttft) // 2] * 1e3 if ttft else None,
                        "max": ttft[-1] * 1e3 if ttft else None},
        }

    def warmup(self) -> dict:
        """One throwaway prefill per prompt bucket below ``S_cap`` (into
        slot 0, never marked live; the next real prefill overwrites it) and
        one all-dead decode step, so the first requests pay no first-use
        costs (the kernel build, library handles, allocations). Must run
        before traffic. Returns :meth:`stats`."""
        with self._cv_lock:
            if self._q or self._live.any():
                raise RuntimeError("warmup() must run before traffic (its throwaway "
                                   "prefill writes slot 0)")
        sp = self.model.PROMPT_BUCKET_MIN
        while sp < self.S_cap:
            self._dispatch_prefill(np.zeros(sp, np.int32), 0, record=False)
            sp <<= 1
        self._dispatch_step(np.zeros(self.slots, bool), record=False)
        return self.stats()

    # ------------------------------------------------------------------ #
    # the device -> host doorway                                         #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """The one device-to-host copy of the engine: the first token of a
        prefill, and the sampled-token vector of a step."""
        return t.cpu().numpy()

    # ------------------------------------------------------------------ #
    # dispatches                                                         #
    # ------------------------------------------------------------------ #
    def _sample(self, logits: torch.Tensor, key, slots) -> torch.Tensor:
        """The tokens of ``logits`` ``(R, V)``: greedy, or heat_tpu's draw
        under ``fold_in(key, slot)`` for each row's slot."""
        temp = float(self.config.temperature)
        if temp == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        keys = [_random._fold_in(key, s) for s in slots]
        return _random._categorical_rows(keys, logits, temp).to(torch.int32)

    @torch.no_grad()
    def _dispatch_prefill(self, prompt: np.ndarray, slot: int, record: bool = True) -> int:
        m = self.model
        S0 = int(prompt.size)
        Sp = m.prompt_bucket(S0)
        padded = np.zeros((1, Sp), np.int64)
        padded[0, :S0] = prompt
        toks = torch.from_numpy(padded).to(self.device)
        self._prefill_seq += 1
        key = _random._fold_in(self._base_key, 2 * self._prefill_seq + 1)
        ks, vs, logits = m._prompt_kv_logits(self.params, toks, S0)
        first = self._sample(logits, key, [slot])[0]
        for l in range(m.cfg.n_layers):
            self._ck[l, slot, :Sp] = ks[l][0]
            self._cv[l, slot, :Sp] = vs[l][0]
        self._pos[slot] = S0
        self._toks[slot] = first
        if record:
            self._prefills += 1
            _pm.inc("serve.decode_prefills")
        return int(self._fetch(first))

    @torch.no_grad()
    def _dispatch_step(self, live: np.ndarray, record: bool = True) -> np.ndarray:
        self._step_seq += 1
        key = _random._fold_in(self._base_key, 2 * self._step_seq)
        if self._live_dev is None:
            self._live_dev = torch.from_numpy(live.copy()).to(self.device)
        try:
            _faults.check("serve.decode.step")
            nxt = self._step_batched(key)
        except Exception:  # noqa: BLE001 — degrade this step, keep every future
            # the eager per-slot path rewrites the rows a failed step may
            # have written (the same token at the same position)
            _pm.inc("serve.decode_fallbacks")
            self._fallbacks += 1
            nxt = self._step_eager(live, key)
        self._toks = torch.where(self._live_dev, nxt, self._toks)
        self._pos = self._pos + self._live_dev.to(torch.int32)
        if record:
            self._steps += 1
            _pm.inc("serve.decode_steps")
        return self._fetch(self._toks)

    def _step_batched(self, key) -> torch.Tensor:
        """Every slot advanced by one token in one batch."""
        m = self.model
        x = m._embed(self.params, self._toks.long())[:, None, :]
        pos = self._pos.long()
        for l, p_l in enumerate(self.params["layers"]):
            x, _, _ = m._cache_layer_step(p_l, x, self._ck[l], self._cv[l], pos)
        return self._sample(m._head(self.params, x)[:, 0], key, range(self.slots))

    def _step_eager(self, live: np.ndarray, key) -> torch.Tensor:
        """The degraded step (heat_tpu ``decode.py:816``): each live slot
        alone through the same layer functions and kernels, on its own
        views of the cache; dead slots keep their token."""
        m = self.model
        nxt = self._toks.clone()
        for s in np.nonzero(live)[0]:
            s = int(s)
            x = m._embed(self.params, self._toks[s:s + 1].long())[:, None, :]
            pos = self._pos[s:s + 1].long()
            for l, p_l in enumerate(self.params["layers"]):
                x, _, _ = m._cache_layer_step(p_l, x, self._ck[l, s:s + 1],
                                              self._cv[l, s:s + 1], pos)
            nxt[s] = self._sample(m._head(self.params, x)[:, 0], key, [s])[0]
        return nxt

    # ------------------------------------------------------------------ #
    # worker                                                             #
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # CUDA's current device is per thread
        while True:
            expired: list = []
            grants: list = []
            with self._cv_lock:
                while not self._closed and (
                        self._paused or (not self._q and not self._live.any())):
                    self._cv_lock.wait(1.0)
                if self._closed and not (self._draining and (self._q or self._live.any())):
                    return
                if not self._paused:
                    grants, expired = self._grant_locked()
            for req in expired:
                self._fail_deadline(req)
            try:
                for req, slot in grants:
                    self._do_prefill(req, slot)
                if self._live.any():
                    self._do_step()
            except Exception as exc:  # noqa: BLE001 — the worker must outlive any step
                # backstop: the degraded step failed too, after writing the
                # cache in place, so every in-flight request fails and the
                # lanes restart
                _pm.inc("serve.worker_backstops")
                self._reset_state(exc)
            finally:
                with self._cv_lock:
                    self._cv_lock.notify_all()

    def _grant_locked(self):
        """Pop (request, slot) grants for every free slot while the queue
        has work (lock held); queued-past-deadline and cancelled requests
        drop out. FIFO."""
        grants, expired = [], []
        now = time.monotonic()
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        while free and self._q:
            req = self._q.pop(0)
            if not req.future.set_running_or_notify_cancel():
                continue  # cancelled while queued: never run it
            if req.deadline_t is not None and now > req.deadline_t:
                expired.append(req)
                continue
            slot = free.pop(0)
            req.slot = slot
            self._slot_req[slot] = req
            grants.append((req, slot))
        return grants, expired

    def _fail_deadline(self, req) -> None:
        _pm.inc("serve.decode_deadline_expired")
        if self._admission is not None:
            self._admission.count(req.tenant, "deadline_expired")
        req.future.set_exception(ServeDeadlineExceeded(
            f"decode request expired after {(time.monotonic() - req.enq_t) * 1e3:.1f} ms "
            "in queue"))

    def _do_prefill(self, req: _DecodeRequest, slot: int) -> None:
        try:
            first = self._dispatch_prefill(req.prompt, slot)
        except Exception as exc:  # noqa: BLE001 — fails this request only
            # the slot stays free: its rows are rewritten by the next prefill
            self._slot_req[slot] = None
            req.future.set_exception(exc)
            return
        self._ttft.append(time.monotonic() - req.enq_t)
        req.generated = [first]
        self._tokens_out += 1
        _pm.inc("serve.decode_tokens_out")
        if req.max_new <= 1 or (req.eos_id is not None and first == req.eos_id):
            self._finish(slot, req)
        else:
            self._live[slot] = True
            self._live_dev = None  # membership changed: re-upload

    def _do_step(self) -> None:
        live = self._live.copy()
        n_live = int(live.sum())
        toks_np = self._dispatch_step(live)
        self._occupancy.append(n_live / self.slots)
        self._tokens_out += n_live
        _pm.inc("serve.decode_tokens_out", n_live)
        for slot in np.nonzero(live)[0]:
            req = self._slot_req[slot]
            if req is None:
                continue
            t = int(toks_np[slot])
            req.generated.append(t)
            if len(req.generated) >= req.max_new or (req.eos_id is not None
                                                      and t == req.eos_id):
                self._finish(slot, req)

    def _finish(self, slot: int, req: _DecodeRequest) -> None:
        self._live[slot] = False
        self._live_dev = None  # membership changed: re-upload
        self._slot_req[slot] = None
        _pm.inc("serve.decode_completed")
        if self._admission is not None:
            self._admission.count(req.tenant, "completed")
        req.future.set_result(np.concatenate([req.prompt,
                                              np.asarray(req.generated, np.int32)]))

    def _reset_state(self, exc: Exception) -> None:
        """Backstop: fail every in-flight future with ``exc``, free every
        slot and start from fresh lanes."""
        self._new_lanes()
        failed = []
        with self._cv_lock:
            for s, req in enumerate(self._slot_req):
                if req is not None:
                    failed.append(req)
                    self._slot_req[s] = None
            self._live[:] = False
            self._live_dev = None
        for req in failed:
            try:
                if not req.future.done():
                    req.future.set_exception(exc)
            except InvalidStateError:
                pass
