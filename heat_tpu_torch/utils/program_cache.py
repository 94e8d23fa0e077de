"""Shape-keyed cache of built programs (heat_tpu ``utils/program_cache.py``).

heat_tpu caches one AOT-compiled XLA executable per ``(callable, input
shape, dtype, mesh)``. PyTorch compiles nothing ahead of time, so a
"program" of the port is the callable the serving executor runs at one
bucket shape, and "compiling" it means building it once at its key:

* the callable moves its host payload to the device in ONE copy (pinned
  where the device is a card) and runs the model function under
  ``torch.inference_mode()``;
* the build runs it once on a zeros payload of the key's shape, which
  builds the kernels' library, settles each kernel's plan at that shape
  (``kernels._kmeans_plan``, the flash wrapper's workspace) and the
  caching allocator's blocks, so the first request at that bucket pays
  none of it.

The contract is heat_tpu's: a bounded key space, hit/miss/compile counters
mirrored into :mod:`heat_tpu_torch.utils.metrics` as
``<prefix>.program_hits`` / ``_misses`` / ``_compiles``, and after a warmup
over the bucket ladder steady-state traffic builds nothing.

:meth:`ProgramCache.get_custom` is the general form (the caller's key and
``build()``); :meth:`ProgramCache.get` the serving form.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from . import metrics as _metrics

__all__ = ["ProgramCache"]


class ProgramCache:
    """Keyed cache of built programs with hit/miss/compile counters."""

    # the exact key set :meth:`stats` returns; aggregators (serve/metrics.py
    # runtime_stats) start from it
    STATS_KEYS = ("hits", "misses", "compiles", "evictions", "entries")

    def __init__(self, name: str = "programs", aot: bool = True,
                 counter_prefix: str = None, max_entries: int = None):
        self.name = name
        # heat_tpu's ahead-of-time switch; here it says whether a build runs
        # the program once at its shape (True) or only wraps it
        self.aot = aot
        self.counter_prefix = counter_prefix or name
        # None = unbounded (the serve bucket ladder is finite); crossing the
        # cap clears the table, and the rebuilds are counted
        self.max_entries = max_entries
        self._programs: Dict[Tuple, Callable] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0

    # ------------------------------------------------------------------ #
    # generic form                                                       #
    # ------------------------------------------------------------------ #
    def get_custom(self, key, build: Callable[[], Callable]) -> Callable:
        """The program stored under ``key``, building it on the first miss.
        ``build`` runs outside the lock; a rare double build of one key is
        benign (the last writer wins, both are counted)."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self.hits += 1
                _metrics.inc(f"{self.counter_prefix}.program_hits")
                return prog
            self.misses += 1
            _metrics.inc(f"{self.counter_prefix}.program_misses")
        prog = build()
        with self._lock:
            if self.max_entries is not None and len(self._programs) >= self.max_entries:
                self._programs.clear()
                self.evictions += 1
                _metrics.inc(f"{self.counter_prefix}.program_evictions")
            self._programs[key] = prog
            self.compiles += 1
        _metrics.inc(f"{self.counter_prefix}.program_compiles")
        return prog

    # ------------------------------------------------------------------ #
    # serving form                                                       #
    # ------------------------------------------------------------------ #
    def get(self, fn: Callable, shape: Tuple[int, ...], dtype, token: Any = (),
            device=None) -> Callable:
        """The program for ``fn`` at host input ``(shape, dtype)``: a
        callable ``prog(payload)`` taking a numpy array of that shape and
        returning ``fn``'s output for it on ``device`` (by default the
        port's device: the card, unless ``use_device("cpu")``). ``token``
        folds extra identity into the key, as heat_tpu's executors pass the
        mesh's."""
        if device is None:
            from ..core import devices

            device = devices.get_device().torch_device
        device = torch.device(device)
        key = (fn, tuple(int(s) for s in shape), str(np.dtype(dtype)), token, str(device))
        return self.get_custom(key, lambda: self._compile(fn, shape, dtype, device))

    def _compile(self, fn, shape, dtype, device) -> Callable:
        from . import faults as _faults

        _faults.check("program_cache.compile")
        pinned = device.type == "cuda"

        def prog(payload: np.ndarray):
            x = torch.from_numpy(payload)
            if pinned:
                x = x.pin_memory()
            x = x.to(device, non_blocking=pinned)
            with torch.inference_mode():
                return fn(x)

        if self.aot:
            prog(np.zeros(tuple(int(s) for s in shape), dtype))
            if pinned:
                torch.cuda.synchronize(device)
        return prog

    def stats(self) -> dict:
        """Plain-dict counters; keys are exactly :data:`STATS_KEYS`."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "compiles": self.compiles,
                    "evictions": self.evictions, "entries": len(self._programs)}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self.hits = 0
            self.misses = 0
            self.compiles = 0
            self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def __repr__(self) -> str:
        s = self.stats()
        return (f"ProgramCache({self.name!r}, entries={s['entries']}, "
                f"hits={s['hits']}, misses={s['misses']})")
