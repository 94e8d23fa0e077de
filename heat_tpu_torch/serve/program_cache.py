"""The serving path's program cache (heat_tpu ``serve/program_cache.py``).

:class:`heat_tpu_torch.utils.program_cache.ProgramCache` with its mirrored
counters pinned to ``serve.program_hits`` / ``_misses`` / ``_compiles``
whatever the cache's display name, so every adapter's cache counts under
one family, as in heat_tpu.
"""

from __future__ import annotations

from ..utils.program_cache import ProgramCache as _ProgramCache

__all__ = ["ProgramCache"]


class ProgramCache(_ProgramCache):
    """Serving-path program cache: the display name is per model, the
    counters aggregate under ``serve.program_*``."""

    def __init__(self, name: str = "serve", aot: bool = True):
        super().__init__(name=name, aot=aot, counter_prefix="serve")
