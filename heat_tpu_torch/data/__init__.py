"""``heat_tpu_torch.data`` — the part of heat_tpu's data engine
(``heat_tpu/data``) that the order statistics need: the engine switch and
exact order statistics by bisection (:func:`ops.order_stats`).

``ht.percentile``/``ht.median``/``ht.quantile`` of a split array over all
axes, at world size > 1, route through :func:`order_stats` (``bits``
all-reduces of counts, no gather) and take the merge-split sort path
instead under ``HEAT_TPU_DATA_ENGINE=0`` or ``override(False)``.
"""

from . import engine, ops
from .engine import enabled, override
from .ops import order_stats

__all__ = ["engine", "ops", "enabled", "override", "order_stats"]
