"""``heat_tpu_torch.data`` — heat_tpu's data engine (``heat_tpu/data``):
groupby-aggregate, top-k, the inner hash join and exact order statistics
(:mod:`.ops`), their folds over streams of chunks (:mod:`.streaming`), and
the engine switch and counters (:mod:`.engine`).

``ht.percentile``/``ht.median``/``ht.quantile`` of a split array over all
axes, at world size > 1, route through :func:`order_stats` (``bits``
all-reduces of counts, no gather) and take the merge-split sort path
instead under ``HEAT_TPU_TORCH_DATA_ENGINE=0`` or ``override(False)``.
"""

from . import engine, ops, streaming
from .engine import enabled, override, reset, stats
from .ops import GroupBy, groupby, groupby_agg, join, order_stats, topk
from .streaming import stream_groupby, stream_quantile, stream_topk

__all__ = [
    "engine", "ops", "streaming",
    "enabled", "override", "reset", "stats",
    "GroupBy", "groupby", "groupby_agg", "join", "order_stats", "topk",
    "stream_groupby", "stream_quantile", "stream_topk",
]
