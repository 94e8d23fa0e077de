"""Utilities: the metrics registry, state carried across from numpy, the
data tools and the vision transforms."""

from . import metrics
from . import convert
from . import data
from . import vision_transforms

__all__ = ["convert", "data", "metrics", "vision_transforms"]
