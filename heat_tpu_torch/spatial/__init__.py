"""Spatial algorithms (heat_tpu ``spatial``)."""

from .distance import cdist, manhattan, rbf

__all__ = ["cdist", "manhattan", "rbf"]
