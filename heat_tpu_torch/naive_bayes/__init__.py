"""Naive Bayes estimators (heat_tpu ``naive_bayes``)."""

from .gaussianNB import GaussianNB

__all__ = ["GaussianNB"]
