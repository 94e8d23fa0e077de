"""sklearn-style estimator base API (heat_tpu ``core/base.py``)."""

from __future__ import annotations

import inspect
from typing import Dict, List

from .dndarray import DNDarray

__all__ = ["BaseEstimator", "ClassificationMixin", "ClusteringMixin", "RegressionMixin",
           "TransformMixin", "is_classifier", "is_estimator", "is_regressor", "is_transformer"]


class BaseEstimator:
    """Introspected get_params/set_params base (heat_tpu ``base.py:24``)."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict[str, object]:
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}.")
            if delim:
                nested.setdefault(key, {})[sub_key] = value
            else:
                setattr(self, key, value)
                valid[key] = value
        for key, sub_params in nested.items():
            valid[key].set_params(**sub_params)
        return self

    def __repr__(self) -> str:
        params = {
            k: v for k, v in self.get_params(deep=False).items() if not isinstance(v, DNDarray)
        }
        return f"{self.__class__.__name__}({params})"


class ClassificationMixin:
    """fit/predict contract for classifiers (heat_tpu ``base.py:76``)."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class ClusteringMixin:
    """fit/predict contract for clusterers (heat_tpu ``base.py:90``)."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


class RegressionMixin:
    """fit/predict contract for regressors (heat_tpu ``base.py:101``)."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class TransformMixin:
    """The fit/transform contract (heat_tpu ``base.py:115``)."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        self.fit(x)
        return self.transform(x)

    def transform(self, x):
        raise NotImplementedError()


def is_classifier(estimator) -> bool:
    """Whether ``estimator`` is a classifier (heat_tpu ``base.py:129``)."""
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator) -> bool:
    return isinstance(estimator, BaseEstimator)


def is_regressor(estimator) -> bool:
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator) -> bool:
    return isinstance(estimator, TransformMixin)
