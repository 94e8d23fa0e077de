"""Gaussian naive Bayes (heat_tpu ``naive_bayes/gaussianNB.py``).

The class moments are masked one-hot products in float64 on each rank's
rows. heat_tpu's fit reduces them across devices in five eager all-reduce
programs (the class counts, the two moment products, the two column sums
of ``var_smoothing``'s epsilon); the port sends the five in ONE
``packed_all_reduce``. ``partial_fit`` keeps heat_tpu's incremental merge of
means and variances; prediction is local to each rank's rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import fusion, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.manipulations import unique

__all__ = ["GaussianNB"]


def _jll(xl: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
         log_prior: torch.Tensor) -> torch.Tensor:
    """Per-class joint log likelihood, (n, k) (heat_tpu ``_jll_body``
    ``gaussianNB.py:23``): ``log prior - sum(log(2πσ²))/2 - sum((x-μ)²/σ²)/2``."""
    const = -0.5 * torch.sum(torch.log(2.0 * math.pi * variances), dim=1)
    diff = xl[:, None, :] - means[None, :, :]
    mahal = -0.5 * torch.sum(diff * diff / variances[None, :, :], dim=2)
    return log_prior[None, :] + const[None, :] + mahal


def _logsumexp(a: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """heat_tpu's ``jax_logsumexp`` (``gaussianNB.py:223``)."""
    dims = tuple(range(a.ndim)) if axis is None else (axis,)
    amax = torch.amax(a, dim=dims, keepdim=True)
    out = torch.log(torch.sum(torch.exp(a - amax), dim=dims, keepdim=True)) + amax
    if not keepdims:
        out = out.reshape(()) if axis is None else out.squeeze(axis)
    return out


def _replicated(t: torch.Tensor, x: DNDarray) -> DNDarray:
    return DNDarray.from_global(t, None, x.device, x.comm)


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian naive Bayes classifier (heat_tpu ``gaussianNB.py:41``)."""

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None) -> "GaussianNB":
        """Full fit (heat_tpu ``gaussianNB.py:54``)."""
        self.classes_ = None
        self.theta_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None,
                    sample_weight=None) -> "GaussianNB":
        """Incremental fit (heat_tpu ``gaussianNB.py:60``): the classes are
        ``classes``, else the fitted ones, else the sorted distinct labels
        (the distributed ``unique``); the float64 moments of this rank's
        rows, one ``packed_all_reduce`` of them when ``x`` is split, then
        heat_tpu's merge with the moments fitted before."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if y.shape[0] != x.shape[0]:
            raise ValueError(f"y has {y.shape[0]} samples but x has {x.shape[0]}")
        if x.split not in (None, 0):
            x = x.resplit(0)
        if y.split != x.split:
            y = y.resplit(x.split)
        n = x.shape[0]
        comm = x.comm
        xl = x.larray.to(torch.float64)
        yl = y.larray.reshape(-1)
        if classes is not None:
            class_vals = np.asarray(classes.numpy() if isinstance(classes, DNDarray)
                                    else classes)
        elif self.classes_ is not None:
            class_vals = np.asarray(self.classes_.numpy())
        else:
            class_vals = np.asarray(unique(y, sorted=True).numpy())
        k = len(class_vals)
        classes_t = torch.as_tensor(class_vals, device=xl.device)
        onehot = (yl[:, None] == classes_t[None, :]).to(torch.float64)  # (n_local, k)
        if sample_weight is not None:
            if isinstance(sample_weight, DNDarray):
                w = sample_weight.resplit(x.split).larray
            else:
                w = DNDarray.from_global(torch.as_tensor(np.asarray(sample_weight)).reshape(-1),
                                         x.split, x.device, comm).larray
            onehot = onehot * w.reshape(-1, 1).to(device=xl.device, dtype=torch.float64)
        moments = [onehot.sum(0), onehot.T @ xl, onehot.T @ (xl * xl), xl.sum(0),
                   (xl * xl).sum(0)]
        if x.split == 0:
            moments = fusion.packed_psum(moments, comm)
        counts, sums, sq, s1, s2 = moments
        means = sums / counts.clamp_min(1e-30)[:, None]
        variances = sq / counts.clamp_min(1e-30)[:, None] - means ** 2
        s1, s2 = s1 / n, s2 / n
        eps = self.var_smoothing * float(torch.max(s2 - s1 * s1))
        if self.theta_ is None:
            new_counts, new_means, new_vars = counts, means, variances
        else:
            # heat_tpu's merge (gaussianNB.py:122-139)
            old_counts = self.class_count_.larray.to(xl.device)
            old_means = self.theta_.larray.to(xl.device)
            old_vars = self.var_.larray.to(xl.device) - self.epsilon_
            total = old_counts + counts
            new_means = ((old_means * old_counts[:, None] + means * counts[:, None])
                         / total.clamp_min(1e-30)[:, None])
            old_ssd = old_vars * old_counts[:, None]
            new_ssd = variances * counts[:, None]
            corr = ((old_counts * counts)[:, None] / total.clamp_min(1e-30)[:, None]
                    * (old_means - means) ** 2)
            new_vars = (old_ssd + new_ssd + corr) / total.clamp_min(1e-30)[:, None]
            new_counts = total
        self.epsilon_ = eps
        self.classes_ = _replicated(classes_t, x)
        self.class_count_ = _replicated(new_counts, x)
        self.theta_ = _replicated(new_means, x)
        self.var_ = _replicated(new_vars + eps, x)
        if self.priors is not None:
            priors = np.asarray(self.priors.numpy() if isinstance(self.priors, DNDarray)
                                else self.priors)
            if len(priors) != k:
                raise ValueError("Number of priors must match number of classes.")
            if not np.isclose(priors.sum(), 1.0):
                raise ValueError("The sum of the priors should be 1.")
            if (priors < 0).any():
                raise ValueError("Priors must be non-negative.")
            self.class_prior_ = _replicated(torch.as_tensor(priors, device=xl.device), x)
        else:
            self.class_prior_ = _replicated(new_counts / new_counts.sum(), x)
        return self

    def _joint_log_likelihood(self, x: DNDarray):
        """(this rank's (n, k) joint log likelihood, ``x`` split along 0 or
        not at all) (heat_tpu ``gaussianNB.py:163``): under
        ``fusion.fit_enabled()`` one ``fit_step_call`` program (heat_tpu
        ``:178``)."""
        if x.split not in (None, 0):
            x = x.resplit(0)
        xl = x.larray.to(torch.float64)
        args = (xl, self.theta_.larray.to(xl.device), self.var_.larray.to(xl.device),
                torch.log(self.class_prior_.larray.to(xl.device)))
        if not fusion.fit_enabled():
            return _jll(*args), x
        jll = fusion.fit_step_call(
            ("gnb.jll", tuple(xl.shape), args[1].shape[0], str(xl.dtype), x.split,
             str(xl.device)), lambda qk, ck, hk: _jll, args, _jll)
        return jll, x

    def logsumexp(self, a, axis=None, b=None, keepdims=False, return_sign=False):
        """Stable log-sum-exp (heat_tpu ``gaussianNB.py:187``): replicated
        for a DNDarray."""
        if isinstance(a, DNDarray):
            return _replicated(_logsumexp(a._logical(), axis, keepdims), a)
        return _logsumexp(torch.as_tensor(a), axis, keepdims)

    def predict(self, x: DNDarray) -> DNDarray:
        """The class of greatest joint likelihood of each row (heat_tpu
        ``gaussianNB.py:194``), split as ``x``."""
        jll, xs = self._joint_log_likelihood(x)
        classes = self.classes_.larray.to(jll.device)
        labels = classes[torch.argmax(jll, dim=1)]
        return DNDarray(labels, (xs.shape[0],), types.canonical_heat_type(labels.dtype),
                        xs.split, xs.device, xs.comm)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Log class probabilities (heat_tpu ``gaussianNB.py:205``)."""
        jll, xs = self._joint_log_likelihood(x)
        res = jll - _logsumexp(jll, axis=1, keepdims=True)
        return DNDarray(res, (xs.shape[0], res.shape[1]), types.canonical_heat_type(res.dtype),
                        xs.split, xs.device, xs.comm)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Class probabilities (heat_tpu ``gaussianNB.py:215``)."""
        lp = self.predict_log_proba(x)
        return DNDarray(torch.exp(lp.larray), lp.gshape, lp.dtype, lp.split, lp.device, lp.comm)
