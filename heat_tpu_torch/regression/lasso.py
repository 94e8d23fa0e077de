"""Lasso regression (heat_tpu ``regression/lasso.py``): coordinate descent
with soft thresholding, the intercept unpenalized.

Sample-split data at world size > 1 runs heat_tpu's sweep plan
(``_cd_sweep_fn``, ``lasso.py:25-84``) on the shards: per sweep ONE
all-reduce of the column norms, then per feature ONE all-reduce of the
local ``x_j · r``, the residual carried incrementally. Otherwise heat_tpu's
replicated sweep: per feature a full ``X @ θ``. theta (m + 1 values) is
the only replicated state; each sweep reads its convergence delta once on
the host.
"""

from __future__ import annotations

import torch

from ..core import factories, fusion, types
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray

__all__ = ["Lasso"]


def _with_intercept(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device), x], 1)


class Lasso(RegressionMixin, BaseEstimator):
    """L1-regularized linear regression by coordinate descent (heat_tpu
    ``lasso.py:116``)."""

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def coef_(self):
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self):
        return None if self.__theta is None else self.__theta[:1]

    @property
    def lam(self):
        return self.__lam

    @lam.setter
    def lam(self, arg):
        self.__lam = arg

    @property
    def theta(self):
        return self.__theta

    @staticmethod
    def soft_threshold(rho, lam):
        """Soft-thresholding operator (heat_tpu ``lasso.py:154``)."""
        return torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)

    @staticmethod
    def rmse(gt, yest):
        """Root mean squared error (heat_tpu ``lasso.py:159``)."""
        return float(torch.sqrt(torch.mean((torch.as_tensor(gt) - torch.as_tensor(yest)) ** 2)))

    def _update(self, j: int, rho, col_sq, lam_n):
        if j == 0:  # the intercept takes no penalty
            return rho / torch.clamp(col_sq[0], min=1e-30)
        return self.soft_threshold(rho, lam_n) / torch.clamp(col_sq[j], min=1e-30)

    def _sweep_split(self, xb, yb, theta, lam_n, comm):
        """One sweep of heat_tpu's distributed plan; returns the new theta and
        its largest change."""
        X = _with_intercept(xb)
        col_sq = comm.Allreduce(torch.sum(X * X, dim=0))
        r = yb - X @ theta
        th = theta.clone()
        for j in range(X.shape[1]):
            xj = X[:, j]
            rho = comm.Allreduce(xj @ r) + th[j] * col_sq[j]
            new = self._update(j, rho, col_sq, lam_n)
            r = r - xj * (new - th[j])
            th[j] = new
        return th, torch.max(torch.abs(th - theta))

    def _sweep_replicated(self, X, y, theta, col_sq, lam_n):
        """One sweep of heat_tpu's replicated plan: a full ``X @ θ`` per
        feature."""
        th = theta.clone()
        for j in range(X.shape[1]):
            resid = y - X @ th + X[:, j] * th[j]
            th[j] = self._update(j, X[:, j] @ resid, col_sq, lam_n)
        return th, torch.max(torch.abs(th - theta))

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate-descent fit (heat_tpu ``lasso.py:157-250``)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError("x needs to be 2-dimensional (n_samples, n_features)")
        n, m = x.shape
        lam_n = self.__lam * n
        comm = x.comm
        if x.split == 0 and comm.size > 1 and n > 0:
            if y.split != 0 or y.larray.shape[0] != x.larray.shape[0]:
                y = y.resplit(0)
            xp = x.larray.to(torch.float32)
            yp = y.larray.reshape(-1).to(torch.float32)

            def body(xp, yp, theta):
                return self._sweep_split(xp, yp, theta, lam_n, comm)

            def sweep(theta):
                if not fusion.fit_enabled():
                    return body(xp, yp, theta)
                # one program a sweep (heat_tpu lasso.py:187-194)
                return fusion.fit_step_call(
                    ("lasso.sweep", tuple(xp.shape), n, lam_n, fusion._comm_key(comm),
                     str(xp.device)), lambda qk, ck, hk: body, (xp, yp, theta), body)
        else:
            X = _with_intercept(x._logical().to(torch.float32))
            yl = y._logical().reshape(-1).to(torch.float32)
            col_sq = torch.sum(X * X, dim=0)

            def sweep(theta):
                return self._sweep_replicated(X, yl, theta, col_sq, lam_n)
        theta = torch.zeros(m + 1, dtype=torch.float32, device=x.larray.device)
        it = 0
        for it in range(1, self.max_iter + 1):
            theta, diff = sweep(theta)
            if float(diff) < self.tol:
                break
        self.n_iter = it
        self.__theta = factories.array(theta.reshape(-1, 1), dtype=types.float32,
                                       device=x.device, comm=comm)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Linear prediction (heat_tpu ``lasso.py:252``): shard-local rows
        against the replicated theta."""
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        th = self.__theta._logical().reshape(-1)
        if x.split == 0 and x.comm.size > 1:
            pred = th[0] + x.larray.to(torch.float32) @ th[1:]
            return DNDarray(pred.reshape(-1, 1), (x.shape[0], 1), types.float32, 0, x.device,
                            x.comm)
        pred = _with_intercept(x._logical().to(torch.float32)) @ th
        return DNDarray.from_global(pred.reshape(-1, 1), x.split, x.device, x.comm)
