"""Spectral clustering (heat_tpu ``cluster/spectral.py``).

rbf similarity (the ``cdist_tile`` kernel's float32 squared distances) →
``Laplacian.construct`` → ``lanczos`` (one all-gather an iteration, its
start a Threefry draw) → ``torch.linalg.eigh`` of the small tridiagonal T →
``V @ evecs`` → KMeans with k-means++ seeding (the ``kmeans_step`` kernel)
on the leading eigenvectors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.linalg import lanczos, matmul
from ..graph.laplacian import Laplacian
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering on the graph Laplacian (heat_tpu ``spectral.py:32``)."""

    def __init__(self, n_clusters: Optional[int] = None, gamma: float = 1.0,
                 metric: str = "rbf", laplacian: str = "fully_connected",
                 threshold: float = 1.0, boundary: str = "upper", n_lanczos: int = 300,
                 assign_labels: str = "kmeans", **params):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels
        from ..spatial import distance

        if metric == "rbf":
            sigma = float(np.sqrt(1.0 / (2.0 * gamma)))
            sim = lambda x: distance.rbf(x, sigma=sigma, quadratic_expansion=True)  # noqa: E731
        elif metric == "euclidean":
            sim = lambda x: distance.cdist(x, quadratic_expansion=True)  # noqa: E731
        else:
            raise NotImplementedError(f"metric {metric!r} is not supported")
        self._laplacian = Laplacian(sim, definition="norm_sym", mode=laplacian,
                                    threshold_key=boundary, threshold_value=threshold)
        self._labels = None
        self._eigenvectors = None
        self._n_iter = None

    @property
    def labels_(self):
        return self._labels

    @property
    def n_iter_(self):
        """Lloyd iterations the embedding KMeans ran (None before fit)."""
        return self._n_iter

    def _spectral_embedding(self, x: DNDarray):
        """Eigenvalues of T and the embedding ``V @ evecs`` (heat_tpu
        ``spectral.py:82``)."""
        L = self._laplacian.construct(x)
        V, T = lanczos(L, min(self.n_lanczos, L.shape[0]))
        del L
        evals, evecs = torch.linalg.eigh(T._logical())
        return evals, matmul(V, DNDarray.from_global(evecs, None, x.device, x.comm))

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed and cluster (heat_tpu ``spectral.py:94``); without
        ``n_clusters`` the eigengap rule picks it (``:104-107``)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        evals, evecs = self._spectral_embedding(x)
        if self.n_clusters is None:
            self.n_clusters = int(torch.argmax(torch.diff(evals))) + 1
        k = int(self.n_clusters)
        if self.assign_labels != "kmeans":
            raise NotImplementedError(f"assign_labels={self.assign_labels!r} not supported")
        kmeans = KMeans(n_clusters=k, init="kmeans++")
        kmeans.fit(evecs[:, :k])
        self._labels = kmeans.labels_
        self._eigenvectors = evecs
        self._n_iter = kmeans.n_iter_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        if self._labels is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._labels
