"""Shared k-clustering machinery (heat_tpu ``cluster/_kcluster.py``).

The one Lloyd loop (:meth:`_KCluster._run_lloyd`), centroid seeding
(explicit, random rows, k-means++), nearest-centroid assignment, and the
out-of-core fit (:meth:`_KCluster.fit_stream`): a re-iterable chunk source
(an ``io.DataStream``, a callable or a sequence of split-0 chunks) is read
epoch by epoch, chunk by chunk, so the data never has to fit in memory.
:class:`_ManhattanKCluster` is the fit shared by KMedians and KMedoids.
"""

from __future__ import annotations

import numbers
from typing import Callable, Optional

import numpy as np
import torch

from ..core import fusion
from ..core import random as ht_random
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray

__all__ = ["_KCluster", "_ManhattanKCluster", "manhattan_to"]


def manhattan_to(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``(n, k)`` summed absolute differences of every row to every
    centroid, one centroid at a time (an (n, d) temporary, not (n, k, d))."""
    if x.shape[0] == 0:
        return x.new_zeros((0, centroids.shape[0]))
    return torch.stack([(x - c).abs().sum(dim=1) for c in centroids], dim=1)


def _chunk_source(stream, rows_per_chunk):
    """``(factory, shape_hint)`` of a ``fit_stream`` source (heat_tpu
    ``_kcluster.py:35``): ``factory()`` yields a fresh pass of split-0
    chunks. An ``io.DataStream`` is reopened each pass and gives its shape;
    a zero-argument callable returns an iterable; a sequence is replayed."""
    if hasattr(stream, "iter_chunks"):
        if rows_per_chunk is None:
            raise ValueError("rows_per_chunk is required when streaming from a DataStream source")
        return (lambda: stream.iter_chunks(rows_per_chunk),
                tuple(getattr(stream, "shape", ()) or ()) or None)
    if callable(stream):
        return stream, None
    seq = list(stream)
    if not seq:
        raise ValueError("fit_stream needs at least one chunk")
    return (lambda: iter(seq)), None


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class of the k-clustering estimators (heat_tpu ``_kcluster.py:55``)."""

    def __init__(self, metric: Callable, n_clusters: int, init, max_iter: int, tol: float,
                 random_state):
        if (isinstance(n_clusters, bool) or not isinstance(n_clusters, numbers.Integral)
                or n_clusters < 1):
            raise ValueError(f"n_clusters must be a positive int, got {n_clusters!r}")
        self.n_clusters = int(n_clusters)
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None
        self._metric = metric

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _converged(self, shift_sq: float) -> bool:
        return self.tol >= 0 and shift_sq <= self.tol * self.tol

    def _run_lloyd(self, step, xp: torch.Tensor, centroids: torch.Tensor):
        """The shared Lloyd loop (heat_tpu ``_kcluster.py:103``).
        ``step(xp, centroids) -> (new_centroids, shift, aux)``; the
        ``float(shift)`` read is the per-iteration host sync, kept also when
        ``tol < 0`` runs every iteration. Returns ``(centroids, aux, n_iter)``."""
        it = 0
        aux = None
        for it in range(1, self.max_iter + 1):
            centroids, shift, aux = step(xp, centroids)
            if self._converged(float(shift)):
                break
        return centroids, aux, it

    # ------------------------------------------------------------------ #
    # out-of-core fit (heat_tpu ``_kcluster.py:124-295``)                #
    # ------------------------------------------------------------------ #
    def _stream_chunk_update(self, chunk: DNDarray, centroids: torch.Tensor) -> torch.Tensor:
        """One minibatch update from one chunk (heat_tpu ``_kcluster.py:124``).
        KMedians and KMedoids take it (:class:`_ManhattanKCluster`); KMeans
        replaces the whole epoch with its exact form."""
        raise NotImplementedError(f"{type(self).__name__} does not implement streamed fitting")

    def _stream_epoch(self, chunks, centroids: torch.Tensor, meta):
        """One pass over the chunks (heat_tpu ``_kcluster.py:145``): the
        minibatch form, the centroids updated after every chunk. Returns
        ``(centroids, epoch shift squared)``."""
        start = centroids.clone()
        for chunk in chunks():
            centroids = self._stream_chunk_update(chunk, centroids)
        return centroids, torch.sum((centroids - start) ** 2)

    def _stream_dtype(self, chunk: DNDarray) -> torch.dtype:
        return torch.float32

    def _init_stream_centers(self, chunks, shape_hint):
        """Streamed seeding (heat_tpu ``_kcluster.py:161``), equal to the
        in-memory seeding for the inits it takes: explicit ``(k, d)``
        centroids, or ``"random"``, the same Threefry ``randint`` draw as
        the in-memory fit, its rows collected in one pass over the chunks
        (which ends once all are found). ``"kmeans++"`` raises: it needs a
        full distance pass per seed. Returns ``(centroids, meta)``, ``meta``
        the stream's geometry."""
        k = self.n_clusters
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        random_init = isinstance(self.init, str) and self.init == "random"
        if isinstance(self.init, str) and self.init in ("kmeans++", "probability_based"):
            raise ValueError("fit_stream supports init='random' or explicit centroids; "
                             "kmeans++ seeding needs full-data distance passes")
        meta = {"n": 0, "d": None, "comm": None, "device": None}
        if random_init:
            if shape_hint is not None:
                meta["n"] = int(shape_hint[0])
            else:  # a first pass counts the rows
                for chunk in chunks():
                    meta["n"] += chunk.shape[0]
        want, rows, lo = None, {}, 0
        it = chunks()
        for chunk in it:
            if meta["d"] is None:
                if chunk.ndim != 2:
                    raise ValueError("fit_stream chunks must be 2-D (rows, features)")
                meta.update(d=chunk.shape[1], comm=chunk.comm, device=chunk.device,
                            dtype=self._stream_dtype(chunk))
                if random_init:
                    if meta["n"] <= 0:
                        raise ValueError("fit_stream saw zero rows")
                    want = ht_random.randint(0, meta["n"], (k,), device=chunk.device,
                                             comm=chunk.comm).numpy()
            hi = lo + chunk.shape[0]
            if want is None:  # explicit init: only the geometry was needed
                lo = hi
                break
            sel = [(j, int(g) - lo) for j, g in enumerate(want) if lo <= int(g) < hi]
            if sel:
                got = chunk[np.asarray([r for _, r in sel])].resplit(None).larray
                for (j, _), row in zip(sel, got):
                    rows[j] = row
            lo = hi
            if len(rows) == len(want):
                break
        if hasattr(it, "close"):  # a pass ended early: a generator's close shuts its file
            it.close()
        meta["n"] = int(shape_hint[0]) if shape_hint is not None else max(meta["n"], lo)
        if meta["d"] is None:
            raise ValueError("fit_stream needs at least one chunk")
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, meta["d"]):
                raise ValueError(f"passed centroids must have shape ({k}, {meta['d']}), "
                                 f"got {self.init.shape}")
            centers = self.init.resplit(None).larray
        elif want is not None:
            missing = [int(want[j]) for j in range(k) if j not in rows]
            if missing:
                raise ValueError(f"fit_stream random init: drawn seed rows {missing} were never "
                                 f"produced by the stream (stream shorter than its declared "
                                 f"{meta['n']} rows?)")
            centers = torch.stack([rows[j] for j in range(k)])
        else:
            raise ValueError(f"initialization method {self.init!r} is not supported "
                             "for fit_stream")
        return centers.to(device=meta["device"].torch_device, dtype=meta["dtype"]).clone(), meta

    def fit_stream(self, stream, rows_per_chunk: Optional[int] = None):
        """Out-of-core fit from a re-iterable chunk source (heat_tpu
        ``_kcluster.py:253``): an ``io.DataStream`` (``ht.load_hdf5(...,
        stream=True)``), reread from its file each epoch, so one chunk at a
        time is resident; a zero-argument callable returning a fresh chunk
        iterable; or a sequence of split-0 chunks. KMeans runs the exact
        epoch (partials accumulated over the chunks, the centroids updated
        once per epoch); KMedians and KMedoids the minibatch form.
        ``labels_`` stays None; ``n_iter_`` and ``cluster_centers_`` are set
        as by ``fit``."""
        chunks, shape_hint = _chunk_source(stream, rows_per_chunk)
        centroids, meta = self._init_stream_centers(chunks, shape_hint)
        it = 0
        for it in range(1, self.max_iter + 1):
            centroids, shift = self._stream_epoch(chunks, centroids, meta)
            if self._converged(float(shift)):
                break
        self._stream_finalize(chunks, centroids, meta)
        self._cluster_centers = DNDarray.from_global(centroids, None, meta["device"],
                                                     meta["comm"])
        self._labels = None
        self._n_iter = it
        return self

    def _stream_finalize(self, chunks, centroids: torch.Tensor, meta) -> None:
        """After the last epoch, with the final centroids (heat_tpu
        ``_kcluster.py:290``): nothing here; KMeans spends one more pass on
        ``inertia_``."""

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Centroid seeding (heat_tpu ``_kcluster.py:297``)."""
        k = self.n_clusters
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, x.shape[1]):
                raise ValueError(
                    f"passed centroids must have shape ({k}, {x.shape[1]}), got {self.init.shape}")
            self._cluster_centers = self.init.resplit(None)
            return
        if self.init == "random":
            idx = ht_random.randint(0, x.shape[0], (k,), device=x.device, comm=x.comm)
            self._cluster_centers = x[idx.numpy()].resplit(None)
            return
        if self.init in ("kmeans++", "probability_based"):
            self._cluster_centers = self._kmeanspp(x)
            return
        raise ValueError(f"initialization method {self.init!r} is not supported")

    def _kmeanspp(self, x: DNDarray) -> DNDarray:
        """k-means++ D²-weighted seeding (heat_tpu ``_kcluster.py:326``): the
        min squared distance per point runs on the card, the weighted draw on
        the host."""
        n = x.shape[0]
        k = self.n_clusters
        first = int(ht_random.randint(0, n, (1,), device=x.device, comm=x.comm).numpy()[0])

        def row(i):
            return x[np.asarray([i])].resplit(None).larray

        centers = row(first)
        for _ in range(1, k):
            d2 = self._pairwise_sq_dist_to(x, centers).cpu().numpy()
            u = float(ht_random.rand(1, device=x.device, comm=x.comm).numpy()[0])
            total = max(float(d2.sum()), 1e-30)
            cdf = np.cumsum(d2 / total)
            nxt = min(int(np.searchsorted(cdf, u)), n - 1)
            centers = torch.cat([centers, row(nxt)])
        return DNDarray.from_global(centers, None, x.device, x.comm)

    def _pairwise_sq_dist_to(self, x: DNDarray, centers: torch.Tensor) -> torch.Tensor:
        """Min squared distance of every point to the current centers
        (heat_tpu ``_kcluster.py:354``), replicated on every rank."""
        from ..spatial.distance import cdist

        c = DNDarray.from_global(centers, None, x.device, x.comm)
        d = cdist(x, c, quadratic_expansion=True)
        return d.min(axis=1).resplit(None).larray ** 2

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        d = self._metric(x, self._cluster_centers)
        return d.argmin(axis=1)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid of each sample (heat_tpu ``_kcluster.py:371``)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        return self._assign_to_cluster(x)


def _fit_program(name: str, step, n: int, k: int, comm):
    """A distributed manhattan step under ``fusion.fit_enabled()``: each call
    one :func:`~heat_tpu_torch.core.fusion.fit_step_call` program keyed by
    ``name``, the shard's shape, ``n``, ``k`` and the communicator (heat_tpu
    ``kmedians.py:150-160``, ``kmedoids.py:150-158``), with ``step`` itself
    as the eager path; ``step`` as it is with the switch off."""
    if not fusion.fit_enabled():
        return step

    def program_step(xb, cent):
        return fusion.fit_step_call(
            (name, tuple(xb.shape), n, k, fusion._comm_key(comm), str(xb.device)),
            lambda qk, ck, hk: step, (xb, cent), step)

    return program_step


class _ManhattanKCluster(_KCluster):
    """The fit shared by KMedians and KMedoids (heat_tpu ``kmedians.py:175``,
    ``kmedoids.py:166``): the manhattan metric, float32 data, the
    distributed step on split-0 data over several ranks, the local step
    otherwise, in memory and chunk by chunk."""

    def __init__(self, n_clusters: int, init, max_iter: int, tol: float, random_state):
        from ..spatial.distance import manhattan

        super().__init__(metric=lambda x, y: manhattan(x, y), n_clusters=n_clusters, init=init,
                         max_iter=max_iter, tol=tol, random_state=random_state)

    def _step_dispatcher(self, n: int, comm):
        """The distributed step ``(shard, centroids) -> (new_centroids, shift,
        labels)`` over ``n`` rows split along axis 0."""
        raise NotImplementedError

    def _local_step(self, x: torch.Tensor, centroids: torch.Tensor):
        """The step ``(x, centroids) -> (new_centroids, shift, labels)`` on
        data every rank holds."""
        raise NotImplementedError

    def fit(self, x: DNDarray):
        """Iterations through the shared Lloyd loop; ``labels_`` are the last
        step's assignment."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.split not in (None, 0):
            x = x.resplit(0)
        self._initialize_cluster_centers(x)
        n = x.shape[0]
        centroids = self._cluster_centers.larray.to(torch.float32).clone()
        distributed = x.split == 0 and x.comm.size > 1 and n > 0
        if distributed:
            step, data = self._step_dispatcher(n, x.comm), x.larray.to(torch.float32)
        else:
            step, data = self._local_step, x._logical().to(torch.float32)
        centroids, labels, it = self._run_lloyd(step, data, centroids)
        self._cluster_centers = DNDarray.from_global(centroids, None, x.device, x.comm)
        if distributed:
            self._labels = DNDarray(labels, (n,), types.int64, 0, x.device, x.comm)
        else:
            self._labels = DNDarray.from_global(labels, x.split, x.device, x.comm)
        self._n_iter = it
        return self

    def _stream_chunk_update(self, chunk: DNDarray, centroids: torch.Tensor) -> torch.Tensor:
        """The distributed step on a split-0 chunk of a world of several
        ranks, the local step on the chunk's rows otherwise."""
        n = chunk.shape[0]
        if chunk.split == 0 and chunk.comm.size > 1 and n > 0:
            xp = chunk.larray.to(torch.float32)
            centroids, _, _ = self._step_dispatcher(n, chunk.comm)(xp, centroids)
            return centroids
        centroids, _, _ = self._local_step(chunk._logical().to(torch.float32), centroids)
        return centroids
