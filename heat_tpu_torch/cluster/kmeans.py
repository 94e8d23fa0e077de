"""KMeans clustering (heat_tpu ``cluster/kmeans.py``).

One Lloyd step on split-0 data is the ``kmeans_step`` kernel over the local
shard (X read once), then ONE packed all-reduce of the sums, counts and
inertia (:func:`~heat_tpu_torch.core.fusion.packed_psum`), then the centroid
update. At world size 1 the all-reduce emits nothing. Under
``fusion.fit_enabled()`` each step is one
:func:`~heat_tpu_torch.core.fusion.fit_step_call` program (heat_tpu
``kmeans.py:436-460``; a CUDA graph on a card, whose ``kmeans_step`` launch
counts at each replay); the ``float(shift)`` read stays outside it, in
``_run_lloyd``. Labels are computed once, after the loop.

``fit_stream`` runs heat_tpu's exact out-of-core epoch: each chunk's
partials (one ``kmeans_step`` launch, then one packed all-reduce) add into
device buffers, one ``fit_step_call`` program a chunk under
``fusion.fit_enabled()`` (heat_tpu ``:530``; run eagerly on the card too,
as each chunk is a new host copy), and the centroids update once per
epoch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import fusion, types
from ..core.dndarray import DNDarray
from ..core.kernels import kmeans_step
from ._kcluster import _KCluster

__all__ = ["KMeans"]


def _finish_update(sums, counts, centroids):
    """Centroid division, empty-cluster keep and squared shift (heat_tpu
    ``kmeans.py:46``), in the accumulation dtype; the new centroids keep the
    carried dtype."""
    cacc = centroids.to(sums.dtype)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    new = torch.where((counts > 0)[:, None], new, cacc)
    shift = torch.sum((new - cacc) ** 2)
    return new.to(centroids.dtype), shift


def _lloyd_partial(xp, centroids, acc):
    """Lloyd partials ``(sums, counts, inertia)`` for half-precision data
    (heat_tpu ``kmeans.py:58``): storage-dtype operands, products and sums
    accumulated in ``acc``."""
    k = centroids.shape[0]
    xf = xp.to(acc)
    cj = centroids.to(xp.dtype).to(acc)
    x2 = torch.sum(xf * xf, dim=1, keepdim=True)
    cacc = centroids.to(acc)
    c2 = torch.sum(cacc * cacc, dim=1, keepdim=True).T
    d2 = x2 + c2 - 2.0 * (xf @ cj.T)
    min_d2, labels = torch.min(d2, dim=1)
    onehot = (labels[:, None] == torch.arange(k, device=xp.device)[None, :]).to(acc)
    return onehot.T @ xf, onehot.sum(dim=0), min_d2.sum()


def _partials(xp, centroids):
    """Lloyd partials ``(sums, counts, inertia)`` of one shard or chunk, by
    heat_tpu's dtype rule (``_use_pallas_step``, ``kmeans.py:134``):
    float32 and float64 take the ``kmeans_step`` kernel; half precision
    takes ``_lloyd_partial`` in float32, since the kernel's outputs are in
    the input dtype, which would round counts above 256. An empty shard
    launches nothing."""
    acc = types.accumulation_dtype(xp.dtype)
    if xp.shape[0] == 0:
        k, d = centroids.shape
        return (xp.new_zeros((k, d), dtype=acc), xp.new_zeros(k, dtype=acc),
                xp.new_zeros((), dtype=acc))
    if acc == xp.dtype:
        return kmeans_step(xp, centroids)
    return _lloyd_partial(xp, centroids, acc)


def _assign(xp, centroids):
    """Final assignment: labels and inertia against the same centroids
    (heat_tpu ``kmeans.py:310``)."""
    acc = types.accumulation_dtype(xp.dtype)
    xf = xp.to(acc)
    cacc = centroids.to(acc)
    c2 = torch.sum(cacc * cacc, dim=1)[None, :]
    scores = c2 - 2.0 * (xf @ centroids.to(xp.dtype).to(acc).T)
    min_s, labels = torch.min(scores, dim=1)
    return labels, torch.sum(torch.sum(xf * xf, dim=1) + min_s)


class KMeans(_KCluster):
    """K-Means with Lloyd's algorithm (heat_tpu ``kmeans.py:408``).

    ``n_clusters``, ``init`` ("random", "kmeans++" or a (k, d) DNDarray),
    ``max_iter``, ``tol`` (a negative tol runs every iteration) and
    ``random_state``.
    """

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random",
                 max_iter: int = 300, tol: float = 1e-4,
                 random_state: Optional[int] = None):
        from ..spatial.distance import cdist

        super().__init__(
            metric=lambda x, y: cdist(x, y, quadratic_expansion=True),
            n_clusters=n_clusters, init=init, max_iter=max_iter, tol=tol,
            random_state=random_state)

    def _lloyd_step(self, comm, split):
        """``step(xp, centroids) -> (new_centroids, shift, inertia)`` on the
        local shard: :func:`_partials`, one packed all-reduce for split-0
        data, the centroid update; under ``fusion.fit_enabled()`` one
        ``fit_step_call`` program (heat_tpu ``_lloyd_dispatcher``)."""
        k = self.n_clusters

        def body(xp, centroids):
            sums, counts, inertia = _partials(xp, centroids)
            if split == 0:
                sums, counts, inertia = fusion.packed_psum([sums, counts, inertia], comm)
            new_centroids, shift = _finish_update(sums, counts, centroids)
            return new_centroids, shift, inertia

        if not fusion.fit_enabled():
            return body

        def step(xp, centroids):
            return fusion.fit_step_call(
                ("kmeans.lloyd", tuple(xp.shape), str(xp.dtype), k, fusion._comm_key(comm),
                 split, str(xp.device)),
                lambda qk, ck, hk: body, (xp, centroids), body)

        return step

    def fit(self, x: DNDarray) -> "KMeans":
        """Lloyd iteration to convergence (heat_tpu ``kmeans.py:466``)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError("input needs to be 2-dimensional (n_samples, n_features)")
        if x.split not in (None, 0):
            x = x.resplit(0)

        self._initialize_cluster_centers(x)
        dtype = types.float32.torch_type() if types.heat_type_is_exact(x.dtype) \
            else x.dtype.torch_type()
        xp = x.larray.to(dtype).contiguous()  # a column slice is a strided view
        centroids = self._cluster_centers.larray.to(dtype).clone()
        step = self._lloyd_step(x.comm, x.split)
        centroids, _, it = self._run_lloyd(step, xp, centroids)

        self._cluster_centers = DNDarray.from_global(centroids, None, x.device, x.comm)
        labels, inertia = _assign(xp, centroids)
        if x.split == 0:
            inertia = x.comm.Allreduce(inertia, "sum")
        self._labels = DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device,
                                x.comm)
        self._inertia = float(inertia)
        self._n_iter = it
        return self

    # ------------------------------------------------------------------ #
    # out-of-core fit: the exact epoch (heat_tpu ``kmeans.py:506-557``)  #
    # ------------------------------------------------------------------ #
    def _stream_dtype(self, chunk: DNDarray) -> torch.dtype:
        return (types.float32 if types.heat_type_is_exact(chunk.dtype)
                else chunk.dtype).torch_type()

    def _stream_accumulate(self, chunks, centroids, meta):
        """One pass over the stream: each chunk's :func:`_partials` (one
        ``kmeans_step`` launch for float32/float64), one packed all-reduce
        of them for a split-0 chunk (none at world size 1, as heat_tpu's
        per-chunk ``packed_psum``), added into device buffers."""
        acc = types.accumulation_dtype(meta["dtype"])
        k, d = self.n_clusters, meta["d"]
        dev = centroids.device
        sums = torch.zeros((k, d), dtype=acc, device=dev)
        counts = torch.zeros(k, dtype=acc, device=dev)
        inertia = torch.zeros((), dtype=acc, device=dev)
        for chunk in chunks():
            xp = chunk.larray.to(meta["dtype"]).contiguous()
            split = 0 if chunk.split == 0 else None
            body = self._stream_partial(chunk.comm, split)
            args = (xp, centroids, sums, counts, inertia)
            if fusion.fit_enabled():
                # eager on the card too: a chunk arrives from the host each
                # call, so a graph would need a chunk-sized buffer of its own
                # (the stream holds one chunk at a time) to save one launch
                sums, counts, inertia = fusion.fit_step_call(
                    ("kmeans.stream", tuple(xp.shape), str(xp.dtype), k,
                     fusion._comm_key(chunk.comm), split, str(xp.device)),
                    lambda qk, ck, hk, _b=body: fusion._Program(_b, graph=False), args, body)
            else:
                sums, counts, inertia = body(*args)
        return sums, counts, inertia

    @staticmethod
    def _stream_partial(comm, split):
        """One chunk's partials added into the accumulators (heat_tpu
        ``_stream_partial_fn``): ``(xp, centroids, sums, counts, inertia) ->
        the updated three``."""
        def body(xp, centroids, sums, counts, inertia):
            part = _partials(xp, centroids)
            if split == 0:
                part = fusion.packed_psum(part, comm)
            return sums + part[0], counts + part[1], inertia + part[2]

        return body

    def _stream_epoch(self, chunks, centroids, meta):
        """One exact Lloyd epoch out of core: the centroids update once,
        from the accumulated pass, so the streamed fit equals the in-memory
        fit up to the order of the float sums."""
        sums, counts, _ = self._stream_accumulate(chunks, centroids, meta)
        return _finish_update(sums, counts, centroids)

    def _stream_finalize(self, chunks, centroids, meta) -> None:
        """One more pass against the final centroids, so that ``inertia_``
        means what it does after ``fit``."""
        _, _, inertia = self._stream_accumulate(chunks, centroids, meta)
        self._inertia = float(inertia)
