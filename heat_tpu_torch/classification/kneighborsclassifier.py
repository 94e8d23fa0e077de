"""K-nearest-neighbours classifier (heat_tpu
``classification/kneighborsclassifier.py``).

A replicated training set (or a world of one rank): the distance matrix of
the test rows to it, ``cdist(..., quadratic_expansion=True)`` — on the card
ONE ``cdist_tile`` launch — then the k smallest of each row and the vote
over the sorted distinct labels (``:200-214``). A split training set at
world size > 1: heat_tpu's ring (``:49-93``) — each rank keeps its test
rows, the (train block, labels) pairs travel one rank a step in ONE
``ring_step`` each (heat_tpu's two ``ppermute`` of a step, packed), each
step's tile ``max(|x|² + |y|² − 2·x·yᵀ, 0)`` is ``cdist_tile(...,
sqrt=False)`` and a running k-smallest merge keeps the candidates; the
vote then takes the most frequent label, the smallest on a tie.

Among equal distances the k smallest are picked in heat_tpu's order (its
stable ``lax.top_k``): the earlier column first, the running candidates
before a new block.
"""

from __future__ import annotations

import torch

from ..core import fusion, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.kernels import cdist_tile
from ..spatial.distance import cdist

__all__ = ["KNeighborsClassifier"]


def _k_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """The column indices of each row's ``k`` smallest values in heat_tpu's
    order (its stable ``lax.top_k``): by value, then by column.
    ``torch.topk`` of ``k + 1`` finds them; a row whose ``k + 1``-th value
    equals its ``k``-th has a tie across the cut and takes a stable sort."""
    if d.shape[1] > k:
        vals, idx = torch.topk(d, k + 1, dim=1, largest=False)
        tied = vals[:, k] == vals[:, k - 1]
        idx = idx[:, :k]
        if bool(tied.any()):
            rows = tied.nonzero().squeeze(1)
            idx[rows] = torch.argsort(d[rows], dim=1, stable=True)[:, :k]
    else:
        idx = torch.arange(d.shape[1], device=d.device).expand(d.shape[0], -1)
    idx = idx.sort(dim=1).values
    return idx.gather(1, torch.argsort(d.gather(1, idx), dim=1, stable=True))


def _label_sentinel(dtype: torch.dtype):
    """The largest value of the label type: the tie-break filler."""
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _vote(labels: torch.Tensor) -> torch.Tensor:
    """Each row's most frequent of its k labels, the smallest on a tie
    (heat_tpu ``_vote`` ``:38``)."""
    counts = (labels[:, :, None] == labels[:, None, :]).sum(dim=1)
    best = counts == counts.amax(dim=1, keepdim=True)
    cand = torch.where(best, labels, torch.full((), _label_sentinel(labels.dtype),
                                                dtype=labels.dtype, device=labels.device))
    return cand.amin(dim=1) if labels.dtype != torch.bool else cand.all(dim=1)


def _ring_predict(xq: torch.Tensor, train: torch.Tensor, labels: torch.Tensor, n_train: int,
                  k: int, dt, comm):
    """heat_tpu's ring program (``_ring_predict_fn`` ``:49``) on this rank's
    test rows ``xq`` against this rank's ``train`` shard of ``n_train``
    rows: ``comm.size`` steps, ONE ``ring_step`` of the packed (train block,
    labels) between them."""
    counts, _ = comm.counts_displs(n_train)
    width = max(counts)
    y = train.to(dt)
    lab = labels
    if y.shape[0] < width:  # the ring moves equal blocks
        y = torch.cat([y, y.new_zeros((width - y.shape[0],) + tuple(y.shape[1:]))])
        lab = torch.cat([lab, lab.new_zeros((width - lab.shape[0],))])
    yb = y.element_size() * y.shape[1]
    msg = torch.cat([y.contiguous().view(torch.uint8).reshape(width, yb),
                     lab.contiguous().view(torch.uint8).reshape(width, -1)], dim=1)
    xq = xq.to(dt).contiguous()
    r = xq.shape[0]
    best_d = torch.full((r, k), float("inf"), dtype=dt, device=xq.device)
    best_l = torch.zeros((r, k), dtype=lab.dtype, device=xq.device)
    for step in range(comm.size):
        c = counts[(comm.rank - step) % comm.size]
        blk = msg[:c, :yb].contiguous().view(dt).reshape(c, -1)
        blab = msg[:c, yb:].contiguous().view(lab.dtype).reshape(c)
        tile = cdist_tile(xq, blk, sqrt=False, out_dtype=dt)
        cand_d = torch.cat([best_d, tile], dim=1)
        cand_l = torch.cat([best_l, blab[None, :].expand(r, c)], dim=1)
        pick = _k_smallest(cand_d, k)
        best_d, best_l = cand_d.gather(1, pick), cand_l.gather(1, pick)
        if step != comm.size - 1:
            msg = comm.ring_step(msg)
    return _vote(best_l)


class KNeighborsClassifier(ClassificationMixin, BaseEstimator):
    """KNN voting classifier (heat_tpu ``kneighborsclassifier.py:134``)."""

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x = None
        self.y = None

    def fit(self, x: DNDarray, y: DNDarray):
        """Store the training set (heat_tpu ``:142``)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        self.x = x
        self.y = y
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The vote of each row's k nearest training points (heat_tpu
        ``:150``): the ring for a split training set at world size > 1,
        else one distance matrix against the replicated training set."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        if x.split not in (None, 0):
            x = x.resplit(0)
        k = self.n_neighbors
        comm = x.comm
        if k > self.x.shape[0]:
            raise ValueError(f"n_neighbors={k} exceeds the {self.x.shape[0]} training points")
        if self.x.split == 0 and comm.size > 1:
            if x.split is None:
                x = x.resplit(0)
            yt = self.y if self.y.split == 0 else self.y.resplit(0)
            dt = types.promote_types(x.dtype, self.x.dtype).torch_type()
            dt = dt if dt.is_floating_point else torch.float32
            n_train = self.x.shape[0]

            def ring(xq, train, labels):
                return _ring_predict(xq, train, labels, n_train, k, dt, comm)

            args = (x.larray, self.x.larray, yt.larray.reshape(-1))
            if fusion.fit_enabled():
                # predict-assign as one program (heat_tpu kneighborsclassifier.py:182-186)
                winner = fusion.fit_step_call(
                    ("knn.ring", k, n_train, tuple(tuple(a.shape) for a in args), str(dt),
                     str(args[2].dtype), fusion._comm_key(comm), str(args[0].device)),
                    lambda qk, ck, hk: ring, args, ring)
            else:
                winner = ring(*args)
            return DNDarray(winner, (x.shape[0],), types.canonical_heat_type(winner.dtype), 0,
                            x.device, comm)
        d = cdist(x, self.x.resplit(None), quadratic_expansion=True)
        idx = _k_smallest(d.larray, k)
        yl = self.y.resplit(None).larray.reshape(-1).to(idx.device)
        labels = yl[idx]
        classes = torch.unique(yl)  # sorted
        votes = (labels[:, :, None] == classes[None, None, :]).sum(dim=1)
        winner = classes[torch.argmax(votes, dim=1)]
        return DNDarray(winner, (x.shape[0],), types.canonical_heat_type(winner.dtype), d.split,
                        x.device, x.comm)
