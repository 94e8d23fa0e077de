"""KMedoids clustering (heat_tpu ``cluster/kmedoids.py``).

The manhattan assignment, then each cluster's member mean, then the snap of
the mean to its nearest member. On split-0 data over several ranks one step
is heat_tpu's distributed program (``_kmedoids_step_fn`` with packed
collectives, ``kmedoids.py:31-93``): one all-reduce of the counts, the
member sums in one packed all-reduce, the nearest member through two
all-reduces (min) of (distance, global row), so ties go to the lowest
global row, and the winning rows in one more packed all-reduce; the data is
never gathered. The iteration stops at the exact fixpoint.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import fusion
from ..core._sort import _positions
from ..core.dndarray import DNDarray
from ._kcluster import _ManhattanKCluster, _fit_program, manhattan_to

__all__ = ["KMedoids"]


def _snap(x, member, means):
    """Per cluster, the smallest manhattan distance of a member to the mean
    and the first row that has it; inf and row 0 for a cluster without
    members here."""
    k = means.shape[0]
    if x.shape[0] == 0:
        return (x.new_full((k,), float("inf")),
                torch.zeros(k, dtype=torch.int64, device=x.device))
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    return torch.min(torch.where(member, manhattan_to(x, means), inf), dim=0)


class KMedoids(_ManhattanKCluster):
    """K-Medoids with the manhattan assignment (heat_tpu ``kmedoids.py:127``)."""

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random",
                 max_iter: int = 300, random_state: Optional[int] = None):
        super().__init__(n_clusters, init, max_iter, -1.0, random_state)

    def _converged(self, shift_sq: float) -> bool:
        """The medoids snap to data points, so the fixpoint is exact
        (heat_tpu ``kmedoids.py:143``)."""
        return shift_sq == 0.0

    def _step_dispatcher(self, n: int, comm):
        """The distributed step ``(shard, centroids) -> (new_centroids, shift,
        labels)`` over ``n`` rows split along axis 0 (heat_tpu
        ``_kmedoids_step_fn``)."""
        k = self.n_clusters
        c = comm.chunk_size(n)
        big = torch.iinfo(torch.int64).max

        def step(xb, cent):
            labels = torch.argmin(manhattan_to(xb, cent), dim=1)
            member = labels[:, None] == torch.arange(k, device=xb.device)[None, :]
            counts = comm.Allreduce(member.sum(dim=0), "sum")
            (sums,) = fusion.packed_psum([member.to(xb.dtype).T @ xb], comm)
            means = sums / torch.clamp(counts, min=1).to(xb.dtype)[:, None]
            loc_v, loc_i = _snap(xb, member, means)
            gpos = _positions(comm, c, xb.device)
            gmin = comm.Allreduce(loc_v.clone(), "min")
            g_win = comm.Allreduce(torch.where(loc_v == gmin, gpos[loc_i], big), "min")
            winner = (gpos[:xb.shape[0], None] == g_win[None, :]).to(xb.dtype)
            (medoids,) = fusion.packed_psum([winner.T @ xb], comm)
            new = torch.where((counts > 0)[:, None], medoids, cent)
            return new, torch.sum((new - cent) ** 2), labels

        return _fit_program("kmedoids.step", step, n, k, comm)

    def _local_step(self, x: torch.Tensor, centroids: torch.Tensor):
        """The step on data every rank holds (heat_tpu
        ``_kmedoids_eager_step``, ``kmedoids.py:96``)."""
        k = self.n_clusters
        labels = torch.argmin(manhattan_to(x, centroids), dim=1)
        member = labels[:, None] == torch.arange(k, device=x.device)[None, :]
        counts = member.sum(dim=0)
        means = (member.to(x.dtype).T @ x) / torch.clamp(counts, min=1).to(x.dtype)[:, None]
        _, rows = _snap(x, member, means)
        new = torch.where((counts > 0)[:, None], x[rows], centroids)
        return new, torch.sum((new - centroids) ** 2), labels
