"""KMedians clustering (heat_tpu ``cluster/kmedians.py``).

KMeans' Lloyd skeleton with the manhattan assignment and, as the centroid
update, each cluster's coordinate-wise median: the mean of the two central
order statistics of its members. On split-0 data over several ranks one
step is heat_tpu's distributed program (``_kmedians_step_fn`` with packed
collectives, ``kmedians.py:34-99``): ONE batched merge-split network sort
over all (cluster, feature) columns (non-members and the fill past a shard
keyed past every value, so each column's members lead it), one all-reduce
of the counts and one packed all-reduce of the two order statistics; the
data is never gathered. At world size 1, and for replicated data, the local
step sorts each cluster's members instead of heat_tpu's (n, k, d) NaN-masked
``nanmedian`` (2 GB at 2^20 x 64, k = 8), and picks the same two values.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import fusion
from ..core._sort import (_fill_to, _float_key_dtype, _float_sort_key, _network_sort,
                          _positions, _role_tables, batcher_rounds)
from ..core.dndarray import DNDarray
from ._kcluster import _ManhattanKCluster, _fit_program, manhattan_to

__all__ = ["KMedians"]


def _median_update(x: torch.Tensor, labels: torch.Tensor, centroids: torch.Tensor):
    """Each cluster's coordinate-wise median of its members, ``0.5 * (lo +
    hi)`` of the central order statistics (heat_tpu's ``nanmedian``, whose
    midpoint is this sum); an empty cluster keeps its centroid."""
    new = centroids.clone()
    for j in range(centroids.shape[0]):
        members = x[labels == j]
        cnt = members.shape[0]
        if cnt:
            s = torch.sort(members, dim=0).values
            new[j] = 0.5 * (s[(cnt - 1) // 2] + s[cnt // 2])
    return new


class KMedians(_ManhattanKCluster):
    """K-Medians with the manhattan assignment (heat_tpu ``kmedians.py:125``)."""

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random",
                 max_iter: int = 300, tol: float = 1e-4,
                 random_state: Optional[int] = None):
        super().__init__(n_clusters, init, max_iter, tol, random_state)

    def _step_dispatcher(self, n: int, comm):
        """The distributed step ``(shard, centroids) -> (new_centroids, shift,
        labels)`` over ``n`` rows split along axis 0 (heat_tpu
        ``_kmedians_step_fn``): a network sort, one all-reduce, one packed
        all-reduce."""
        k = self.n_clusters
        c = comm.chunk_size(n)
        rounds = batcher_rounds(comm.size)
        roles = _role_tables(rounds, comm.size)
        pad_key = torch.iinfo(_float_key_dtype(torch.float32)).max

        def step(xb, cent):
            labels = torch.argmin(manhattan_to(xb, cent), dim=1)
            member = labels[:, None] == torch.arange(k, device=xb.device)[None, :]
            counts = comm.Allreduce(member.sum(dim=0), "sum")  # (k,) int64
            vals = xb.T[None, :, :].expand(k, -1, -1)  # (k, d, rows)
            keys = torch.where(member.T[:, None, :], _float_sort_key(vals),
                               torch.full((), pad_key, dtype=torch.int32, device=xb.device))
            _, (sv,) = _network_sort(_fill_to(keys, c, pad_key), (_fill_to(vals, c, 0.0),),
                                     rounds, roles, c, False, comm)
            lo = torch.clamp(counts - 1, min=0) // 2
            hi = counts // 2
            pos = _positions(comm, c, xb.device)[None, None, :]
            zero = sv.new_zeros(())
            plo = torch.where(pos == lo[:, None, None], sv, zero).sum(dim=-1)
            phi = torch.where(pos == hi[:, None, None], sv, zero).sum(dim=-1)
            vlo, vhi = fusion.packed_psum([plo, phi], comm)
            new = torch.where((counts > 0)[:, None], 0.5 * (vlo + vhi), cent)
            return new, torch.sum((new - cent) ** 2), labels

        return _fit_program("kmedians.step", step, n, k, comm)

    def _local_step(self, x: torch.Tensor, centroids: torch.Tensor):
        """The step on data every rank holds (heat_tpu ``kmedians.py:166``)."""
        labels = torch.argmin(manhattan_to(x, centroids), dim=1)
        new = _median_update(x, labels, centroids)
        return new, torch.sum((new - centroids) ** 2), labels
