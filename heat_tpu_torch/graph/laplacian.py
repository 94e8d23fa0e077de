"""Graph Laplacian construction (heat_tpu ``graph/laplacian.py``).

Every step is row-local on the shards: thresholding, the diagonal writes and
the ``D^-1/2`` scaling use each row's global position. The one cross-rank
step is the degree vector, a row sum made replicated (``_degree_replicated``).
The ``n × n`` similarity matrix is never gathered.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import arithmetics, types
from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


def _row_positions(A: DNDarray) -> torch.Tensor:
    """Global row index of each of this rank's rows."""
    offset = A.comm.chunk(A.shape, 0)[0] if A.split == 0 else 0
    return offset + torch.arange(A.larray.shape[0], device=A.larray.device)


def _set_diag_(t: torch.Tensor, gpos: torch.Tensor, value) -> torch.Tensor:
    """Write ``value`` in place at the global diagonal of a row block."""
    keep = gpos < t.shape[1]
    rows = torch.arange(t.shape[0], device=t.device)[keep]
    t[rows, gpos[keep]] = value
    return t


class Laplacian:
    """Adjacency from similarity, then the Laplacian (heat_tpu
    ``laplacian.py:41``): ``definition`` is ``"simple"`` (``D - A``) or
    ``"norm_sym"`` (``I - D^-1/2 A D^-1/2``); ``mode`` is
    ``"fully_connected"`` or ``"eNeighbour"`` (keep similarities below
    (``"upper"``) or above (``"lower"``) ``threshold_value``)."""

    def __init__(self, similarity: Callable, definition: str = "norm_sym",
                 mode: str = "fully_connected", threshold_key: str = "upper",
                 threshold_value: float = 1.0, neighbours: int = 10):
        self.similarity_metric = similarity
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(
                "Only simple and normalized symmetric graph laplacians are supported")
        self.definition = definition
        if mode not in ("fully_connected", "eNeighbour"):
            raise NotImplementedError("Only fully_connected and eNeighbour modes are supported")
        self.mode = mode
        if threshold_key not in ("upper", "lower"):
            raise ValueError(f"threshold_key must be 'upper' or 'lower', got {threshold_key}")
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    @staticmethod
    def _degree_replicated(A: DNDarray) -> torch.Tensor:
        """The degree vector on every rank (heat_tpu ``laplacian.py:77``)."""
        return arithmetics.sum(A, axis=1).resplit(None)._logical()

    def _normalized_symmetric_L(self, A: DNDarray) -> DNDarray:
        """``I - D^-1/2 A D^-1/2`` (heat_tpu ``laplacian.py:83``)."""
        d = self._degree_replicated(A)
        inv_sqrt = torch.where(d > 0, 1.0 / torch.sqrt(d), 0.0)
        gpos = _row_positions(A)
        L = torch.neg(A.larray).mul_(inv_sqrt[gpos][:, None]).mul_(inv_sqrt[None, :])
        _set_diag_(L, gpos, 1.0)
        return DNDarray(L, A.gshape, types.canonical_heat_type(L.dtype), A.split, A.device,
                        A.comm)

    def _simple_L(self, A: DNDarray) -> DNDarray:
        """``D - A`` (heat_tpu ``laplacian.py:95``)."""
        d = self._degree_replicated(A)
        gpos = _row_positions(A)
        L = torch.neg(A.larray)
        keep = gpos < A.shape[1]
        rows = torch.arange(L.shape[0], device=L.device)[keep]
        L[rows, gpos[keep]] = d[gpos[keep]] - A.larray[rows, gpos[keep]]
        return DNDarray(L, A.gshape, types.canonical_heat_type(L.dtype), A.split, A.device,
                        A.comm)

    def construct(self, X: DNDarray) -> DNDarray:
        """Build L from data (heat_tpu ``laplacian.py:108``)."""
        S = self.similarity_metric(X)
        if S.split not in (None, 0):
            S = S.resplit(0)
        phys = S.larray
        if self.mode == "eNeighbour":
            key, value = self.epsilon
            phys = torch.where(phys < value if key == "upper" else phys > value, phys, 0.0)
        else:
            phys = phys.clone()
        S = DNDarray(_set_diag_(phys, _row_positions(S), 0.0), S.gshape, S.dtype, S.split,
                     S.device, S.comm)
        if self.definition == "simple":
            return self._simple_L(S)
        return self._normalized_symmetric_L(S)
