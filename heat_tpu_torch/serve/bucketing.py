"""Shape-bucket policies (heat_tpu ``serve/bucketing.py``): a batch's row
count maps onto a small closed set of padded shapes.

A bucket policy quantizes rows onto a finite ladder (powers of two by
default), so after one warmup over the ladder, traffic of any row mix runs
the same few programs of the executor's
:class:`~heat_tpu_torch.serve.program_cache.ProgramCache` and builds
nothing more.

A policy is any callable ``rows -> bucket_rows`` with ``bucket_rows >=
rows``. It may carry the attributes the executor reads: ``min_rows`` (the
floor every bucket is a multiple of: the data-parallel world of a sharded
model), ``multiple_of`` and ``ladder(upto)`` (the warmup set).
:class:`Pow2Buckets` and :class:`FixedBuckets` carry them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["next_pow2", "Pow2Buckets", "FixedBuckets", "bucket_nbytes"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (int(n) - 1).bit_length()


class Pow2Buckets:
    """The default policy: round rows up to a power of two.

    The bucket set is ``{ceil(2^k / multiple_of) * multiple_of : 2^k >=
    min_rows}`` and the policy maps ``rows`` to the smallest member >=
    ``rows`` — which makes it **idempotent** (``policy(policy(n)) ==
    policy(n)``), the property warmup relies on: a warmup request sized to
    a bucket must land back in that same bucket, or warmup compiles the
    wrong programs and traffic recompiles.

    Parameters
    ----------
    min_rows : int
        Floor of the ladder. Sharded programs need the batch axis divisible
        by the mesh axis size, so adapters set ``min_rows`` to the mesh
        size (e.g. ``dp`` for the transformer).
    multiple_of : int
        Every bucket is a multiple of this (covers non-power-of-two mesh
        sizes; 1 = no constraint).
    max_rows : int, optional
        Hard ceiling: the largest bucket is the biggest multiple of
        ``multiple_of`` that is <= ``max_rows``; rows beyond it raise.
    """

    def __init__(self, min_rows: int = 1, multiple_of: int = 1,
                 max_rows: Optional[int] = None):
        if min_rows < 1 or multiple_of < 1:
            raise ValueError("min_rows and multiple_of must be >= 1")
        self.min_rows = int(min_rows)
        self.multiple_of = int(multiple_of)
        self.max_rows = None if max_rows is None else int(max_rows)

    def _round(self, p2: int) -> int:
        return -(-p2 // self.multiple_of) * self.multiple_of

    def __call__(self, rows: int) -> int:
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        p2 = next_pow2(self.min_rows)
        while self._round(p2) < rows:
            p2 <<= 1
        b = self._round(p2)
        if self.max_rows is not None and b > self.max_rows:
            # clamp to the largest DIVISIBLE bucket under the ceiling —
            # returning a raw max_rows could hand a sharded program a
            # batch axis that does not divide the mesh
            cap = (self.max_rows // self.multiple_of) * self.multiple_of
            if rows <= cap:
                return cap
            raise ValueError(
                f"request of {rows} rows exceeds the bucket ceiling "
                f"({cap}, from max_rows={self.max_rows})")
        return b

    def ladder(self, upto: int) -> Tuple[int, ...]:
        """The distinct buckets this policy produces for 1..upto rows —
        the warmup set (bounded by the ceiling when one is set)."""
        if self.max_rows is not None:
            upto = min(upto,
                       (self.max_rows // self.multiple_of)
                       * self.multiple_of)
        out = []
        r = 1
        while r <= upto:
            b = self(r)
            if not out or b != out[-1]:
                out.append(b)
            r = b + 1
        return tuple(out)

    def __repr__(self) -> str:
        return (f"Pow2Buckets(min_rows={self.min_rows}, "
                f"multiple_of={self.multiple_of}, max_rows={self.max_rows})")


class FixedBuckets:
    """An explicit ascending ladder of bucket sizes."""

    def __init__(self, sizes: Sequence[int]):
        sizes = tuple(sorted(int(s) for s in sizes))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"need at least one positive size, got {sizes}")
        self.sizes = sizes

    def __call__(self, rows: int) -> int:
        for s in self.sizes:
            if s >= rows:
                return s
        raise ValueError(
            f"request of {rows} rows exceeds the largest bucket "
            f"({self.sizes[-1]})")

    def ladder(self, upto: int) -> Tuple[int, ...]:
        return tuple(s for s in self.sizes
                     if s <= self(min(upto, self.sizes[-1])))

    def __repr__(self) -> str:
        return f"FixedBuckets({list(self.sizes)})"


def bucket_nbytes(bucket_rows: int, feat_shape: Tuple[int, ...],
                  dtype) -> int:
    """Input-payload bytes of one padded batch — what the executor checks
    against ``ServeConfig.max_bucket_bytes`` (the memory cap that triggers
    the degraded single-request fallback)."""
    return int(bucket_rows) * int(np.prod(feat_shape, dtype=np.int64) or 1) \
        * np.dtype(dtype).itemsize
