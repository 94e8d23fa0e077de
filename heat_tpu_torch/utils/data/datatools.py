"""Dataset and DataLoader (heat_tpu ``utils/data/datatools.py``).

A dataset holds DNDarrays that share their first axis; the loader batches
along it and shuffles every epoch. The shuffle's permutation is
``ht.random.randperm``, heat_tpu's Threefry draw, so a seed gives heat_tpu's
order: a split array's rows move through the ring gather of the
DNDarray's getitem, a replicated one's on each rank.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle"]


class Dataset:
    """A dataset over one or more DNDarrays sharing the sample axis
    (heat_tpu ``datatools.py:27``)."""

    def __init__(self, array, transforms=None, ishuffle: bool = False, test_set: bool = False):
        arrays = array if isinstance(array, (list, tuple)) else [array]
        for a in arrays:
            if not isinstance(a, DNDarray):
                raise TypeError(f"Dataset requires DNDarrays, got {type(a)}")
        n = arrays[0].shape[0]
        for a in arrays[1:]:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the sample axis length")
        self.arrays = list(arrays)
        self.transforms = (
            transforms if isinstance(transforms, (list, tuple)) else
            ([transforms] * len(self.arrays) if transforms else [None] * len(self.arrays))
        )
        self.ishuffle = ishuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, index):
        items = []
        for a, t in zip(self.arrays, self.transforms):
            item = a[index]
            if t is not None:
                item = t(item)
            items.append(item)
        return items[0] if len(items) == 1 else tuple(items)

    def shuffle(self):
        """Shuffle the sample axis of every array in place (heat_tpu
        ``dataset_shuffle``)."""
        dataset_shuffle(self)


class DataLoader:
    """Batches along the sample axis with a shuffle before every epoch
    (heat_tpu ``datatools.py:65``). A batch is a slice of the dataset's
    arrays (a tuple of them for several), distributed as they are: heat_tpu
    yields the slices of its sharded arrays, the port the DNDarrays of the
    slices (a split array's slice is the DNDarray's window fetch)."""

    def __init__(self, dataset=None, data=None, batch_size: int = 1, drop_last: bool = True,
                 shuffle: bool = True, ishuffle: bool = False, transforms=None):
        if dataset is None:
            if data is None:
                raise TypeError("either dataset or data must be given")
            dataset = Dataset(data, transforms=transforms, ishuffle=ishuffle)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.ishuffle = ishuffle
        self._last_epoch = False

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if self.shuffle:
            self.dataset.shuffle()
        n = len(self.dataset)
        bs = self.batch_size
        for i in range(len(self)):
            lo = i * bs
            hi = min(lo + bs, n)
            batch = [a[lo:hi] for a in self.dataset.arrays]
            yield batch[0] if len(batch) == 1 else tuple(batch)


def dataset_shuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Shuffle the sample axis of every array of ``dataset`` by one
    permutation (heat_tpu ``datatools.py:113``): ``randperm``, then the
    getitem's ring gather for a split array at world size > 1, else the
    logical rows on each rank."""
    n = len(dataset)
    perm = ht_random.randperm(n, comm=dataset.arrays[0].comm,
                              device=dataset.arrays[0].device).larray
    for i, a in enumerate(dataset.arrays):
        if a.split is not None and a.comm.size > 1 and n > 0:
            dataset.arrays[i] = a[perm.cpu().numpy()]
        else:
            shuffled = a._logical()[perm.to(a.larray.device)]
            dataset.arrays[i] = DNDarray.from_global(shuffled, a.split, a.device, a.comm, a.dtype)


def dataset_ishuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """heat_tpu's non-blocking shuffle (``datatools.py:130``): the card
    runs a shuffle asynchronously already, so this is the same operation."""
    dataset_shuffle(dataset, attrs)
