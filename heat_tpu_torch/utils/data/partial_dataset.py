"""An out-of-core HDF5 dataset with a background producer (heat_tpu
``utils/data/partial_dataset.py``): a thread reads the next slab of rows
from the file while the current slab's batches are consumed. It needs
``h5py`` and raises ``ImportError`` where it is missing, as heat_tpu does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from ...core import devices
from ...core.communication import sanitize_comm

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter"]


class PartialH5Dataset:
    """A chunked HDF5 dataset (heat_tpu ``partial_dataset.py:25``): the
    first slab holds ``initial_load`` rows, each later one ``load_length``.
    Batches land on the default device (the card unless the CPU is asked
    for)."""

    def __init__(self, file: str, comm=None, dataset_names: Optional[List[str]] = None,
                 initial_load: int = 7000, load_length: int = 1000, use_gpu: bool = True,
                 np_buffer: bool = True):
        import h5py

        self.file = file
        self.comm = sanitize_comm(comm)
        self.dataset_names = dataset_names or ["data"]
        self.initial_load = initial_load
        self.load_length = load_length
        self.device = devices.sanitize_device(None)
        with h5py.File(file, "r") as handle:
            self.total_size = handle[self.dataset_names[0]].shape[0]

    def __len__(self) -> int:
        return self.total_size

    def thread_replace_converted_batches(self):
        """heat_tpu's hook (``partial_dataset.py:51``): the slabs rotate
        inside the loader's iterator."""
        return None


class PartialH5DataLoaderIter:
    """Batches of a :class:`PartialH5Dataset`, its slabs read by one
    producer thread (heat_tpu ``partial_dataset.py:57``); each slab's rows
    shuffled by ``numpy``'s generator of ``seed``."""

    def __init__(self, dataset: PartialH5Dataset, batch_size: int = 64, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        import h5py

        ds = self.dataset
        with h5py.File(ds.file, "r") as handle:
            handles = [handle[name] for name in ds.dataset_names]
            pos = 0
            while pos < ds.total_size and not self._stop.is_set():
                length = ds.initial_load if pos == 0 else ds.load_length
                hi = min(pos + length, ds.total_size)
                self._queue.put([np.asarray(h[pos:hi]) for h in handles])
                pos = hi
        self._queue.put(None)

    def __iter__(self) -> Iterator:
        dev = self.dataset.device.torch_device
        while True:
            slab = self._queue.get()
            if slab is None:
                break
            n = slab[0].shape[0]
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            for lo in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[lo:lo + self.batch_size]
                batch = [torch.as_tensor(s[idx], device=dev) for s in slab]
                yield batch[0] if len(batch) == 1 else tuple(batch)

    def close(self):
        self._stop.set()
