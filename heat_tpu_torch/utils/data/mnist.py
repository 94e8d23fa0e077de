"""MNIST (heat_tpu ``utils/data/mnist.py``): the IDX files, raw or gzipped,
parsed directly (no torchvision), as a split :class:`.Dataset`."""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ...core import factories, types
from .datatools import Dataset

__all__ = ["MNISTDataset"]


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTDataset(Dataset):
    """MNIST over split DNDarrays (heat_tpu ``mnist.py:31``): images as
    float32 in [0, 1], labels int32."""

    FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str, train: bool = True, transform=None, target_transform=None,
                 split: Optional[int] = 0, ishuffle: bool = False, test_set: bool = False):
        img_name, lbl_name = self.FILES[train]
        images = _read_idx(self._find(root, img_name)).astype(np.float32) / 255.0
        labels = _read_idx(self._find(root, lbl_name)).astype(np.int32)
        img = factories.array(images, dtype=types.float32, split=split)
        lbl = factories.array(labels, dtype=types.int32, split=split)
        super().__init__([img, lbl], transforms=[transform, target_transform],
                         ishuffle=ishuffle, test_set=test_set)

    @staticmethod
    def _find(root: str, base: str) -> str:
        for cand in (base, base + ".gz", os.path.join("MNIST", "raw", base),
                     os.path.join("MNIST", "raw", base + ".gz")):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"MNIST file {base} not found under {root}")
