"""Data tools (heat_tpu ``utils/data``): datasets and loaders over
DNDarrays, MNIST, an out-of-core HDF5 loader, a test-matrix gallery and
the TFRecord helpers."""

from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .partial_dataset import PartialH5Dataset, PartialH5DataLoaderIter
from .mnist import MNISTDataset
from . import matrixgallery
from .matrixgallery import parter

__all__ = ["DataLoader", "Dataset", "dataset_ishuffle", "dataset_shuffle", "PartialH5Dataset",
           "PartialH5DataLoaderIter", "MNISTDataset", "matrixgallery", "parter"]
