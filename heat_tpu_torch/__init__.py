"""heat_tpu_torch — heat_tpu's distributed array framework on PyTorch and CUDA.

A port of ``heat_tpu`` (the JAX/TPU package, which stays the reference) to
PyTorch on NVIDIA Hopper: a NumPy-like ``DNDarray`` split along one axis
across processes (one per card, ``torch.distributed``) with its operators,
moments, cumulative operations, resplits, indexing and manipulations,
sorting, the set operations and the order statistics, factories and random
draws (heat_tpu's Threefry stream, bit for bit), the linear algebra layer
(``@``, ``ht.linalg``), file I/O (HDF5, NetCDF, CSV, ``.npy``) with
out-of-core streams, the data engine (groupby, top-k, join, exact
quantiles, in memory and streamed), KMeans (also out of core), KMedians,
KMedoids, Spectral clustering, Lasso, Gaussian naive Bayes, the
k-neighbours classifier, the graph Laplacian, the distance matrices, halos
and tilings, datasets and loaders,
and the flagship transformer LM's training (on any dp x pp x tp x sp grid,
with experts, pipeline stages and the sequence rings) and serving paths
(``nn``, ``optim``, ``serve``: the batching executor with per-tenant
admission and the continuous-batching decode engine), checkpoints with
crash recovery and fault injection (``utils``), with hand-written CUDA
kernels on the hot paths. Arrays and models live on the
card unless the caller asks for the CPU (``device="cpu"`` or
``use_device("cpu")``).

Usage matches heat_tpu: ``import heat_tpu_torch as ht``.
"""

from .core import *  # noqa: F401,F403
from . import core
from .core import communication, devices, factories, kernels, linalg, random, types
from . import classification
from . import cluster
from . import data
from . import datasets
from . import graph
from . import naive_bayes
from . import nn
from . import optim
from . import regression
from . import serve
from . import spatial
from . import utils

__version__ = core.__version__


def runtime_stats() -> dict:
    """The process's one observability snapshot (heat_tpu ``__init__.py:61``):
    serving figures, the resharding plan figures, the op and data engines'
    counters, the fault plan and every process-wide counter. See
    :func:`heat_tpu_torch.serve.metrics.runtime_stats`."""
    from .serve.metrics import runtime_stats as _rs

    return _rs()
